"""The train step's modules in the PyTorch port against the JAX package, at
float32 and small widths: the CLIP vision tower, the masked foresight
decoder (forward and loss, with the mask draw fed from numpy), the MAP
contrastive head, the log-logistic sigma density, the tri-stage LR schedule
and the EMA decay. JAX parameters are perturbed (tests/test_torch_modules.py
`jinit`) and carried into the port by `utils/from_jax.py`.

Tolerance: rtol 1e-4, atol 5e-5, the port-parity bound: both sides compute
in float32 and differ in summation order and transcendental rounding. The
schedules are scalar float32 formulas, held at rtol 1e-6.
"""

import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdt_policy_tpu.diffusion import densities as jdensities
from mdt_policy_tpu.models import blocks as jb
from mdt_policy_tpu.models.clip import CLIPVisionTower as JCLIPVision
from mdt_policy_tpu.models.masked_decoder import MaskedTransformerImgDecoder as JDecoder
from mdt_policy_tpu.utils import ema as jema
from mdt_policy_tpu.utils import schedulers as jsched
from mdt_policy_tpu_torch.diffusion import densities
from mdt_policy_tpu_torch.models.blocks import ClipStyleProjection
from mdt_policy_tpu_torch.models.clip import CLIPVisionTower
from mdt_policy_tpu_torch.models.masked_decoder import MaskedTransformerImgDecoder
from mdt_policy_tpu_torch.utils import ema, from_jax, schedulers

TOL = dict(rtol=1e-4, atol=5e-5)


def _x(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def jinit(module, *args, seed=0):
    """flax init, then every parameter perturbed by N(0, 0.1)."""
    params = jax.device_get(jax.jit(module.init)(jax.random.PRNGKey(seed), *args)["params"])
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(
        lambda p: (np.asarray(p) + rng.normal(size=np.shape(p)) * 0.1).astype(np.float32),
        params)


def jrun(module, params, *args, **kw):
    return np.asarray(module.apply({"params": params}, *args, **kw))


def test_clip_vision_tower():
    jm = JCLIPVision(embed_dim=16, image_resolution=32, layers=2, width=128,
                     patch_size=16)  # 2 heads of 64
    x = _x(3, 32, 32, 3)
    p = jinit(jm, x)
    pm = CLIPVisionTower(16, 32, 2, 128, 16)
    pm.load_state_dict(from_jax.clip_vision_from_jax(p), strict=True)
    with torch.no_grad():
        out = pm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, jrun(jm, p, x), **TOL)


def _decoder_pair(dtype=None):
    kw = dict(resolution=64, patch_size=16, decoder_depth=2, decoder_embed_dim=16,
              decoder_n_heads=2, context_dim=24)
    jm = JDecoder(**kw, dtype=dtype)
    ctx, imgs = _x(2, 4, 24), _x(2, 2, 64, 64, 3, seed=1)
    init = jax.jit(jm.init)
    params = jax.device_get(init({"params": jax.random.PRNGKey(0),
                                  "mask": jax.random.PRNGKey(1)}, ctx, imgs)["params"])
    rng = np.random.default_rng(100)
    params = jax.tree.map(lambda a: (np.asarray(a) + rng.normal(size=np.shape(a))
                                     * 0.1).astype(np.float32), params)
    pm = MaskedTransformerImgDecoder(64, 16, 2, 16, 2, context_dim=24)
    pm.load_state_dict(from_jax.masked_decoder_from_jax(params), strict=True)
    return jm, params, pm.eval(), ctx, imgs


def test_masked_decoder_forward_and_loss():
    """16 patches, 4 kept: the same uniform draw gives the same mask and
    permutation, reconstructions, visible patches and loss."""
    jm, p, pm, ctx, imgs = _decoder_pair()
    noise = np.random.default_rng(7).uniform(size=(2, 16)).astype(np.float32)
    with mock.patch.object(jax.random, "uniform",
                           lambda key, shape, *a, **k: jnp.asarray(noise)):
        jout = jm.apply({"params": p}, ctx, imgs, rngs={"mask": jax.random.PRNGKey(2)})
    jloss = jm.apply({"params": p}, imgs, jout[0], jout[1], method="compute_loss")
    with torch.no_grad():
        pout = pm(torch.from_numpy(ctx), torch.from_numpy(imgs), torch.from_numpy(noise))
        ploss = pm.compute_loss(torch.from_numpy(imgs), pout[0], pout[1])
    recon, mask, restore, visible = (t.numpy() for t in pout)
    np.testing.assert_array_equal(mask, np.asarray(jout[1]))
    np.testing.assert_array_equal(restore, np.asarray(jout[2]))
    assert mask.sum() == 2 * 12
    np.testing.assert_allclose(recon, np.asarray(jout[0]), **TOL)
    np.testing.assert_allclose(visible, np.asarray(jout[3]), **TOL)
    np.testing.assert_allclose(ploss.item(), float(jloss), **TOL)
    np.testing.assert_array_equal(
        pm.patchify(torch.from_numpy(imgs)).numpy(), np.asarray(jm.patchify(imgs)))


def test_masked_decoder_rejects_a_misshaped_draw():
    _, _, pm, ctx, imgs = _decoder_pair()
    with pytest.raises(ValueError, match="mask noise"):
        pm(torch.from_numpy(ctx), torch.from_numpy(imgs), torch.zeros(2, 15))


def test_clip_style_projection():
    jm = jb.ClipStyleProjection(clip_style="map", token_dim=32,
                                clip_token_index=1, num_token=4)
    x = _x(3, 4, 32, scale=2.0)
    p = jinit(jm, x)
    pm = ClipStyleProjection(token_dim=32)
    pm.load_state_dict(from_jax.clip_proj_from_jax(p), strict=True)
    with torch.no_grad():
        out = pm.eval()(torch.from_numpy(x)).numpy()
    assert out.shape == (3, 32)
    np.testing.assert_allclose(out, jrun(jm, p, x), **TOL)


def test_loglogistic_density_from_the_same_draws():
    """MDT-V's density (loc log 0.5, scale 0.5, truncated to [1e-3, 80]),
    from the same uniform draws, edges included; and the log-normal
    (tests/test_torch_samplers.py holds every density)."""
    u = np.concatenate([np.random.default_rng(5).uniform(size=64),
                        [0.0, 1e-7, 0.5, 1 - 1e-7]]).astype(np.float32)
    jfn = jdensities.make_sample_density("loglogistic", 0.5, 1e-3, 80.0)
    with mock.patch.object(jax.random, "uniform",
                           lambda key, shape, *a, **k: jnp.asarray(u)):
        ref = np.asarray(jfn(jax.random.PRNGKey(0), u.shape))
    out = densities.make_sample_density("loglogistic", 0.5, 1e-3, 80.0)(
        torch.from_numpy(u)).numpy()
    assert np.isfinite(out).all() and out.min() >= 1e-3 * (1 - 1e-5)
    np.testing.assert_allclose(out, ref, **TOL)
    # the log-normal density, once refused, from the same normal draws
    n = np.random.default_rng(6).normal(size=64).astype(np.float32)
    with mock.patch.object(jax.random, "normal",
                           lambda key, shape, *a, **k: jnp.asarray(n)):
        ref = np.asarray(jdensities.make_sample_density("lognormal", 0.5, 1e-3, 80.0)(
            jax.random.PRNGKey(0), n.shape))
    out = densities.make_sample_density("lognormal", 0.5, 1e-3, 80.0)(torch.from_numpy(n))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_tri_stage_schedule():
    """warmup 1000, hold 4000, decay 45000 at the production config."""
    kw = dict(peak_lr=1e-4, init_lr_scale=0.1, final_lr_scale=1e-6,
              total_steps=50_000, phase_ratio=(0.02, 0.08, 0.9))
    ours, ref = schedulers.tri_stage_schedule(**kw), jsched.tri_stage_schedule(**kw)
    for step in (0, 1, 999, 1000, 4999, 5000, 27_500, 50_000, 50_001, 60_000):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6, err_msg=step)
    assert ours(0) == pytest.approx(1e-5) and ours(2000) == pytest.approx(1e-4)


def test_ema_decay():
    for step in range(4):
        np.testing.assert_allclose(ema.ema_decay(step), float(jema.ema_decay(step)),
                                   rtol=1e-6)
    assert ema.ema_decay(1) == 0.0
    assert ema.ema_decay(2) == pytest.approx(1 - 2 ** (-2 / 3), rel=1e-6)
    e = {"w": torch.tensor([1.0, 2.0])}
    ema.ema_update(e, [("w", torch.tensor([3.0, 2.0]))], 0.75)
    torch.testing.assert_close(e["w"], torch.tensor([1.5, 2.0]))
    assert math.isclose(ema.ema_decay(10 ** 9), 0.9999, rel_tol=1e-6)
