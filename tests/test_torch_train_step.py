"""One MDT-V train step and one validation step of the PyTorch port against
the JAX package, at a tiny config: the JAX agent from `init_agent`, its
parameters carried into the port by `from_jax`, the same dual-scope batch
and the same random draws on both sides.

The JAX step draws inside its modules (the sigma density's uniform draw,
densities.py:57; the action noise, mdtv_agent.py:316; the foresight mask,
masked_decoder.py:100; the validation's initial noise, mdtv_agent.py:536).
Here those `jax.random` calls are patched to return numpy arrays, picked by
shape in the order the sorted scopes draw them, and the port gets the same
arrays as its `draws`. Dropout masks cannot be shared that way, so the
parity config has attn_pdrop = resid_pdrop = mlp_pdrop = 0; a separate test
shows the port's dropout on in train mode, off in eval mode.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdt_policy_tpu.agents import MDTVConfig as JaxConfig
from mdt_policy_tpu.agents import init_agent
from mdt_policy_tpu.agents import mdtv_agent as jagent
from mdt_policy_tpu_torch.agents import (MDTVAgentNet, MDTVConfig, init_random_,
                                         init_train_state, make_draws, train_step,
                                         validation_step)
from mdt_policy_tpu_torch.utils.from_jax import from_jax

TINY = dict(
    latent_dim=32, embed_dim=32, obs_dim=32, goal_dim=16, clip_embed_dim=16,
    n_enc_layers=1, n_dec_layers=1, n_heads=2,
    perceiver_dim=32, perceiver_depth=1, perceiver_heads=2, perceiver_dim_head=8,
    num_latents=3, img_size=32, vit_patch=16, vit_depth=1, vit_heads=2,
    clip_vision_width=64, clip_vision_layers=1, clip_vision_patch=16,
    clip_text_width=16, clip_text_layers=1, clip_text_heads=2,
    clip_context_length=8, clip_vocab_size=100,
    gen_img_res=32, gen_patch_size=16, gen_decoder_depth=1, gen_decoder_dim=16,
    gen_decoder_heads=2, num_sampling_steps=10,
    attn_pdrop=0.0, resid_pdrop=0.0, mlp_pdrop=0.0)
DTYPES = {"f32": dict(compute_dtype="float32", gen_compute_dtype="float32"),
          "bf16": dict(compute_dtype="bfloat16", gen_compute_dtype="bfloat16")}
B = 4
N_PATCHES = 4


def _batch(seed=0):
    rng = np.random.default_rng(seed)

    def scope():
        tokens = rng.integers(1, 98, size=(B, 8)).astype(np.int32)
        tokens[:, 5], tokens[:, 6:] = 99, 0  # EOT: the largest id
        return {
            "rgb_static": rng.normal(size=(B, 2, 32, 32, 3)).astype(np.float32),
            "rgb_gripper": rng.normal(size=(B, 2, 84, 84, 3)).astype(np.float32),
            "gen_static": rng.normal(size=(B, 32, 32, 3)).astype(np.float32),
            "gen_gripper": rng.normal(size=(B, 32, 32, 3)).astype(np.float32),
            "actions": rng.normal(size=(B, 10, 7)).astype(np.float32),
            "lang_tokens": tokens,
        }
    return {"vis": scope(), "lang": scope()}


def _draws(seed=1):
    """numpy draws per scope: sigma uniform (B,), noise (B, 10, 7), mask
    uniform (B, n_patches)."""
    rng = np.random.default_rng(seed)
    return {s: {"sigma": rng.uniform(size=(B,)).astype(np.float32),
                "noise": rng.normal(size=(B, 10, 7)).astype(np.float32),
                "mask": rng.uniform(size=(B, N_PATCHES)).astype(np.float32)}
            for s in ("lang", "vis")}


def _patched_jax_random(draws, which):
    """Patch jax.random.uniform / normal to hand out the numpy draws of the
    sorted scopes, each site's arrays in scope order, picked by shape."""
    queues = {}
    for scope in sorted(draws):
        for name in which:
            a = draws[scope][name]
            kind = "normal" if name == "noise" else "uniform"
            queues.setdefault((kind, a.shape), []).append(a)

    def fake(kind):
        def draw(key, shape=(), dtype=jnp.float32, *args, **kw):
            return jnp.asarray(queues[(kind, tuple(shape))].pop(0), dtype)
        return draw
    patches = (mock.patch.object(jax.random, "uniform", fake("uniform")),
               mock.patch.object(jax.random, "normal", fake("normal")))
    return patches, queues


def _port_draws(draws):
    return {s: {k: torch.from_numpy(v) for k, v in d.items()} for s, d in draws.items()}


@functools.cache
def _agents(dtypes):
    batch = _batch()
    net, state0 = init_agent(JaxConfig(**TINY, **DTYPES[dtypes]),
                             jax.random.PRNGKey(0), batch["lang"])
    port = MDTVAgentNet(MDTVConfig(**TINY, **DTYPES[dtypes]), device="cpu")
    port.load_state_dict(from_jax(jax.device_get(state0.params)), strict=True)
    return net, state0, port


@functools.cache
def _steps(dtypes):
    """(JAX, port) after one train step from the same state, batch and
    draws: metrics, parameters, EMA, gradients."""
    net, state0, port = _agents(dtypes)
    batch, draws = _batch(), _draws()
    patches, queues = _patched_jax_random(draws, ("sigma", "noise", "mask"))
    with patches[0], patches[1]:
        state1, jm = jax.jit(functools.partial(jagent.train_step, net))(
            state0, batch, jax.random.PRNGKey(3))
    assert not any(queues.values())  # every draw was taken
    jm = {k: float(v) for k, v in jax.device_get(jm).items()}
    # optax's first Adam moment is (1 - b1) * grad after one step
    b1 = net.cfg.optimizer.betas[0]
    mu = next(s.mu for s in state1.opt_state if hasattr(s, "mu"))
    jgrads = from_jax(jax.device_get(jax.tree.map(lambda m: m / (1 - b1), mu)))
    jparams = from_jax(jax.device_get(state1.params))
    jema = from_jax(jax.device_get(state1.ema_params))

    state = init_train_state(port)
    pm = train_step(state, batch, draws=_port_draws(draws))
    pm = {k: float(v) for k, v in pm.items()}
    pgrads = {n: p.grad.clone() for n, p in port.trainable_parameters()}
    pparams = {k: v.float().clone() for k, v in port.state_dict().items()}
    pema = {k: v.clone() for k, v in state.ema.items()}
    return (jm, jgrads, jparams, jema), (pm, pgrads, pparams, pema)


LOSSES = [f"{s}/{k}" for s in ("lang", "vis")
          for k in ("action_loss", "img_gen_loss", "cont_loss", "total_loss")] \
    + ["train/total_loss"]


def test_train_step_losses_match_jax():
    (jm, *_), (pm, *_) = _steps("f32")
    assert pm["vis/cont_loss"] == 0.0 and pm["lang/cont_loss"] > 0.0
    for k in LOSSES:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=k)


def test_train_step_gradients_match_jax():
    """f32 gradients of every trainable leaf: rtol 1e-3, atol 1e-6 (the
    loss is a sum over tiny towers and two scopes; gradients of order
    1e-6 and below are rounding)."""
    (_, jgrads, _, _), (_, pgrads, _, _) = _steps("f32")
    assert sorted(jgrads) == sorted(pgrads)
    assert not any(k.startswith(("visual_goal", "language_goal", "img_encoder"))
                   for k in pgrads)
    for k in jgrads:
        np.testing.assert_allclose(pgrads[k].numpy(), jgrads[k].numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=k)


def _assert_same_update(k, port_new, jax_new, before, grad, lr0, floor=1e-6):
    """The AdamW update (new - before) of the port against JAX's. Where the
    JAX gradient is above rounding (|g| > floor, 1e-6 by default, so the
    gradient test leaves no room for a sign flip) the updates agree within
    1e-3 relative plus two ulps of the stored f32 parameter, the rounding
    of `before - update`; the first Adam step is lr0 * g / (|g| + eps) and
    the weight decay adds lr0 * 0.05 * p, about 4 ulps of p, so a missing
    decay, a scaled step or a skipped leaf fails. Where |g| <= floor the
    sign of g is rounding and the update may flip: there the parameters
    agree within 2 * lr0."""
    p0, pn, jn, g = (np.asarray(t, np.float32) for t in (before, port_new, jax_new, grad))
    big = np.abs(g) > floor
    d_port, d_jax = (pn - p0)[big], (jn - p0)[big]
    ulp = np.spacing(np.abs(jn[big]))
    excess = np.abs(d_port - d_jax) - (1e-3 * np.abs(d_jax) + 2 * ulp)
    assert excess.size == 0 or excess.max() <= 0, \
        (k, float(np.abs(d_port - d_jax).max()), float(np.abs(d_jax).max()))
    np.testing.assert_allclose(pn[~big], jn[~big], rtol=0, atol=2 * lr0, err_msg=k)
    return int(big.sum())


def test_train_step_params_ema_and_metrics_match_jax():
    """After AdamW every trainable leaf took JAX's update (see
    `_assert_same_update`), and so did its EMA (decay 0 at step 1, so the
    EMA is the new parameters up to one rounding). The frozen towers do not
    move."""
    (jm, jgrads, jparams, jema), (pm, _, pparams, pema) = _steps("f32")
    _, state0, _ = _agents("f32")
    before = from_jax(jax.device_get(state0.params))
    assert sorted(jparams) == sorted(pparams)
    lr0 = 1e-5
    checked = 0
    for k in jparams:
        if k.startswith(("visual_goal", "language_goal", "img_encoder")):
            assert k not in jgrads
            torch.testing.assert_close(pparams[k], before[k], rtol=0, atol=0)
            np.testing.assert_array_equal(jparams[k].numpy(), before[k].numpy())
            continue
        checked += _assert_same_update(k, pparams[k], jparams[k], before[k],
                                       jgrads[k], lr0)
        _assert_same_update(k, pema[k], jema[k], before[k], jgrads[k], lr0)
        # e - 1 * (e - p) is p up to one rounding
        torch.testing.assert_close(pema[k], pparams[k], rtol=1e-6, atol=1e-12)
    # most elements carry a gradient above rounding
    assert checked > 0.5 * sum(v.numel() for v in jgrads.values())
    for k in ("train/grad_norm", "train/param_norm"):
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(pm["train/lr"], jm["train/lr"], rtol=1e-6)
    assert pm["train/ema_rate"] == jm["train/ema_rate"] == 0.0


def test_train_step_bf16_towers_and_decoder():
    """The production dtypes (bf16 towers, bf16 foresight decoder). The JAX
    towers round the attention scores and each RMSNorm step to bf16, B1 and
    B3 do not, so the losses and norms move by a few bf16 roundings
    (3.9e-3 relative each): bound 2e-2 relative; the measured worst case is
    written in PERF.md."""
    (jm, *_), (pm, *_) = _steps("bf16")
    _, _, port = _agents("bf16")
    assert port.visual_goal.conv1.weight.dtype == torch.bfloat16
    assert port.gen_img.decoder_blocks[0].attn.qkv.weight.dtype == torch.float32
    keys = LOSSES + ["train/grad_norm", "train/param_norm"]
    rel = {k: abs(pm[k] - jm[k]) / abs(jm[k]) for k in keys if jm[k] != 0}
    worst = max(rel, key=rel.get)
    # shown with `pytest -s`; PERF.md quotes it
    print(f"bf16 train step: max relative |port - jax| = {rel[worst]:.3g} ({worst})")
    for k in keys:
        assert np.isfinite(pm[k]), k
        np.testing.assert_allclose(pm[k], jm[k], rtol=2e-2, err_msg=k)


def test_validation_step_matches_jax():
    """DDIM-10 from the hoisted context, the action MSE and the foresight
    loss per scope. The action MSE carries the 10-step chunk bound of
    tests/test_torch_slice.py (1e-3); the foresight loss the module bound."""
    net, state0, port = _agents("f32")
    batch, draws = _batch(seed=4), _draws(seed=5)
    patches, queues = _patched_jax_random(draws, ("noise", "mask"))
    with patches[0], patches[1]:
        jm = jax.jit(functools.partial(jagent.validation_step, net))(
            state0.params, batch, jax.random.PRNGKey(6))
    assert not any(queues.values())
    jm = {k: float(v) for k, v in jax.device_get(jm).items()}
    pm = {k: float(v) for k, v in
          validation_step(port, batch, draws=_port_draws(draws)).items()}
    assert sorted(pm) == sorted(jm)
    for k in jm:
        rtol = 1e-3 if "act_loss" in k or k == "val_act/action_loss" else 1e-4
        np.testing.assert_allclose(pm[k], jm[k], rtol=rtol, err_msg=k)


def test_dropout_is_drawn_from_the_generator_in_train_mode_only():
    """With the production dropout rates, train mode draws its masks from
    `draws["dropout"]`: the same seed gives the same losses, another seed
    others; eval mode (train=False) uses no generator and equals the
    dropout-free network."""
    cfg = MDTVConfig(**{**TINY, "attn_pdrop": 0.3, "resid_pdrop": 0.1,
                        "mlp_pdrop": 0.05}, compute_dtype="float32")
    net = init_random_(MDTVAgentNet(cfg, device="cpu"), torch.Generator().manual_seed(0))
    quiet = MDTVAgentNet(MDTVConfig(**TINY, compute_dtype="float32"), device="cpu")
    quiet.load_state_dict(net.state_dict())
    b = {k: torch.as_tensor(v) for k, v in _batch()["lang"].items()}

    def losses(model, seed, train):
        draws = make_draws(cfg, B, torch.Generator().manual_seed(7))
        draws["dropout"] = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            out = model(b, "lang", train=train, draws=draws)
        return torch.stack([out[k] for k in ("action_loss", "cont_loss")]), draws["dropout"]

    a1, g1 = losses(net, 1, True)
    a2, _ = losses(net, 1, True)
    a3, _ = losses(net, 2, True)
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)
    assert not torch.allclose(a1, a3)
    assert not torch.equal(g1.get_state(), torch.Generator().manual_seed(1).get_state())
    e1, ge = losses(net, 1, False)
    torch.testing.assert_close(e1, losses(quiet, 3, True)[0], rtol=0, atol=0)
    assert torch.equal(ge.get_state(), torch.Generator().manual_seed(1).get_state())
    with pytest.raises(ValueError, match="dropout"):
        net(b, "lang", train=True, draws={k: v for k, v in make_draws(
            cfg, B, torch.Generator()).items() if k != "dropout"})


def test_train_step_draws_do_not_depend_on_the_sampler():
    """The sampler is an inference setting: with dropout on, the same
    seed gives bit-equal train steps (metrics, updated parameters, EMA)
    under DDIM and under euler_ancestral, a stochastic sampler. Only
    validation's draws (`steps=True`) carry its per-step noise."""
    cfg = dict(TINY, attn_pdrop=0.3, resid_pdrop=0.1, mlp_pdrop=0.05,
               compute_dtype="float32")
    init = MDTVAgentNet(MDTVConfig(**cfg), device="cpu")
    init_random_(init, torch.Generator().manual_seed(0))
    results = []
    for sampler in ("ddim", "euler_ancestral"):
        net = MDTVAgentNet(MDTVConfig(**cfg, sampler_type=sampler), device="cpu")
        net.load_state_dict(init.state_dict())
        state = init_train_state(net)
        metrics = train_step(state, _batch(), generator=torch.Generator().manual_seed(5))
        results.append((metrics, {k: p.detach().clone() for k, p in net.named_parameters()},
                        {k: t.clone() for k, t in state.ema.items()}))
        draws = make_draws(net.cfg, B, torch.Generator().manual_seed(1))
        assert "step_noise" not in draws
        assert ("step_noise" in make_draws(net.cfg, B, torch.Generator().manual_seed(1),
                                           steps=True)) == (sampler != "ddim")
    (m0, p0, e0), (m1, p1, e1) = results
    assert sorted(m0) == sorted(m1)
    for k in m0:
        torch.testing.assert_close(torch.as_tensor(m0[k]), torch.as_tensor(m1[k]),
                                   rtol=0, atol=0)
    for k in p0:
        torch.testing.assert_close(p0[k], p1[k], rtol=0, atol=0)
    assert sorted(e0) == sorted(e1)
    for k in e0:
        torch.testing.assert_close(e0[k], e1[k], rtol=0, atol=0)


def test_train_step_needs_draws_or_a_generator():
    _, _, port = _agents("f32")
    with pytest.raises(ValueError, match="generator"):
        train_step(init_train_state(port), _batch())
    with pytest.raises(ValueError, match="generator"):
        validation_step(port, _batch())


def test_net_builds_on_cuda_by_default():
    """`MDTVAgentNet(cfg)` takes the CUDA device; without one it raises
    and does not build on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MDTVAgentNet(MDTVConfig(**TINY))
