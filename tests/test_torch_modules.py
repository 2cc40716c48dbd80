"""Module-by-module parity of the PyTorch port against the JAX package, at
float32 and small widths. Each JAX module is initialized by flax, its
parameters perturbed (so unit scales and zero biases cannot hide a swapped
key), carried into the port's module by `utils/from_jax.py`, and both run on
the same numpy inputs.

Tolerance: rtol 1e-4, atol 5e-5, the port-parity bound of
tests/test_torch_port.py: both sides compute in float32 and differ only in
summation order and transcendental rounding."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdt_policy_tpu.diffusion import precond as jprecond
from mdt_policy_tpu.diffusion import samplers as jsamplers
from mdt_policy_tpu.diffusion import schedules as jschedules
from mdt_policy_tpu.models import blocks as jb
from mdt_policy_tpu.models.clip import CLIPTextTower as JCLIPText
from mdt_policy_tpu.models.clip import quick_gelu as jquick_gelu
from mdt_policy_tpu.models.mdtv_transformer import MDTVTransformer as JMDTV
from mdt_policy_tpu.models.perceiver import PerceiverResampler as JPerceiver
from mdt_policy_tpu.models.voltron_vit import VoltronViT as JVoltron
from mdt_policy_tpu.models.voltron_vit import get_2d_sincos_pos_embed as jsincos
from mdt_policy_tpu_torch.agents import MDTVAgentNet, MDTVConfig
from mdt_policy_tpu_torch.agents.mdtv_agent import resize_nhwc
from mdt_policy_tpu_torch.diffusion import precond, samplers, schedules
from mdt_policy_tpu_torch.models import blocks as pb
from mdt_policy_tpu_torch.models.clip import CLIPTextTower, quick_gelu
from mdt_policy_tpu_torch.models.mdtv_transformer import MDTVTransformer
from mdt_policy_tpu_torch.models.perceiver import PerceiverResampler
from mdt_policy_tpu_torch.models.voltron_vit import (VoltronViT,
                                                     get_2d_sincos_pos_embed)
from mdt_policy_tpu_torch.utils import from_jax

TOL = dict(rtol=1e-4, atol=5e-5)
B, T, C, H = 3, 6, 24, 2


def _rng(seed=0):
    return np.random.default_rng(seed)


def _x(*shape, seed=0, scale=1.0):
    return (_rng(seed).normal(size=shape) * scale).astype(np.float32)


def jinit(module, *args, seed=0, **kw):
    """flax init, then every parameter perturbed by N(0, 0.1)."""
    init = jax.jit(functools.partial(module.init, **kw))  # one compile, not op-by-op
    params = jax.device_get(init(jax.random.PRNGKey(seed), *args)["params"])
    rng = _rng(seed + 100)
    return jax.tree.map(
        lambda p: (np.asarray(p) + rng.normal(size=np.shape(p)) * 0.1).astype(np.float32),
        params)


def jrun(module, params, *args, **kw):
    return np.asarray(module.apply({"params": params}, *args, **kw))


def load(port_module, sd, prefix=""):
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    port_module.load_state_dict(sd, strict=True)
    return port_module.eval()


def prun(port_module, *args, **kw):
    with torch.no_grad():
        args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
        return port_module(*args, **kw).numpy()


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def test_activations():
    x = _x(4, 33, scale=3.0)
    np.testing.assert_allclose(pb.mish(torch.from_numpy(x)).numpy(),
                               np.asarray(jb.mish(x)), **TOL)
    np.testing.assert_allclose(quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jquick_gelu(x)), **TOL)


def test_norms_and_swishglu():
    x = _x(B, T, C, scale=2.0)
    p = jinit(jb.RMSNorm(), x)
    m = pb.RMSNorm(C)
    m.g.data = torch.from_numpy(p["g"])
    np.testing.assert_allclose(prun(m, x), jrun(jb.RMSNorm(), p, x), **TOL)

    p = jinit(jb.BiaslessLayerNorm(), x)
    m = pb.BiaslessLayerNorm(C)
    m.weight.data = torch.from_numpy(p["LayerNorm_0"]["scale"])
    np.testing.assert_allclose(prun(m, x), jrun(jb.BiaslessLayerNorm(), p, x), **TOL)

    import flax.linen as nn
    # O(1) inputs, and inputs of variance ~1e-6 where eps sets the result
    for eps, scale in ((1e-6, 1.0), (1e-6, 1e-3), (1e-5, 1e-3)):
        xs = x * scale
        p = jinit(nn.LayerNorm(epsilon=eps), xs)
        sd = {}
        from_jax._ln(sd, "n", p)
        np.testing.assert_allclose(
            prun(load(pb.LayerNorm(C, eps=eps), sd, "n."), xs),
            jrun(nn.LayerNorm(epsilon=eps), p, xs), **TOL)

    p = jinit(jb.SwishGLU(2 * C), x)
    sd = {}
    from_jax._dense(sd, "g.project", p["project"])
    np.testing.assert_allclose(prun(load(pb.SwishGLU(C, 2 * C), sd, "g."), x),
                               jrun(jb.SwishGLU(2 * C), p, x), **TOL)


@pytest.mark.parametrize("causal,cross", [(False, False), (True, False),
                                          (False, True)])
def test_attention(causal, cross):
    x, ctx = _x(B, T, C), _x(B, 4, C, seed=1)
    jm = jb.Attention(C, H, causal=causal)
    args = (x, ctx) if cross else (x,)
    p = jinit(jm, *args)
    sd = {}
    from_jax._attention(sd, "a", p)
    pm = load(pb.Attention(C, H, causal=causal), sd, "a.")
    np.testing.assert_allclose(prun(pm, *args), jrun(jm, p, *args), **TOL)


def test_mlp_and_block():
    x = _x(B, T, C)
    p = jinit(jb.MLP(C), x)
    sd = {}
    from_jax._dense(sd, "m.c_fc", p["c_fc"])
    from_jax._dense(sd, "m.c_proj", p["c_proj"])
    np.testing.assert_allclose(prun(load(pb.MLP(C), sd, "m."), x),
                               jrun(jb.MLP(C), p, x), **TOL)

    jm = jb.Block(C, H)  # the encoder's block: non-causal, no cross-attention
    p = jinit(jm, x)
    sd = {}
    from_jax._block(sd, "b", p)
    np.testing.assert_allclose(prun(load(pb.Block(C, H), sd, "b."), x),
                               jrun(jm, p, x), **TOL)


def test_conditioned_block_and_modulate():
    x, c, ctx = _x(B, T, C), _x(B, 1, C, seed=2), _x(B, 4, C, seed=1)
    jm = jb.ConditionedBlock(C, H, causal=True, use_cross_attention=True,
                             film_cond_dim=C)
    p = jinit(jm, x, c, ctx)
    sd = {}
    from_jax._block(sd, "b", p)
    pm = load(pb.ConditionedBlock(C, H), sd, "b.")
    np.testing.assert_allclose(prun(pm, x, c, ctx), jrun(jm, p, x, c, ctx), **TOL)
    a, s, t = _x(2, 5), _x(2, 5, seed=1), _x(2, 5, seed=2)
    np.testing.assert_allclose(
        pb.modulate(*map(torch.from_numpy, (a, s, t))).numpy(),
        np.asarray(jb.modulate(a, s, t)), **TOL)


def test_encoder_and_film_decoder():
    x, c, ctx = _x(B, T, C), _x(B, 1, C, seed=2), _x(B, 4, C, seed=1)
    je = jb.TransformerEncoder(C, H, 2)
    p = jinit(je, x)
    sd = {}
    for i in range(2):
        from_jax._block(sd, f"e.blocks.{i}", p[f"block_{i}"])
    from_jax._ln(sd, "e.ln", p["ln"]["LayerNorm_0"])
    pm = load(pb.TransformerEncoder(C, H, 2), sd, "e.")
    np.testing.assert_allclose(prun(pm, x), jrun(je, p, x), **TOL)

    jd = jb.TransformerFiLMDecoder(C, H, 2, C)
    p = jinit(jd, x, c, ctx)
    sd = {}
    for i in range(2):
        from_jax._block(sd, f"d.blocks.{i}", p[f"block_{i}"])
    from_jax._ln(sd, "d.ln", p["ln"]["LayerNorm_0"])
    pm = load(pb.TransformerFiLMDecoder(C, H, 2), sd, "d.")
    np.testing.assert_allclose(prun(pm, x, c, ctx), jrun(jd, p, x, c, ctx), **TOL)


def test_sigma_embedding():
    log_sigma = (np.log(np.asarray([[80.0], [1.0], [1e-3]], np.float32)) / 4)
    np.testing.assert_allclose(
        prun(pb.SinusoidalPosEmb(C), log_sigma),
        np.asarray(jb.SinusoidalPosEmb(C)(jnp.asarray(log_sigma))), **TOL)
    jm = jb.SigmaEmbedding(C)
    p = jinit(jm, log_sigma)
    sd = {}
    from_jax._dense(sd, "s.1", p["fc1"])
    from_jax._dense(sd, "s.3", p["fc2"])
    np.testing.assert_allclose(prun(load(pb.SigmaEmbedding(C), sd, "s."), log_sigma),
                               jrun(jm, p, log_sigma), **TOL)


def _expected_eps(name):
    """Norm eps of the JAX package, by module: flax LayerNorm's default 1e-6
    in the perceiver (perceiver.py:201-317), Voltron's final norm
    (voltron_vit.py:254) and the decoder's `ln3` (blocks.py:291); 1e-5 in
    CLIP (clip.py:115,220,253) and the biasless LayerNorms (blocks.py:79);
    1e-8 in RMSNorm (blocks.py:90): the Voltron and foresight-decoder blocks,
    `decoder_norm` and the MAP block's norms."""
    if name.startswith(("img_encoder.blocks.", "gen_img.", "clip_proj.")):
        return 1e-8
    if name.startswith(("perceiver.", "img_encoder.")) or name.endswith(".ln3"):
        return 1e-6
    return 1e-5


def test_every_norm_has_the_jax_eps():
    """At O(1) activations the eps of a norm does not show in the parity
    tests, so each norm of the agent is checked against the JAX value."""
    net = MDTVAgentNet(MDTVConfig(perceiver_depth=1, vit_depth=1,
                                  clip_text_layers=1, clip_vision_layers=1,
                                  gen_decoder_depth=1, n_enc_layers=1,
                                  n_dec_layers=1, clip_vocab_size=64),
                       device="cpu")
    norms = {name: m for name, m in net.named_modules()
             if isinstance(m, (torch.nn.LayerNorm, pb.RMSNorm))}
    # Voltron 3, perceiver 5, CLIP text 3, CLIP vision 4, encoder 3,
    # decoder 4, foresight decoder 3, MAP block 2
    assert len(norms) == 27
    for name, m in norms.items():
        assert m.eps == _expected_eps(name), name


# ---------------------------------------------------------------------------
# the four networks of the slice
# ---------------------------------------------------------------------------

MDTV_KW = dict(obs_dim=C, goal_dim=16, action_dim=7, proprio_dim=8, embed_dim=C,
               n_enc_layers=2, n_dec_layers=2, n_heads=H)


@pytest.fixture(scope="module")
def mdtv_pair():
    jm = JMDTV(**MDTV_KW, attn_pdrop=0.0, resid_pdrop=0.0, mlp_pdrop=0.0)
    states = {"state_images": _x(B, 3, C), "state_obs": _x(B, 1, 8, seed=5)}
    p = jinit(jm, states, _x(B, 10, 7), _x(B, 1, 16), np.ones(B, np.float32),
              modality="lang")
    pm = MDTVTransformer(**MDTV_KW, use_proprio=True)
    pm.load_state_dict(from_jax.mdtv_transformer_from_jax(p), strict=True)
    return jm, p, pm.eval()


@pytest.mark.parametrize("modality,proprio", [("lang", False), ("vis", False),
                                              ("lang", True)])
def test_mdtv_transformer_encode_decode(mdtv_pair, modality, proprio):
    jm, p, pm = mdtv_pair
    states = {"state_images": _x(B, 3, C, seed=3)}
    if proprio:
        states["state_obs"] = _x(B, 1, 8, seed=6)
    goals = _x(B, 1, 16, seed=4)
    sigma = np.asarray([80.0, 0.5, 1e-3], np.float32)
    actions = _x(B, 10, 7, seed=7)
    jctx = jm.apply({"params": p}, states, goals, sigma, modality=modality,
                    method="encode")
    jout = jm.apply({"params": p}, jctx, actions, sigma, method="decode")
    with torch.no_grad():
        pctx = pm.encode({k: torch.from_numpy(v) for k, v in states.items()},
                         torch.from_numpy(goals), modality=modality)
        pout = pm.decode(pctx, torch.from_numpy(actions), torch.from_numpy(sigma))
    np.testing.assert_allclose(pctx.numpy(), np.asarray(jctx), **TOL)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("factored", [True, False])
def test_perceiver(factored):
    kw = dict(dim=32, depth=2, dim_head=8, heads=4, num_latents=3,
              num_time_embeds=1)
    jm = JPerceiver(**kw, factored=factored)
    x = _x(2, 1, 20, 32, scale=2.0)
    p = jinit(jm, x)
    pm = PerceiverResampler(32, 2, 8, 4, 3, 1, dtype=torch.float32,
                            factored=factored)
    pm.load_state_dict(from_jax.perceiver_from_jax(p), strict=True)
    np.testing.assert_allclose(prun(pm.eval(), x), jrun(jm, p, x), **TOL)


def test_voltron_vit():
    jm = JVoltron(patch_size=16, embed_dim=32, depth=2, n_heads=2, img_size=32)
    x = _x(2, 32, 32, 3)
    p = jinit(jm, x)
    pm = VoltronViT(16, 32, 2, 2, img_size=32)
    pm.load_state_dict(from_jax.voltron_vit_from_jax(p), strict=True)
    np.testing.assert_allclose(prun(pm.eval(), x), jrun(jm, p, x), **TOL)
    np.testing.assert_array_equal(get_2d_sincos_pos_embed(32, 14),
                                  jsincos(32, 14))


def test_clip_text_tower():
    jm = JCLIPText(embed_dim=16, context_length=8, vocab_size=50, width=16,
                   heads=2, layers=2)
    tokens = _rng(3).integers(1, 49, size=(3, 8)).astype(np.int32)
    tokens[:, 5] = 49  # EOT: the largest id
    tokens[:, 6:] = 0
    p = jinit(jm, tokens)
    pm = CLIPTextTower(16, 8, 50, 16, 2, 2)
    pm.load_state_dict(from_jax.clip_text_from_jax(p), strict=True)
    with torch.no_grad():
        out = pm.eval()(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(out, jrun(jm, p, tokens), **TOL)


# ---------------------------------------------------------------------------
# resize, schedules, preconditioner, DDIM
# ---------------------------------------------------------------------------

def test_resize_84_to_224_matches_jax():
    """Gripper frames: 84 px -> 224 px. Measured max |diff| 4.8e-7 over the
    whole frame, edge rows included (upsampling: the antialias kernel is not
    widened, and both renormalize the taps at the border)."""
    x = _x(2, 84, 84, 3)
    ref = np.asarray(jax.image.resize(x, (2, 224, 224, 3), method="linear",
                                      antialias=True))
    out = resize_nhwc(torch.from_numpy(x), 224).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-6)
    assert resize_nhwc(torch.from_numpy(x), 84).shape == (2, 84, 84, 3)


@pytest.mark.parametrize("name", ["karras", "exponential", "linear",
                                  "cosine_beta", "ve", "iddpm", "vp"])
def test_schedules_equal(name):
    np.testing.assert_array_equal(
        schedules.get_noise_schedule(10, name, 0.001, 80.0),
        jschedules.get_noise_schedule(10, name, 0.001, 80.0))


def test_scalings():
    sigma = np.asarray([80.0, 1.0, 0.5, 1e-3, 0.0], np.float32)
    for a, b in zip(precond.get_scalings(torch.from_numpy(sigma), 0.5),
                    jprecond.get_scalings(jnp.asarray(sigma), 0.5)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_ddim_matches_jax_and_ends_finite():
    """DDIM-10 on the exponential grid with a fixed nonlinear denoiser; the
    terminal sigma = 0 step must give no NaN (expm1(-inf) = -1)."""
    sigmas = schedules.get_noise_schedule(10, "exponential", 0.001, 80.0)
    x0 = _x(2, 10, 7, scale=80.0)
    w = _x(7, 7, seed=1, scale=0.3)

    def jden(x, sigma):
        return precond_j(lambda xin, s: jnp.tanh(xin @ w) * s[:, None, None], x,
                         jnp.broadcast_to(sigma, (2,)))

    def precond_j(inner, x, s):
        return jprecond.precond_denoise(inner, x, s, 0.5)

    def pden(x, sigma):
        s = torch.full((2,), float(sigma))
        return precond.precond_denoise(
            lambda xin, s_: torch.tanh(xin @ torch.from_numpy(w)) * s_[:, None, None],
            x, s, 0.5)

    ref = np.asarray(jsamplers.sample_ddim(jden, jnp.asarray(x0), sigmas))
    out = samplers.sample_loop("ddim", pden, torch.from_numpy(x0), sigmas).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)


def test_other_samplers_not_ported():
    """The samplers the port once refused run now: Heun, the first of
    them, on the DDIM test's denoiser matches JAX at the toy bound of
    tests/test_torch_samplers.py (which holds every sampler); an unknown
    name still raises ValueError."""
    sigmas = schedules.get_noise_schedule(10, "exponential", 0.001, 80.0)
    x0 = _x(2, 10, 7, scale=80.0)
    w = _x(7, 7, seed=1, scale=0.3)

    def jden(x, sigma):
        return jprecond.precond_denoise(lambda xin, s: jnp.tanh(xin @ w) * s[:, None, None],
                                        x, jnp.broadcast_to(sigma, (2,)), 0.5)

    def pden(x, sigma):
        return precond.precond_denoise(
            lambda xin, s_: torch.tanh(xin @ torch.from_numpy(w)) * s_[:, None, None],
            x, torch.full((2,), float(sigma)), 0.5)
    ref = np.asarray(jsamplers.sample_loop("heun", jden, jnp.asarray(x0), sigmas))
    out = samplers.sample_loop("heun", pden, torch.from_numpy(x0), sigmas).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
    with pytest.raises(ValueError):
        samplers.sample_loop("nope", None, torch.zeros(1, 10, 7), [1.0, 0.0])
