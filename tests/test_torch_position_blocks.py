"""The masked `sdpa`, the position embeddings and the rest of the block
library of the PyTorch port against the JAX package, on the CPU at small
widths: JAX parameters, perturbed, carried across by `utils/from_jax.py`,
the same numpy inputs through both.

Tolerance: rtol 1e-4, atol 5e-5 at float32 (the port-parity bound of
tests/test_torch_modules.py). A bf16 module is held to its float32 JAX
counterpart no further than 1.5x JAX's own bf16 module is, the bound the
bf16 denoiser tests use. Heads are 32 channels wide: the rotary width is
max(n_heads // 2, 32), so a narrower head cannot take it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdt_policy_tpu.models import blocks as jb
from mdt_policy_tpu.models import position_embeddings as jpe
from mdt_policy_tpu.ops import attention as jattn
from mdt_policy_tpu_torch.models import blocks as pb
from mdt_policy_tpu_torch.models import position_embeddings as ppe
from mdt_policy_tpu_torch.ops import attention as pattn
from mdt_policy_tpu_torch.utils import from_jax
from test_torch_modules import TOL, _x, jinit, jrun, load, prun

B, T, C, H = 2, 6, 64, 2  # head width 32


def jinit_eager(module, *args, seed=0):
    """`jinit` for a module whose call takes Python ints (no jit)."""
    params = jax.device_get(module.init(jax.random.PRNGKey(seed), *args)["params"])
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(
        lambda p: (np.asarray(p) + rng.normal(size=np.shape(p)) * 0.1).astype(np.float32),
        params)


def _mask(*shape, seed=0):
    m = np.random.default_rng(seed).uniform(size=shape) > 0.3
    m[..., 0] = True  # every query keeps a key
    return m


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_mask_and_causal_mask(causal, dtype):
    q, k, v = (_x(B, H, T, 32, seed=s) for s in range(3))
    mask = _mask(B, 1, T, T)
    jdt, pdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jattn.sdpa(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                mask=jnp.asarray(mask), causal=causal), np.float32)
    out = pattn.sdpa(*(torch.from_numpy(a).to(pdt) for a in (q, k, v)),
                     mask=torch.from_numpy(mask), causal=causal).float().numpy()
    np.testing.assert_allclose(out, ref, **(TOL if dtype == "float32" else
                                            dict(rtol=2e-2, atol=2e-2)))
    np.testing.assert_array_equal(pattn.causal_mask(4, 6).numpy(),
                                  np.asarray(jattn.causal_mask(4, 6)))
    # the mask reaches the scores: a masked key changes nothing
    v2 = v.copy()
    v2[:, :, 3] += 100.0
    only = np.ones((1, 1, T, T), bool)
    only[..., 3] = False
    a = pattn.sdpa(*map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(only))
    b = pattn.sdpa(*map(torch.from_numpy, (q, k, v2)), mask=torch.from_numpy(only))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_rotary_functions():
    x = _x(B, H, T, 40)
    np.testing.assert_array_equal(ppe.rotate_half(torch.from_numpy(x)).numpy(),
                                  np.asarray(jpe.rotate_half(x)))
    for rescale in (1.0, 2.5):
        np.testing.assert_allclose(
            ppe.rotary_frequencies(32, theta_rescale_factor=rescale).numpy(),
            np.asarray(jpe.rotary_frequencies(32, theta_rescale_factor=rescale)), **TOL)
    freqs, scale = _x(T, 32, seed=1), 1 + 0.1 * _x(T, 32, seed=2)
    np.testing.assert_allclose(
        ppe.apply_rotary_emb(torch.from_numpy(freqs), torch.from_numpy(x),
                             torch.from_numpy(scale)).numpy(),
        np.asarray(jpe.apply_rotary_emb(freqs, x, scale)), **TOL)
    q, k = _x(B, H, 9, 32, seed=3), _x(B, H, 9, 32, seed=4)
    for xpos in (False, True):
        jm = jpe.RotaryEmbedding(32, use_xpos=xpos, xpos_scale_base=4.0)
        jq, jk = jm.apply({}, q, k)
        pq, pk = ppe.RotaryEmbedding(32, use_xpos=xpos, xpos_scale_base=4.0)(
            torch.from_numpy(q), torch.from_numpy(k))
        np.testing.assert_allclose(pq.numpy(), np.asarray(jq), **TOL)
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), **TOL)
    with pytest.raises(ValueError, match="xpos"):
        ppe.RotaryEmbedding(32, use_xpos=True).rotate_queries_or_keys(torch.from_numpy(q))


def test_relative_and_dynamic_position_bias():
    rel = np.arange(-300, 301, dtype=np.int32)[None]
    for causal in (False, True):
        np.testing.assert_array_equal(
            ppe._relative_position_bucket(torch.from_numpy(rel).long(), causal, 32, 128).numpy(),
            np.asarray(jpe._relative_position_bucket(jnp.asarray(rel), causal, 32, 128)))
        jm = jpe.RelativePositionBias(scale=0.5, causal=causal, heads=H)
        p = jinit_eager(jm, 7, 9)
        pm = load(ppe.RelativePositionBias(scale=0.5, causal=causal, heads=H),
                  from_jax.module_from_jax(p))
        np.testing.assert_allclose(pm(7, 9).detach().numpy(), jrun(jm, p, 7, 9), **TOL)
    for log_distance in (True, False):
        jm = jpe.DynamicPositionBias(16, heads=H, depth=2, log_distance=log_distance)
        p = jinit_eager(jm, 5, 8)
        pm = load(ppe.DynamicPositionBias(16, heads=H, depth=2, log_distance=log_distance),
                  from_jax.module_from_jax(p))
        np.testing.assert_allclose(pm(5, 8).detach().numpy(), jrun(jm, p, 5, 8), **TOL)


def _attention_pair(dtype=None, **kw):
    x = _x(B, T, C)
    jm = jb.Attention(C, H, dtype=None if dtype is None else getattr(jnp, dtype), **kw)
    p = jinit(jm, x)
    sd = {}
    from_jax._attention(sd, "a", p)
    return x, jm, p, load(pb.Attention(C, H, **kw, dtype=None if dtype is None
                                       else getattr(torch, dtype)), sd, "a.")


@pytest.mark.parametrize("rot,xpos,masked,causal", [
    (True, False, False, False), (True, True, False, True), (False, False, True, True),
    (True, True, True, False)])
def test_attention_rotary_mask_and_its_b2_route(monkeypatch, rot, xpos, masked, causal):
    x, jm, p, pm = _attention_pair(use_rot_embed=rot, rotary_xpos=xpos, causal=causal,
                                   bias=True)
    mask = _mask(T, T, seed=5) if masked else None
    calls = []
    b2 = pb.small_seq_mha

    def spy(q, k, v, **kw):
        calls.append((q.is_contiguous(), k.is_contiguous()))
        return b2(q, k, v, **kw)

    monkeypatch.setattr(pb, "small_seq_mha", spy)
    out = prun(pm, x, custom_attn_mask=None if mask is None else torch.from_numpy(mask))
    ref = jrun(jm, p, x, custom_attn_mask=mask)
    np.testing.assert_allclose(out, ref, **TOL)
    # B2 has no mask input: it serves only the unmasked calls, and takes the
    # rotated q and k as they come (contiguous (B, H, T, D), not views)
    assert calls == ([] if masked else [(rot, rot)])


def test_attention_bf16_rotary():
    x, jm, p, pm = _attention_pair("bfloat16", use_rot_embed=True, rotary_xpos=True,
                                   causal=True)
    jf32 = jb.Attention(C, H, use_rot_embed=True, rotary_xpos=True, causal=True)
    ref32 = jrun(jf32, p, x)
    jbf = np.asarray(jm.apply({"params": p}, x), np.float32)
    with torch.no_grad():
        out = pm(torch.from_numpy(x)).float().numpy()
    bound = 1.5 * np.abs(jbf - ref32).max()
    assert np.abs(out - ref32).max() <= bound, (np.abs(out - ref32).max(), bound)


def _stack(jm, pm, *args, **kw):
    p = jinit(jm, *args, **kw)
    pm = load(pm, from_jax.block_stack_from_jax(p))
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else
             [torch.from_numpy(np.array(c)) for c in a] for a in args]
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    with torch.no_grad():
        out = pm(*targs, **tkw)
    ref = jm.apply({"params": p}, *args, **kw)
    return out, ref


def test_bias_and_custom_mask_through_the_stacks():
    x, c, ctx = _x(B, T, C), _x(B, 1, C, seed=2), _x(B, T, C, seed=1)
    mask = _mask(T, T, seed=6)
    out, ref = _stack(jb.TransformerEncoder(C, H, 2, bias=True),
                      pb.TransformerEncoder(C, H, 2, bias=True), x, custom_attn_mask=mask)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the decoder's causal self- and cross-attention, each ANDed with the mask
    out, ref = _stack(jb.TransformerDecoder(C, H, 2, bias=True),
                      pb.TransformerDecoder(C, H, 2, bias=True), x, ctx,
                      custom_attn_mask=mask)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    for noise in (False, True):
        out, ref = _stack(jb.TransformerFiLMDecoder(C, H, 2, C, bias=True,
                                                    use_noise_encoder=noise),
                          pb.TransformerFiLMDecoder(C, H, 2, bias=True,
                                                    use_noise_encoder=noise),
                          x, c, ctx, custom_attn_mask=mask)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_the_six_other_encoders_and_decoders():
    x, c, ctx = _x(B, T, C), _x(B, 1, C, seed=2), _x(B, 4, C, seed=1)
    for jcls, pcls in ((jb.TransformerCrossAttentionEncoder, pb.TransformerCrossAttentionEncoder),
                       (jb.TransformerCrossAttentionOnlyEncoder,
                        pb.TransformerCrossAttentionOnlyEncoder),
                       (jb.SiamneseDecoder, pb.SiamneseDecoder)):
        for bias in (False, True):
            out, ref = _stack(jcls(C, H, 2, bias=bias), pcls(C, H, 2, bias=bias), x, ctx)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    out, ref = _stack(jb.TransformerFiLMEncoder(C, H, 2, C), pb.TransformerFiLMEncoder(C, H, 2, C),
                      x, c)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    outs, refs = _stack(jb.TransformerEncoderInterleaved(C, H, 3),
                        pb.TransformerEncoderInterleaved(C, H, 3), x)
    assert len(outs) == len(refs) == 3
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    conds = [np.asarray(r) for r in refs[:2]]
    for noise in (False, True):
        out, ref = _stack(jb.TransformerFiLMDecoderInterleaved(C, H, 2, C, use_noise_encoder=noise),
                          pb.TransformerFiLMDecoderInterleaved(C, H, 2, C,
                                                               use_noise_encoder=noise),
                          x, c, conds)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_cross_attention_only_block_and_mlp_bias():
    x, ctx = _x(B, T, C), _x(B, 4, C, seed=1)
    jm = jb.CrossAttentionOnlyBlock(C, H, bias=True)
    p = jinit(jm, x, ctx)
    sd = {}
    from_jax._block(sd, "b", p)
    pm = load(pb.CrossAttentionOnlyBlock(C, H, bias=True), sd, "b.")
    np.testing.assert_allclose(prun(pm, x, ctx), jrun(jm, p, x, ctx), **TOL)
    # without a context it attends to itself, as JAX's does
    np.testing.assert_allclose(prun(pm, x), jrun(jm, p, x), **TOL)
    jm = jb.MLP(C, bias=True)
    p = jinit(jm, x)
    sd = {}
    from_jax._dense(sd, "m.c_fc", p["c_fc"])
    from_jax._dense(sd, "m.c_proj", p["c_proj"])
    np.testing.assert_allclose(prun(load(pb.MLP(C, bias=True), sd, "m."), x),
                               jrun(jm, p, x), **TOL)


@pytest.mark.parametrize("style", ["map", "map_state_only", "mean_pooling",
                                   "mean_pool_state_only", "mlp", "single_token",
                                   "multihead"])
def test_clip_style_projection_styles(style):
    x = _x(B, 4, 32)
    jm = jb.ClipStyleProjection(clip_style=style, token_dim=32, clip_token_index=2,
                                num_token=4)
    p = jinit(jm, x) if style in ("map", "map_state_only", "mlp") else {}
    pm = load(pb.ClipStyleProjection(style, token_dim=32, clip_token_index=2, num_token=4),
              from_jax.clip_proj_from_jax(p))
    np.testing.assert_allclose(prun(pm, x), jrun(jm, p, x), **TOL)
    np.testing.assert_allclose(prun(pb.MeanPooling(32), x),
                               np.asarray(jb.MeanPooling(32).apply({}, x)), **TOL)


def test_unknown_clip_style_is_refused():
    with pytest.raises(ValueError, match="clip_style"):
        pb.ClipStyleProjection("pooled")
