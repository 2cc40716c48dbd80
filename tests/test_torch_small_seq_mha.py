"""Kernel B2 of the PyTorch port (`mdt_policy_tpu_torch/ops/small_seq_mha.py`)
against the JAX package's Pallas kernel, which runs here in interpret mode,
and its route in the denoisers' `Attention`.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is checked on the card (the `cuda` tests below, and
`chip_smoke.py`). The JAX package is imported inside the parity tests, so
that on a GPU machine without JAX the `cuda` tests of this file run alone:

    python -m pytest tests/test_torch_small_seq_mha.py -m cuda --noconftest
"""

from unittest import mock

import numpy as np
import pytest
import torch

from mdt_policy_tpu_torch.models import blocks
from mdt_policy_tpu_torch.ops.small_seq_mha import small_seq_mha, small_seq_mha_reference

# the four shapes of tests/test_pallas_attention.py, MDT's encoder and causal
# decoder, and a single token
SHAPES = [
    (4, 8, 10, 48, True),   # MDT-V decoder
    (3, 8, 14, 48, False),  # encoder regime
    (2, 6, 23, 64, False),  # MDT block_size regime
    (5, 4, 7, 32, True),    # odd sizes
    (2, 8, 3, 64, False),   # MDT encoder: goal + two camera tokens
    (2, 8, 10, 64, True),   # MDT decoder
    (3, 2, 1, 16, True),    # T = 1: the diagonal alone
]
# f32: the same arithmetic on both sides, summation order apart. bf16: both
# round q*scale, the probabilities and the output to bf16 (8 significant
# bits, 3.9e-3 relative), and a rounding can land on the neighbouring value
# when the f32 results differ in the last bit; outputs are O(1).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("B,H,T,D,causal", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_b2_matches_pallas_kernel(B, H, T, D, causal, dtype):
    import jax.numpy as jnp
    from mdt_policy_tpu.ops.pallas_attention import small_seq_mha as jax_mha
    arrays = _qkv((B, H, T, D))
    ref = np.asarray(jax_mha(*(jnp.asarray(a, dtype) for a in arrays), causal, 16,
                             True)).astype(np.float32)  # interpret mode
    tdt = getattr(torch, dtype)
    out = small_seq_mha(*(torch.from_numpy(a).to(tdt) for a in arrays), causal)
    assert out.shape == (B, H, T, D) and out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("B,H,T,D,causal", [SHAPES[0], SHAPES[4], SHAPES[6]])
def test_plain_b2_gradients_match_jax_vjp(B, H, T, D, causal):
    """Gradients of sum(out * w) through the Pallas kernel's custom VJP and
    through the port's plain version (what the wrapper's backward runs),
    f32, at 1e-4: summation order through two matmuls and the softmax."""
    import jax
    import jax.numpy as jnp
    from mdt_policy_tpu.ops.pallas_attention import small_seq_mha as jax_mha
    q, k, v = _qkv((B, H, T, D), seed=1)
    w = np.random.default_rng(2).normal(size=(B, H, T, D)).astype(np.float32)
    jgrads = jax.grad(lambda q_, k_, v_: jnp.sum(jax_mha(q_, k_, v_, causal, 16, True) * w),
                      argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (small_seq_mha(tq, tk, tv, causal) * torch.from_numpy(w)).sum().backward()
    for mine, theirs in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-4, atol=1e-4)


def test_plain_b2_takes_strided_views():
    """The transposed views that `Attention` builds give what contiguous
    inputs give."""
    x = torch.from_numpy(_qkv((2, 10, 8 * 48))[0])
    view = x.reshape(2, 10, 8, 48).transpose(1, 2)
    assert not view.is_contiguous()
    torch.testing.assert_close(small_seq_mha(view, view, view, True),
                               small_seq_mha(*(view.contiguous(),) * 3, True),
                               rtol=0, atol=0)


def test_wrapper_counts_no_launch_on_cpu():
    before = small_seq_mha.launches
    small_seq_mha(*(torch.zeros(1, 2, 4, 8),) * 3)
    assert small_seq_mha.launches == before


@pytest.mark.parametrize("shapes,dtype,error", [
    (((1, 2, 33, 8),) * 3, torch.float32, ValueError),   # T > 32
    (((1, 2, 4, 129),) * 3, torch.float32, ValueError),  # D > 128
    (((1, 2, 4, 8), (1, 2, 5, 8), (1, 2, 5, 8)), torch.float32, ValueError),  # cross
    (((2, 4, 8),) * 3, torch.float32, ValueError),       # not (B, H, T, D)
    (((1, 2, 4, 8),) * 3, torch.float16, TypeError),
    (((1, 2, 4, 8),) * 3, torch.float64, TypeError),
])
def test_wrapper_rejects_bad_input(shapes, dtype, error):
    with pytest.raises(error):
        small_seq_mha(*(torch.zeros(s, dtype=dtype) for s in shapes))


def _attention(causal, attn_pdrop=0.3):
    torch.manual_seed(0)
    return blocks.Attention(32, 4, causal=causal, attn_pdrop=attn_pdrop)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_routes_self_attention_to_b2(causal):
    """Self-attention without a generator takes B2 and gives what `sdpa`
    gives; with a generator (dropout on the probabilities) it takes `sdpa`,
    unless attn_pdrop is 0; cross-attention and T > 32 always take `sdpa`."""
    attn = _attention(causal)
    x = torch.from_numpy(_qkv((2, 10, 32))[0])
    with mock.patch.object(blocks, "small_seq_mha", wraps=blocks.small_seq_mha) as b2, \
            mock.patch.object(blocks, "sdpa", wraps=blocks.sdpa) as plain:
        y = attn(x)
        assert (b2.call_count, plain.call_count) == (1, 0)
        with mock.patch.object(blocks, "small_seq_mha", side_effect=AssertionError):
            attn(x, generator=torch.Generator().manual_seed(0))
        assert plain.call_count == 1
        attn(x, context=torch.zeros(2, 5, 32))
        attn(torch.zeros(2, 33, 32))
        assert (b2.call_count, plain.call_count) == (1, 3)
        _attention(causal, attn_pdrop=0.0)(x, generator=torch.Generator())
        assert b2.call_count == 2
    with torch.no_grad():
        q, k, v = (layer(x).reshape(2, 10, 4, 8).transpose(1, 2)
                   for layer in (attn.query, attn.key, attn.value))
        ref = attn.c_proj(blocks.sdpa(q, k, v, causal=causal)
                          .transpose(1, 2).reshape(2, 10, 32))
    torch.testing.assert_close(y.detach(), ref, rtol=1e-5, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# |kernel - plain| on the card. f32: summation order only. bf16: one ulp of
# the largest output (2^-7 relative at the top of its binade) plus the flip
# of one probability's rounding (2^-8) times the largest |v|.
def _bound(dtype, ref, v):
    amax = max(1.0, ref.float().abs().max().item())
    if dtype == torch.float32:
        return 1e-5 * amax
    return 2.0 ** -7 * amax + 2.0 ** -8 * v.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,D,causal", SHAPES + [(1024, 8, 10, 48, True),
                                                    (3, 3, 32, 128, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda, B, H, T, D, causal, dtype):
    gen = torch.Generator("cuda").manual_seed(0)
    # the transposed views Attention passes: (B, T, H, D) memory
    q, k, v = (torch.randn((B, T, H, D), generator=gen, device=cuda).to(dtype)
               .transpose(1, 2) for _ in range(3))
    before = small_seq_mha.launches
    out = small_seq_mha(q, k, v, causal)
    ref = small_seq_mha_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert small_seq_mha.launches == before + 1
    assert out.shape == (B, H, T, D) and out.transpose(1, 2).is_contiguous()
    assert (out.float() - ref.float()).abs().max().item() <= _bound(dtype, ref, v)


@pytest.mark.cuda
def test_cuda_kernel_gradient_is_the_plain_one(cuda):
    gen = torch.Generator("cuda").manual_seed(1)
    q, k, v = (torch.randn((2, 8, 10, 48), generator=gen, device=cuda).requires_grad_()
               for _ in range(3))
    small_seq_mha(q, k, v, True).sum().backward()
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    small_seq_mha_reference(q, k, v, True).sum().backward()
    for mine, ref in zip(grads, (q.grad, k.grad, v.grad)):
        torch.testing.assert_close(mine, ref, rtol=0, atol=0)
