"""Kernel B1 of the PyTorch port (`mdt_policy_tpu_torch/ops/fused_qkv_attention.py`)
against the JAX package's Pallas kernel, which runs here in interpret mode.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is checked on the card (the `cuda` test below, and
`chip_smoke.py`). The JAX package is imported inside the parity test, so
that on a GPU machine without JAX the `cuda` tests of this file run alone:

    python -m pytest tests/test_torch_fused_qkv_attention.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from mdt_policy_tpu_torch.ops.fused_qkv_attention import (
    fused_qkv_attention, fused_qkv_attention_reference)

# f32 on both sides, same math; the two differ only in summation order
RTOL = ATOL = 1e-5


@pytest.mark.parametrize("B,T,C,H,causal", [
    (5, 13, 24, 3, False),
    (4, 196, 48, 6, False),   # Voltron-shaped, narrow
    (3, 8, 16, 2, True),      # causal (CLIP text regime)
    (2, 77, 32, 4, True),
])
def test_plain_b1_matches_pallas_kernel(B, T, C, H, causal):
    from mdt_policy_tpu.ops.fused_qkv_attention import fused_qkv_attention as jax_fused
    qkv = np.random.default_rng(0).normal(size=(B, T, 3 * C)).astype(np.float32)
    ref = np.asarray(jax_fused(qkv, H, causal, 2, True))  # interpret mode
    out = fused_qkv_attention(torch.from_numpy(qkv), H, causal)
    assert out.shape == (B, T, C) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_wrapper_counts_no_launch_on_cpu():
    before = fused_qkv_attention.launches
    fused_qkv_attention(torch.zeros(1, 4, 24), 2)
    assert fused_qkv_attention.launches == before


@pytest.mark.parametrize("shape,heads,dtype,error", [
    ((2, 5, 24), 5, torch.float32, ValueError),     # C=8 not divisible by 5
    ((2, 5, 25), 1, torch.float32, ValueError),     # last dim not 3C
    ((10, 24), 2, torch.float32, ValueError),       # not (B, T, 3C)
    ((2, 5, 24), 2, torch.float16, TypeError),      # unsupported dtype
    ((2, 5, 24), 2, torch.float64, TypeError),
])
def test_wrapper_rejects_bad_input(shape, heads, dtype, error):
    with pytest.raises(error):
        fused_qkv_attention(torch.zeros(shape, dtype=dtype), heads)


def test_wrapper_rejects_non_contiguous():
    qkv = torch.zeros(2, 24, 5).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_qkv_attention(qkv, 2)


def test_backward_is_plain_backward():
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 9, 48))
                         .astype(np.float32)).requires_grad_()
    (fused_qkv_attention(x, 2) ** 2).sum().backward()
    y = x.detach().clone().requires_grad_()
    (fused_qkv_attention_reference(y, 2) ** 2).sum().backward()
    torch.testing.assert_close(x.grad, y.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_cuda_kernel_matches_plain(causal, dtype, tol):
    """The CUDA kernel against its plain version on the card, at the
    Voltron width. bf16 tolerance: one bf16 rounding of the output and of a
    probability (3.9e-3 relative on values of order 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator("cuda").manual_seed(0)
    qkv = torch.randn((3, 197, 3 * 384), generator=gen, device="cuda").to(dtype)
    before = fused_qkv_attention.launches
    out = fused_qkv_attention(qkv, 6, causal)
    ref = fused_qkv_attention_reference(qkv, 6, causal)
    torch.cuda.synchronize()
    assert fused_qkv_attention.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_kernel_matches_float64_attention(causal):
    """The f32 kernel against attention computed in float64 on the card, an
    oracle that shares no summation order with the kernel (kernel and plain
    version agree bit for bit at these shapes). Tolerance: f32 rounding of
    scores, probabilities and a 197-term sum, ~1e-6 on outputs below 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    B, T, C, H = 3, 197, 384, 6
    gen = torch.Generator("cuda").manual_seed(1)
    qkv = torch.randn((B, T, 3 * C), generator=gen, device="cuda")
    q, k, v = (t.double().reshape(B, T, H, C // H).transpose(1, 2)
               for t in qkv.split(C, dim=-1))
    scores = q @ k.transpose(-1, -2) * (C // H) ** -0.5
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device="cuda").tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    ref = (scores.softmax(-1) @ v).transpose(1, 2).reshape(B, T, C)
    out = fused_qkv_attention(qkv, H, causal)
    torch.cuda.synchronize()
    assert (out.double() - ref).abs().max().item() <= 1e-5
