"""Kernel B1 of the PyTorch port (`mdt_policy_tpu_torch/ops/fused_qkv_attention.py`)
against the JAX package's Pallas kernel, which runs here in interpret mode.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is checked on the card (the `cuda` test below, and
`chip_smoke.py`). The JAX package is imported inside the parity test, so
that on a GPU machine without JAX the `cuda` tests of this file run alone:

    python -m pytest tests/test_torch_fused_qkv_attention.py -m cuda --noconftest
"""

from unittest import mock

import numpy as np
import pytest
import torch

from mdt_policy_tpu_torch.ops import fused_qkv_attention as fqa
from mdt_policy_tpu_torch.ops._plain_backward import PlainBackward, launch_with_plain_backward
from mdt_policy_tpu_torch.ops.fused_qkv_attention import (
    _sm90_body, fused_qkv_attention, fused_qkv_attention_reference)

# f32 on both sides, same math; the two differ only in summation order
RTOL = ATOL = 1e-5


@pytest.mark.parametrize("B,T,C,H,causal", [
    (5, 13, 24, 3, False),
    (4, 196, 48, 6, False),   # Voltron-shaped, narrow
    (3, 8, 16, 2, True),      # causal (CLIP text regime)
    (2, 77, 32, 4, True),
    (2, 197, 128, 2, False),  # dh = 64: the Pallas head-pair kernel _kernel_pair
    (2, 77, 128, 2, True),    # ... causal
])
def test_plain_b1_matches_pallas_kernel(B, T, C, H, causal):
    from mdt_policy_tpu.ops.fused_qkv_attention import fused_qkv_attention as jax_fused
    qkv = np.random.default_rng(0).normal(size=(B, T, 3 * C)).astype(np.float32)
    ref = np.asarray(jax_fused(qkv, H, causal, 2, True))  # interpret mode
    out = fused_qkv_attention(torch.from_numpy(qkv), H, causal)
    assert out.shape == (B, T, C) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype,T,C,H,expected", [
    (torch.bfloat16, 1, 384, 6, True),
    (torch.bfloat16, 77, 512, 8, True),      # CLIP text
    (torch.bfloat16, 196, 384, 6, True),     # Voltron
    (torch.bfloat16, 197, 768, 12, True),    # CLIP vision
    (torch.bfloat16, 208, 192, 3, True),     # the longest T; an odd head count
    (torch.float32, 196, 384, 6, False),     # f32 stays on mha_core
    (torch.bfloat16, 196, 288, 6, False),    # dh = 48
    (torch.bfloat16, 196, 256, 2, False),    # dh = 128
    (torch.bfloat16, 209, 384, 6, False),    # T past the registers' 13 key steps
    (torch.bfloat16, 0, 384, 6, False),
])
def test_sm90_routing_predicate(dtype, T, C, H, expected):
    assert _sm90_body(dtype, T, C, H) is expected


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


@pytest.mark.parametrize("mode", ["no_grad", "frozen_inputs", "grad"])
def test_dispatch_enters_autograd_function_only_for_gradients(mode):
    """The CUDA branch's dispatch, its launch stood in for by the plain
    version (the kernel has no CPU mode): under no_grad, or on a qkv that
    needs no gradient (the frozen towers), the launch runs directly, with
    no autograd Function and no graph; where autograd wants qkv's gradient
    it runs through PlainBackward, whose gradient is the plain version's."""
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.normal(size=(2, 9, 3 * 128)).astype(np.float32))
    qkv.requires_grad_(mode != "frozen_inputs")
    kwargs = {"n_heads": 2, "causal": True}
    launched = []

    def launch(x, **kw):
        launched.append(kw)
        return fused_qkv_attention_reference(x, **kw)
    with mock.patch.object(fqa, "_launch", launch), \
            mock.patch.object(PlainBackward, "apply", wraps=PlainBackward.apply) as applied, \
            torch.set_grad_enabled(mode != "no_grad"):
        out = launch_with_plain_backward(fqa._launch, fused_qkv_attention_reference, kwargs,
                                         qkv)
    assert launched == [kwargs]
    assert applied.call_count == (mode == "grad")
    assert (out.grad_fn is not None) == (mode == "grad")
    if mode == "grad":
        up = torch.from_numpy(rng.normal(size=tuple(out.shape)).astype(np.float32))
        (grad,) = torch.autograd.grad((out * up).sum(), qkv)
        ref_x = qkv.detach().clone().requires_grad_()
        (ref,) = torch.autograd.grad(
            (fused_qkv_attention_reference(ref_x, **kwargs) * up).sum(), ref_x)
        torch.testing.assert_close(grad, ref, rtol=0, atol=0)


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


# The tensor-core body (csrc/attention_sm90.cuh) at every T of its domain's
# edges and of the towers, batches from one image to the train step's, and
# the towers' widths; each case non-causal and causal
SM90_CASES = [(1, 1, 384), (3, 16, 512), (17, 77, 512), (256, 77, 512), (3, 196, 384),
              (256, 196, 384), (17, 197, 768), (1, 208, 768), (3, 208, 512), (256, 197, 768)]


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _float64_attention(qkv, H, causal):
    B, T, C3 = qkv.shape
    C = C3 // 3
    q, k, v = (t.double().reshape(B, T, H, C // H).transpose(1, 2)
               for t in qkv.split(C, dim=-1))
    scores = q @ k.transpose(-1, -2) * (C // H) ** -0.5
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=qkv.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    return (scores.softmax(-1) @ v).transpose(1, 2).reshape(B, T, C)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,T,C", SM90_CASES)
def test_cuda_sm90_body_matches_plain_and_float64(B, T, C, causal):
    """The bf16 tensor-core body against its plain version (same roundings,
    bound 1e-2: chip_smoke.py's KERNEL_TOL) and against float64 attention of
    the same bf16 inputs (bound 1e-2 x max(1, max|ref|): the output's bf16
    rounding, 2^-9 relative, and the probabilities', 2^-9 of each p times
    |v|; a causal row over few keys has outputs of |v|, up to ~4.5)."""
    _needs_cuda()
    H = C // 64
    assert _sm90_body(torch.bfloat16, T, C, H)
    gen = torch.Generator("cuda").manual_seed(T + B)
    qkv = torch.randn((B, T, 3 * C), generator=gen, device="cuda").bfloat16()
    before = fused_qkv_attention.launches
    out = fused_qkv_attention(qkv, H, causal)
    torch.cuda.synchronize()
    assert fused_qkv_attention.launches == before + 1
    assert out.shape == (B, T, C) and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all())
    ref = fused_qkv_attention_reference(qkv, H, causal)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    f64 = _float64_attention(qkv, H, causal)
    assert (out.double() - f64).abs().max().item() <= 1e-2 * max(1.0, f64.abs().max().item())
    assert torch.equal(out, fused_qkv_attention(qkv, H, causal))  # no run-to-run variation


@pytest.mark.cuda
def test_cuda_sm90_body_refuses_misaligned_qkv():
    """A contiguous view whose base lies 2 bytes past an allocation is not
    16-byte aligned: the tensor-core body raises before any launch."""
    _needs_cuda()
    B, T, C = 2, 196, 384
    buf = torch.zeros(B * T * 3 * C + 1, dtype=torch.bfloat16, device="cuda")
    qkv = buf[1:].view(B, T, 3 * C)
    assert qkv.is_contiguous() and qkv.data_ptr() % 16
    before = fused_qkv_attention.launches
    with pytest.raises(ValueError, match="aligned"):
        fused_qkv_attention(qkv, 6)
    with pytest.raises(ValueError, match="contiguous"):
        fused_qkv_attention(buf[:B * T * 3 * C].view(B, 3 * C, T).transpose(1, 2), 6)
    assert fused_qkv_attention.launches == before


@pytest.mark.cuda
def test_cuda_light_call_records_no_graph():
    """On the card, under no_grad and on a qkv that needs no gradient, the
    call enters no autograd Function and its output carries no grad_fn;
    with a qkv that needs one it runs through PlainBackward."""
    _needs_cuda()
    qkv = torch.randn((2, 77, 1152), device="cuda").bfloat16()
    x = qkv.clone().requires_grad_()
    with mock.patch.object(PlainBackward, "apply", wraps=PlainBackward.apply) as applied:
        assert fused_qkv_attention(qkv, 6).grad_fn is None
        with torch.no_grad():
            assert fused_qkv_attention(x, 6).grad_fn is None
        assert applied.call_count == 0
        assert fused_qkv_attention(x, 6).grad_fn is not None
        assert applied.call_count == 1
