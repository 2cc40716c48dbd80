"""Kernel B3 of the PyTorch port (`mdt_policy_tpu_torch/ops/fused_norm.py`)
against the JAX package's Pallas kernels, which run here in interpret mode.

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernel itself is checked on the card (the `cuda` tests below, and
`chip_smoke.py`). The JAX package is imported inside the parity tests, so
that on a GPU machine without JAX the `cuda` tests of this file run alone:

    python -m pytest tests/test_torch_fused_norm.py -m cuda --noconftest
"""

from unittest import mock

import numpy as np
import pytest
import torch

from mdt_policy_tpu_torch.ops import fused_norm as fn
from mdt_policy_tpu_torch.ops._plain_backward import PlainBackward, launch_with_plain_backward
from mdt_policy_tpu_torch.ops.fused_norm import (
    fused_layer_norm, fused_layer_norm_reference, fused_rms_norm,
    fused_rms_norm_reference)

# f32 on both sides, same math; the two differ only in summation order
F32_TOL = 1e-5
# bf16 output: one rounding to 8 significant bits (3.9e-3 relative) on
# values of order 1, plus a flip to the neighbouring value when the f32
# results differ in the last bit; the bound of tests/test_fused_norm.py
BF16_TOL = 2e-2


def _arrays(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    w = rng.normal(size=shape[-1]).astype(np.float32)
    b = rng.normal(size=shape[-1]).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape,eps", [
    ((3, 7, 384), 1e-6),     # Voltron encoder_norm width, 21 ragged rows
    ((5, 512), 1e-5),        # CLIP text
    ((2, 11, 768), 1e-5),    # CLIP vision
])
def test_plain_layer_norm_matches_pallas_kernel(shape, eps):
    from mdt_policy_tpu.ops.fused_norm import fused_layer_norm as jax_ln
    x, w, b = _arrays(shape, 0, scale=3.0)
    ref = np.asarray(jax_ln(x, w, b, eps, 8, True))  # interpret mode
    out = fused_layer_norm(*map(torch.from_numpy, (x, w, b)), eps)
    assert out.shape == shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("shape", [(4, 13, 192), (3, 196, 384)])
def test_plain_rms_norm_matches_pallas_kernel(shape):
    from mdt_policy_tpu.ops.fused_norm import fused_rms_norm as jax_rms
    x, g, _ = _arrays(shape, 1, scale=2.0)
    ref = np.asarray(jax_rms(x, g, 1e-8, 8, True))
    out = fused_rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-8)
    np.testing.assert_allclose(out.numpy(), ref, rtol=F32_TOL, atol=F32_TOL)


def test_rms_norm_clamps_tiny_rows():
    """The clamp branch (||x|| below eps) as the Pallas kernel computes it,
    and an all-zero row comes out 0, not NaN."""
    from mdt_policy_tpu.ops.fused_norm import fused_rms_norm as jax_rms
    x = np.full((3, 8), 1e-12, np.float32)
    x[2] = 0.0
    g = np.ones(8, np.float32)
    ref = np.asarray(jax_rms(x, g, 1e-8, 2, True))
    out = fused_rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-8)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
    assert torch.isfinite(out).all() and (out[2] == 0).all()


@pytest.mark.parametrize("kind", ["ln", "rms"])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_bf16_in_out_matches_pallas_kernel(kind, w_dtype):
    """bf16 input and output with f32 statistics, from a bf16 weight (the
    frozen towers) or an f32 master weight (the foresight decoder). The
    kernel takes weights in the input's dtype only: an f32 weight is refused
    as it is, and the caller casts it to bf16 first, as the JAX decoder does
    (masked_decoder.py:76, blocks.py:97-98); the Pallas kernel gets the same
    cast weight."""
    import jax.numpy as jnp
    from mdt_policy_tpu.ops import fused_norm as jfn
    x, w, b = _arrays((6, 384), 2, scale=30.0)
    xb = torch.from_numpy(x).bfloat16()
    wt, bt = (torch.from_numpy(a).to(w_dtype) for a in (w, b))
    if w_dtype != torch.bfloat16:
        with pytest.raises(TypeError, match="cast the weights"):
            fused_layer_norm(xb, wt, bt, 1e-5) if kind == "ln" else fused_rms_norm(xb, wt)
        wt, bt = wt.bfloat16(), bt.bfloat16()
    jw, jb = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (wt, bt))
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    if kind == "ln":
        ref = jfn.fused_layer_norm(jx, jw, jb, 1e-5, 2, True)
        out = fused_layer_norm(xb, wt, bt, 1e-5)
    else:
        ref = jfn.fused_rms_norm(jx, jw, 1e-8, 2, True)
        out = fused_rms_norm(xb, wt, 1e-8)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_wrappers_count_no_launch_on_cpu():
    before = (fused_layer_norm.launches, fused_rms_norm.launches)
    fused_layer_norm(torch.zeros(2, 8), torch.ones(8), torch.zeros(8))
    fused_rms_norm(torch.zeros(2, 8), torch.ones(8))
    assert (fused_layer_norm.launches, fused_rms_norm.launches) == before


@pytest.mark.parametrize("x,w,b,error", [
    (torch.zeros(2, 12), torch.ones(12), torch.zeros(12), ValueError),  # D % 8
    (torch.zeros(2, 8, dtype=torch.float16), torch.ones(8), torch.zeros(8),
     TypeError),
    (torch.zeros(2, 8), torch.ones(16), torch.zeros(16), ValueError),   # shape
    (torch.zeros(8, 2).T, torch.ones(8), torch.zeros(8), ValueError),   # strides
    (torch.zeros(2, 8), torch.ones(8), torch.zeros(8, dtype=torch.bfloat16),
     TypeError),
])
def test_wrappers_reject_bad_input(x, w, b, error):
    with pytest.raises(error):
        fused_layer_norm(x, w, b)
    if b.dtype == w.dtype and w.shape == x.shape[-1:]:
        with pytest.raises(error):
            fused_rms_norm(x, w)


@pytest.mark.parametrize("weights_grad", [True, False])
def test_autograd_function_backward_is_plain_backward(weights_grad):
    """The kernels' autograd Function (its forward stood in for by the
    plain version, as the kernel has no CPU mode) gives the gradients of
    autograd through the plain version, for a trainable weight and for a
    frozen one (weights without grad)."""
    rng = np.random.default_rng(3)
    x0, w0, b0 = (torch.from_numpy(a) for a in _arrays((4, 5, 16), 3))
    up = torch.from_numpy(rng.normal(size=(4, 5, 16)).astype(np.float32))
    for kind in ("ln", "rms"):
        leaves = [x0.clone().requires_grad_()] + [
            t.clone().requires_grad_(weights_grad) for t in (w0, b0)]
        refs = [t.detach().clone().requires_grad_(t.requires_grad) for t in leaves]
        if kind == "ln":
            out = PlainBackward.apply(fn._reference, fn._reference, {"eps": 1e-5}, *leaves)
            ref = fused_layer_norm_reference(*refs, 1e-5)
        else:
            out = PlainBackward.apply(fn._reference, fn._reference, {"eps": 1e-8},
                                      *leaves[:2], None)
            ref = fused_rms_norm_reference(*refs[:2], 1e-8)
        (out * up).sum().backward()
        (ref * up).sum().backward()
        for a, r in zip(leaves, refs):
            if r.grad is None:
                assert a.grad is None
            else:
                torch.testing.assert_close(a.grad, r.grad, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kind", ["ln", "rms"])
@pytest.mark.parametrize("mode", ["no_grad", "frozen_inputs", "grad"])
def test_dispatch_enters_autograd_function_only_for_gradients(kind, mode):
    """The CUDA branch's dispatch, its launch stood in for by the plain
    version (the kernel has no CPU mode): under no_grad, or on inputs that
    need no gradient, the launch runs directly, with no autograd Function
    and no graph; where autograd wants a gradient (here the input's, the
    weights frozen as in the towers) it runs through PlainBackward, whose
    gradient is the plain version's."""
    x, w, b = (torch.from_numpy(a) for a in _arrays((4, 5, 16), 5))
    x.requires_grad_(mode != "frozen_inputs")
    tensors = (x, w, b) if kind == "ln" else (x, w, None)
    eps = 1e-5 if kind == "ln" else 1e-8
    launched = []

    def launch(*args, eps):
        launched.append(eps)
        return fn._reference(*args, eps)
    with mock.patch.object(fn, "_launch", launch), \
            mock.patch.object(PlainBackward, "apply", wraps=PlainBackward.apply) as applied, \
            torch.set_grad_enabled(mode != "no_grad"):
        out = launch_with_plain_backward(fn._launch, fn._reference, {"eps": eps}, *tensors)
    assert launched == [eps]
    assert applied.call_count == (mode == "grad")
    assert (out.grad_fn is not None) == (mode == "grad")
    if mode == "grad":
        up = torch.from_numpy(_arrays((4, 5, 16), 6)[0])
        (grad,) = torch.autograd.grad((out * up).sum(), x)
        ref_x = x.detach().clone().requires_grad_()
        (ref,) = torch.autograd.grad((fn._reference(ref_x, *tensors[1:], eps) * up).sum(),
                                     ref_x)
        torch.testing.assert_close(grad, ref, rtol=0, atol=0)


def test_plain_versions_pass_gradcheck():
    rng = np.random.default_rng(4)
    x, w, b = (torch.from_numpy(rng.normal(size=s)).requires_grad_()
               for s in ((3, 8), (8,), (8,)))
    assert torch.autograd.gradcheck(
        lambda x, w, b: fused_layer_norm_reference(x, w, b, 1e-5), (x, w, b))
    assert torch.autograd.gradcheck(
        lambda x, w: fused_rms_norm_reference(x, w, 1e-8), (x, w))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# (function, rows, D): the path's shapes at one replan (Voltron, B=1) and at
# B=128 per scope (Voltron 256 images, CLIP vision 128, CLIP text 128 goals,
# foresight decoder 128 x (4 context + 98 patch tokens)); then every layout
# of the kernel's dispatch (lanes a row x 16-byte vectors a lane, bf16 /
# f32): D=8 1x1 / 2x1, 24 1x3 / 2x3, 32 4x1 / 8x1, 64 8x1 / 16x1, 96 4x3 /
# 8x3, 128 16x1 / 32x1, 192 8x3 / 16x3, 256 32x1 / 32x2, 384 16x3 / 32x3,
# 512 32x2 / 32x4, 768 32x3 / 32x6, the widest 32x8 / 32x8; 40 (2x3 / 4x3)
# and 1000 (32x4 / 32x8), where no split is exact and some slots idle; at
# 1 row, 7, 393 and 12,545 (ragged against any rows a warp or a block)
WIDEST = "widest"  # 2048 in bf16, 1024 in f32
CUDA_SHAPES = [("rms", 392, 384), ("rms", 50176, 384), ("ln", 25216, 768),
               ("ln", 9856, 512), ("rms", 13056, 192)] + [
    (kind, rows, D) for D in (8, 24, 32, 64, 96, 128, 192, 256, 384, 512, 768, WIDEST, 40,
                              1000)
    for rows in (1, 7, 393, 12545) for kind in ("ln", "rms")]
CUDA_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _cuda_inputs(rows, D, dtype, seed):
    _need_card()
    gen = torch.Generator("cuda").manual_seed(seed)
    x = (torch.randn((rows, D), generator=gen, device="cuda") * 3).to(dtype)
    w = torch.randn((D,), generator=gen, device="cuda").to(dtype)
    b = torch.randn((D,), generator=gen, device="cuda").to(dtype)
    return x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("kind,rows,D", CUDA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(kind, rows, D, dtype):
    """The kernel against its plain version on the card at the path's
    shapes and at every layout; bound relative to max(1, max|ref|) (one
    bf16 rounding)."""
    if D == WIDEST:
        D = {torch.float32: 1024, torch.bfloat16: 2048}[dtype]
    x, w, b = _cuda_inputs(rows, D, dtype, 0)
    counter = fused_rms_norm if kind == "rms" else fused_layer_norm
    before = counter.launches
    if kind == "rms":
        out, ref = fused_rms_norm(x, w), fused_rms_norm_reference(x, w, 1e-8)
    else:
        out, ref = fused_layer_norm(x, w, b), fused_layer_norm_reference(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert out.dtype == dtype
    bound = CUDA_TOL[dtype] * max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,layout", [
    (torch.bfloat16, 384, (16, 3)), (torch.bfloat16, 192, (8, 3)),
    (torch.bfloat16, 512, (32, 2)), (torch.bfloat16, 768, (32, 3)),
    (torch.float32, 384, (32, 3)), (torch.float32, 192, (16, 3)),
    (torch.float32, 512, (32, 4)), (torch.float32, 768, (32, 6))])
def test_cuda_path_widths_split_evenly(dtype, D, layout):
    """At the path's widths every lane holds the same number of 16-byte
    vectors: (lanes a row, vectors a lane). The widest row is the old
    kernel's, and one wider raises."""
    _need_card()
    plan = fn.launch_plan(392, D, dtype)
    assert (plan["lanes"], plan["vectors_per_lane"]) == layout
    widest = {torch.float32: 1024, torch.bfloat16: 2048}[dtype]
    assert fn._kernels()[2][dtype] == widest
    x, w, _ = _cuda_inputs(2, widest + 8, dtype, 0)
    with pytest.raises(ValueError, match="row width"):
        fused_rms_norm(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [392, 12544, 50176])
def test_cuda_grid_spreads_few_rows_and_stages_many(rows):
    """One step of rows a warp. Rows that fill the card's warps at most once
    spread over the SMs in blocks of few warps; more rows take blocks of 8
    warps, the path of many rows."""
    _need_card()
    plan = fn.launch_plan(rows, 384, torch.bfloat16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warp_steps = -(-rows // (32 // plan["lanes"]))
    assert plan["blocks"] == -(-warp_steps // plan["warps_per_block"])
    if rows == 392:
        assert not plan["many_rows"]
        assert plan["blocks"] <= sms and plan["warps_per_block"] < 8
    else:
        assert plan["many_rows"] and plan["warps_per_block"] == 8


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [393, 12545])  # the paths of few and of many rows
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rms_norm_clamps_zero_rows(dtype, rows):
    """All-zero rows (the clamp's branch) come out 0 on the card, not NaN,
    beside rows below eps and ordinary rows, as the plain version."""
    x, w, _ = _cuda_inputs(rows, 384, dtype, 5)
    x[::3] = 0
    x[1::6] = 1e-12
    out, ref = fused_rms_norm(x, w), fused_rms_norm_reference(x, w, 1e-8)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and (out[::3] == 0).all()
    bound = CUDA_TOL[dtype] * max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_cuda_misaligned_input_raises(kind):
    """An input whose start is not 16-byte aligned (a contiguous view one
    element into its storage) raises instead of launching."""
    x, w, b = _cuda_inputs(8, 65, torch.bfloat16, 6)
    x = x.flatten()[1:513].view(8, 64)
    w, b = w[:64].contiguous(), b[:64].contiguous()
    with pytest.raises(RuntimeError, match="16-byte aligned"):
        fused_layer_norm(x, w, b) if kind == "ln" else fused_rms_norm(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_cuda_kernel_matches_float64_norm(kind):
    """The f32 kernel against the norm computed in float64 on the card, an
    oracle that shares no summation order with the kernel. Bound: f32
    rounding of a 384-term sum and of the affine step, ~1e-6 relative on
    outputs of order 1-10."""
    x, w, b = _cuda_inputs(50176, 384, torch.float32, 1)
    xd, wd, bd = x.double(), w.double(), b.double()
    if kind == "rms":
        out = fused_rms_norm(x, w)
        ref = xd / (xd.norm(dim=-1, keepdim=True) * 384 ** -0.5).clamp_min(1e-8) * wd
    else:
        out = fused_layer_norm(x, w, b)
        ref = torch.nn.functional.layer_norm(xd, (384,), wd, bd, 1e-5)
    torch.cuda.synchronize()
    assert (out.double() - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_cuda_light_launch_records_no_autograd_graph(kind):
    """Under no_grad, and on inputs that need no gradient, the kernel's
    output carries no grad_fn; with an input that needs one,
    PlainBackward's."""
    x, w, b = _cuda_inputs(392, 384, torch.bfloat16, 4)
    call = (lambda x: fused_layer_norm(x, w, b)) if kind == "ln" \
        else (lambda x: fused_rms_norm(x, w))
    assert call(x).grad_fn is None
    x.requires_grad_()
    with torch.no_grad():
        assert call(x).grad_fn is None
    assert call(x).grad_fn is not None


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ln", "rms"])
def test_cuda_gradient_through_kernel(kind):
    """Gradients through the kernel's autograd Function equal autograd
    through the plain version on the card (decoder width, f32 master
    weights cast to bf16 as the foresight decoder does)."""
    x0, w0, b0 = _cuda_inputs(13056, 192, torch.float32, 2)
    up = torch.randn(x0.shape, generator=torch.Generator("cuda").manual_seed(3),
                     device="cuda").bfloat16()
    grads = []
    for norm in ("kernel", "plain"):
        x = x0.bfloat16().requires_grad_()
        w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
        if kind == "rms":
            fun = fused_rms_norm if norm == "kernel" else \
                lambda x, g: fused_rms_norm_reference(x, g, 1e-8)
            y = fun(x, w.bfloat16())
        else:
            fun = fused_layer_norm if norm == "kernel" else \
                lambda x, w, b: fused_layer_norm_reference(x, w, b, 1e-5)
            y = fun(x, w.bfloat16(), b.bfloat16())
        (y.float() * up.float()).sum().backward()
        grads.append([x.grad.float(), w.grad] + ([b.grad] if kind == "ln" else []))
    for k, p in zip(*grads):
        scale = max(1.0, p.abs().max().item())
        assert (k - p).abs().max().item() <= 8e-3 * scale
