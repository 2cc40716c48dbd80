"""Row LayerNorm and RMSNorm in one pass (kernel B3).

Port of the Pallas TPU kernels `mdt_policy_tpu/ops/fused_norm.py`
(`fused_layer_norm` / `_ln_kernel`, `fused_rms_norm` / `_rms_kernel`): the
statistics of each row of width D are taken in f32 (LayerNorm mean and
variance, or the L2 norm), the affine step is done in f32, and the result is
cast once to the input dtype.

  fused_layer_norm  == flax nn.LayerNorm(eps): the CLIP towers' ln_*
                       (eps 1e-5) and Voltron's encoder_norm (eps 1e-6)
  fused_rms_norm    == x / max(||x||_2 * D^-1/2, eps) * g: the RMSNorm of
                       the Voltron and foresight-decoder blocks (eps 1e-8)

On a CUDA tensor the wrapper launches the hand-written kernel in
`csrc/fused_norm.cu` (built with nvcc at first use, see `_build.py`) or
raises; on a CPU tensor it runs the plain PyTorch version of the same math.
The backward, like the TPU kernels' custom VJPs, differentiates the plain
version; the foresight decoder trains through it. A call that autograd does
not record (under `no_grad`, or on inputs that need no gradient) launches
the kernel directly, with no autograd Function around it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from ._plain_backward import launch_with_plain_backward

__all__ = ["fused_layer_norm", "fused_layer_norm_reference", "fused_rms_norm",
           "fused_rms_norm_reference", "launch_plan"]


_DTYPES = (torch.float32, torch.bfloat16)


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 statistics for f32/bf16 inputs; float64 stays float64 (gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def fused_layer_norm_reference(x: torch.Tensor, w: torch.Tensor,
                               b: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain version (the TPU package's `_ln_reference`)."""
    xf = x.to(_stat_dtype(x))
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * w.to(xf.dtype) + b.to(xf.dtype)).to(x.dtype)


def fused_rms_norm_reference(x: torch.Tensor, g: torch.Tensor,
                             eps: float) -> torch.Tensor:
    """Plain version (the TPU package's `_rms_reference`)."""
    xf = x.to(_stat_dtype(x))
    norm = torch.linalg.vector_norm(xf, dim=-1, keepdim=True) * x.shape[-1] ** -0.5
    return (xf / norm.clamp_min(eps) * g.to(xf.dtype)).to(x.dtype)


def _check(name: str, x: torch.Tensor, *weights: torch.Tensor) -> None:
    if not (x.is_cuda or x.is_cpu):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} is not float32 or bfloat16")
    if x.ndim == 0 or x.shape[-1] % 8:
        raise ValueError(f"{name}: the row width must be a multiple of 8, "
                         f"got shape {tuple(x.shape)}")
    D, dtype, device = x.shape[-1], x.dtype, x.device
    for t in weights:
        if t.dtype is not dtype:
            raise TypeError(f"{name}: weights in {[t.dtype for t in weights]}, input "
                            f"in {x.dtype}; cast the weights to the input's dtype")
        if t.device != device:
            raise ValueError(f"{name}: weights on {t.device}, input on {x.device}")
        if t.ndim != 1 or t.shape[0] != D:
            raise ValueError(f"{name}: weight shape {tuple(t.shape)}, expected ({D},)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: weights must be contiguous")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the input must be contiguous")


@functools.cache
def _kernels():
    """The ctypes functions of `csrc/fused_norm.cu` (LayerNorm, RMSNorm), the
    widest row each input dtype takes and the launch plan's function, built,
    loaded and typed once per process."""
    lib = _build.load_library("fused_norm")
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    layer_norm, rms_norm = lib.mdt_fused_layer_norm, lib.mdt_fused_rms_norm
    layer_norm.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_longlong, i, f, i, ptr]
    rms_norm.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, i, f, i, ptr]
    layer_norm.restype = rms_norm.restype = ctypes.c_int
    lib.mdt_fused_norm_max_width.argtypes = [i]
    lib.mdt_fused_norm_max_width.restype = i
    lib.mdt_fused_norm_plan.argtypes = [ctypes.c_longlong, i, i,
                                        ctypes.POINTER(ctypes.c_longlong)]
    lib.mdt_fused_norm_plan.restype = i
    max_width = {dt: lib.mdt_fused_norm_max_width(int(dt == torch.bfloat16))
                 for dt in (torch.float32, torch.bfloat16)}
    return layer_norm, rms_norm, max_width, lib.mdt_fused_norm_plan


def launch_plan(rows: int, D: int, dtype: torch.dtype) -> dict:
    """How the kernel runs a call on (rows, D) rows of `dtype` on the current
    CUDA device, LayerNorm or RMSNorm: lanes a row, 16-byte vectors a lane,
    blocks, warps a block, and whether it takes the path of many rows (no
    thread holds the weights while its rows are in flight) or of few (the
    weights loaded into registers beside the rows)."""
    plan = (ctypes.c_longlong * 5)()
    rc = _kernels()[3](rows, D, int(dtype is torch.bfloat16), plan)
    if rc != 0:
        raise RuntimeError(f"fused_norm: no launch plan for ({rows}, {D}) {dtype} "
                           f"(error {rc})")
    return {"lanes": plan[0], "vectors_per_lane": plan[1], "blocks": plan[2],
            "warps_per_block": plan[3], "many_rows": bool(plan[4])}


def _launch(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
            eps: float) -> torch.Tensor:
    """One kernel launch: LayerNorm when `b` is given, else RMSNorm."""
    layer_norm, rms_norm, max_width, _ = _kernels()
    name = "fused_layer_norm" if b is not None else "fused_rms_norm"
    D = x.shape[-1]
    if D > max_width[x.dtype]:
        raise ValueError(f"{name}: row width {D} over the kernel's {max_width[x.dtype]}")
    out = torch.empty_like(x)
    rows, is_bf16, stream = x.numel() // D, x.dtype is torch.bfloat16, _build.current_stream(x)
    if rows == 0:
        return out
    if b is None:
        rc = rms_norm(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, D, eps, is_bf16,
                      stream)
    else:
        rc = layer_norm(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), rows, D,
                        eps, is_bf16, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} for x "
                           f"{tuple(x.shape)} {x.dtype} (error 1: an input or weight "
                           "not 16-byte aligned, or more rows than the grid holds)")
    _build.count_launch(fused_rms_norm if b is None else fused_layer_norm)
    return out


def _reference(x, w, b, eps):
    """The plain version of what `_launch(x, w, b, eps)` computes."""
    return fused_rms_norm_reference(x, w, eps) if b is None \
        else fused_layer_norm_reference(x, w, b, eps)


def fused_layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: x (..., D), w and b (D,) in the dtype of
    x; output in the dtype of x. CUDA tensors run the kernel (one launch, counted in
    `fused_layer_norm.launches`); CPU tensors run the plain version."""
    _check("fused_layer_norm", x, w, b)
    if x.is_cpu:
        return fused_layer_norm_reference(x, w, b, eps)
    return launch_with_plain_backward(_launch, _reference, {"eps": eps}, x, w, b)


def fused_rms_norm(x: torch.Tensor, g: torch.Tensor,
                   eps: float = 1e-8) -> torch.Tensor:
    """x / max(||x||_2 * D^-1/2, eps) * g over the last axis: x (..., D),
    g (D,) in the dtype of x; output in the dtype of x. CUDA tensors run the kernel (counted in
    `fused_rms_norm.launches`); CPU tensors run the plain version."""
    _check("fused_rms_norm", x, g)
    if x.is_cpu:
        return fused_rms_norm_reference(x, g, eps)
    return launch_with_plain_backward(_launch, _reference, {"eps": eps}, x, g, None)


fused_layer_norm.launches = 0
fused_rms_norm.launches = 0
