"""The norm pass and the tile GEMM that kernels B4 and B5 are made of
(`csrc/halfblock_gemm.cu`):

    halfblock_norm(x, g, b, norm, eps)                   norm(x), once a row
    halfblock_gemm(a, w, bias, epilogue, res, gamma)     epilogue(a @ w.T)

with the epilogues "bias" (+ bias), "quickgelu" (+ bias, h * sigmoid(1.702 h)),
"swishglu" (w packs [proj | gate], 2 N rows: proj * silu(gate)) and
"residual" (res + [gamma *] (. + bias)). `ops/attention_halfblock.py` (B4)
and `ops/mlp_halfblock.py` (B5) chain them on one stream; their plain
versions, composed the same way, give B4's and B5's plain versions bit for
bit, which pins the rounding contract the CUDA kernels follow: RMS divides by
the bf16 norm and then multiplies g; LayerNorm takes f32 statistics and
rounds each step; each product accumulates in f32, is rounded to the input
dtype, and then the bias is added; every later step rounds in the input
dtype.

On a CUDA tensor (bf16) `halfblock_norm` and `halfblock_gemm` launch their
kernel, one launch counted in their `.launches`, or raise; on a CPU tensor
they run the plain version. They serve the measurements and the tests of
the GEMM alone; B4 and B5 launch through `launch_norm` and `launch_gemm`,
which count nothing (the half-block's wrapper counts its call).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from ._plain_backward import launch_with_plain_backward

__all__ = ["EPILOGUES", "NORMS", "halfblock_gemm", "halfblock_gemm_reference",
           "halfblock_norm", "halfblock_norm_reference", "dot_reference",
           "check_gemm_shapes", "check_tensors"]

NORMS = ("rms", "ln")
EPILOGUES = ("bias", "quickgelu", "swishglu", "residual")  # the kernel's ids 0..3
GEMM_COLS = 128        # rows of w a tile reads (its output columns, or 64 of each
                       # half for "swishglu"); kBN
GEMM_DEPTH = 64        # depth of a pipeline stage; kBK
NORM_MAX_WIDTH = 1024  # the norm pass holds a row in registers; kNormVecs * 256


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 accumulation for f32/bf16 inputs; float64 stays float64."""
    return torch.promote_types(x.dtype, torch.float32)


def halfblock_norm_reference(x: torch.Tensor, g: torch.Tensor, b: Optional[torch.Tensor],
                             norm: str, eps: float) -> torch.Tensor:
    """The JAX package's `_norm` (ops/attention_halfblock.py:43-54)."""
    xf = x.to(_acc_dtype(x))
    if norm == "rms":
        r = torch.linalg.vector_norm(xf, dim=-1, keepdim=True) * x.shape[-1] ** -0.5
        return (x / r.clamp_min(eps).to(x.dtype)) * g
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * g
    return y + b if b is not None else y


def dot_reference(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T for a torch Linear weight w (N, K), accumulated in f32 and
    rounded to the dtype of `a` (the JAX package's `_dot`)."""
    acc = _acc_dtype(a)
    return torch.matmul(a.to(acc), w.to(acc).T).to(a.dtype)


def halfblock_gemm_reference(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                             epilogue: str, res: Optional[torch.Tensor] = None,
                             gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the GEMM: epilogue(a @ w.T + bias), the rounding
    points of the JAX package's `_reference`s."""
    h = dot_reference(a, w) + bias
    if epilogue == "quickgelu":
        return h * torch.sigmoid(1.702 * h)
    if epilogue == "swishglu":
        proj, gate = h.chunk(2, dim=-1)
        return proj * (gate * torch.sigmoid(gate))
    if epilogue == "residual":
        return res + (h * gamma if gamma is not None else h)
    return h


def check_gemm_shapes(name: str, widths, tensors, norm_width: Optional[int] = None) -> None:
    """What the CUDA kernels take: each {label: (width, multiple)} a positive
    multiple, the normalized width at most NORM_MAX_WIDTH, every tensor
    16-byte aligned (TMA and the 16-byte epilogue loads)."""
    for label, (width, multiple) in widths.items():
        if width <= 0 or width % multiple:
            raise ValueError(f"{name}: {label}={width} is not a multiple of {multiple}")
    if norm_width is not None and norm_width > NORM_MAX_WIDTH:
        raise ValueError(f"{name}: the norm pass takes widths up to {NORM_MAX_WIDTH}, "
                         f"got {norm_width}")
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: inputs and weights must be 16-byte aligned")


@functools.cache
def _kernels():
    """The ctypes functions of `csrc/halfblock_gemm.cu`, built, loaded and
    typed once per process."""
    lib = _build.load_library("halfblock_gemm")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    norm, gemm = lib.mdt_halfblock_norm, lib.mdt_halfblock_gemm
    norm.argtypes = [ptr] * 4 + [i] * 3 + [ctypes.c_float, ptr]
    gemm.argtypes = [ptr] * 6 + [i] * 4 + [ptr]
    norm.restype = gemm.restype = i
    return norm, gemm


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch_norm(x, g, b, out, norm: str, eps: float, stream: int) -> None:
    """halfblock_norm of the rows of `x` into `out`; no count, no checks
    beyond the kernel's own (the caller's)."""
    C = x.shape[-1]
    rc = _kernels()[0](x.data_ptr(), g.data_ptr(), _ptr(b), out.data_ptr(), x.numel() // C, C,
                       int(norm == "ln"), eps, stream)
    if rc != 0:
        raise RuntimeError(f"halfblock_norm: CUDA launch failed with error {rc} for x "
                           f"{tuple(x.shape)}, norm={norm}")


def launch_gemm(a, w, bias, out, epilogue: str, res, gamma, stream: int) -> None:
    """halfblock_gemm of `a` into `out`; no count, no checks beyond the
    kernel's own (the caller's)."""
    K, n_out = a.shape[-1], out.shape[-1]
    rc = _kernels()[1](a.data_ptr(), w.data_ptr(), bias.data_ptr(), _ptr(res), _ptr(gamma),
                       out.data_ptr(), a.numel() // K, K, n_out, EPILOGUES.index(epilogue),
                       stream)
    if rc != 0:
        raise RuntimeError(f"halfblock_gemm: CUDA launch failed with error {rc} for a "
                           f"{tuple(a.shape)}, w {tuple(w.shape)}, epilogue={epilogue}")


def check_tensors(name: str, x: torch.Tensor, shapes) -> None:
    """x on the CPU or CUDA (bf16 there, f32 or bf16 on the CPU); every
    tensor of `shapes` ({label: (tensor or None, expected shape)}) in x's
    dtype, on x's device, contiguous, of its shape."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    allowed = (torch.bfloat16,) if x.is_cuda else (torch.float32, torch.bfloat16)
    for label, (t, shape) in shapes.items():
        if t is None:
            continue
        if t.dtype not in allowed:
            raise TypeError(f"{name}: {label} is {t.dtype}; on {x.device.type} the "
                            f"half-block kernels take {allowed}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: {label} in {t.dtype}, x in {x.dtype}; cast the "
                            "weights to the input's dtype")
        if t.device != x.device:
            raise ValueError(f"{name}: {label} on {t.device}, x on {x.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def _norm_launch(x, g, b, *, norm: str, eps: float) -> torch.Tensor:
    check_gemm_shapes("halfblock_norm", {"C": (x.shape[-1], 8)}, (x, g, b),
                      norm_width=x.shape[-1])
    out = torch.empty_like(x)
    launch_norm(x, g, b, out, norm, eps, _build.current_stream(x))
    _build.count_launch(halfblock_norm)
    return out


def halfblock_norm(x: torch.Tensor, g: torch.Tensor, b: Optional[torch.Tensor],
                   norm: str = "rms", eps: float = 1e-8) -> torch.Tensor:
    """x (..., C) -> norm(x), "rms" (b None) or "ln". CUDA tensors (bf16)
    launch the norm pass; CPU tensors run the plain version."""
    if norm not in NORMS or (norm == "rms" and b is not None):
        raise ValueError(f"halfblock_norm: norm {norm!r} with bias {b is not None}")
    C = x.shape[-1]
    check_tensors("halfblock_norm", x, {"x": (x, x.shape), "g": (g, (C,)), "b": (b, (C,))})
    if x.is_cpu:
        return halfblock_norm_reference(x, g, b, norm, eps)
    return launch_with_plain_backward(_norm_launch, halfblock_norm_reference,
                                      {"norm": norm, "eps": eps}, x, g, b)


def _gemm_launch(a, w, bias, res, gamma, *, epilogue: str) -> torch.Tensor:
    K, n_w = a.shape[-1], w.shape[0]
    n_out = n_w // 2 if epilogue == "swishglu" else n_w
    # a tile reads 128 rows of w: 128 output columns, or 64 proj and 64 gate rows
    check_gemm_shapes("halfblock_gemm", {"K": (K, GEMM_DEPTH), "rows of w": (n_w, GEMM_COLS)},
                      (a, w, bias, res, gamma))
    out = torch.empty((*a.shape[:-1], n_out), dtype=a.dtype, device=a.device)
    launch_gemm(a, w, bias, out, epilogue, res, gamma, _build.current_stream(a))
    _build.count_launch(halfblock_gemm)
    return out


def _gemm_reference(a, w, bias, res, gamma, *, epilogue: str) -> torch.Tensor:
    return halfblock_gemm_reference(a, w, bias, epilogue, res, gamma)


def halfblock_gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, epilogue: str,
                   res: Optional[torch.Tensor] = None,
                   gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a (..., K) -> epilogue(a @ w.T + bias) (..., N); w (N, K), or (2 N, K)
    [proj | gate] for "swishglu"; res (..., N) and gamma (N,) or None for
    "residual". CUDA tensors (bf16) launch the GEMM; CPU tensors run the
    plain version."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"halfblock_gemm: epilogue must be one of {EPILOGUES}, "
                         f"got {epilogue!r}")
    if (res is not None) != (epilogue == "residual") or (gamma is not None and res is None):
        raise ValueError("halfblock_gemm: res (and gamma) go with the residual epilogue only")
    if w.ndim != 2:
        raise ValueError(f"halfblock_gemm: w must be (N, K), got {tuple(w.shape)}")
    n_w, K = w.shape
    n_out = n_w // 2 if epilogue == "swishglu" else n_w
    check_tensors("halfblock_gemm", a, {
        "a": (a, (*a.shape[:-1], K)), "w": (w, (n_w, K)), "bias": (bias, (n_w,)),
        "res": (res, (*a.shape[:-1], n_out)), "gamma": (gamma, (n_out,))})
    if a.is_cpu:
        return halfblock_gemm_reference(a, w, bias, epilogue, res, gamma)
    return launch_with_plain_backward(_gemm_launch, _gemm_reference, {"epilogue": epilogue},
                                      a, w, bias, res, gamma)


halfblock_norm.launches = 0
halfblock_gemm.launches = 0
