"""The attention half of a frozen tower block in one call (kernel B4):

    out = x + [gamma *] proj(attention(qkv(norm(x))))

Port of the Pallas TPU kernel `mdt_policy_tpu/ops/attention_halfblock.py`
(`attention_halfblock`, `_kernel`). The norm is RMS (Voltron: blocks.RMSNorm,
eps 1e-8, with the LayerScale `gamma`) or LayerNorm (CLIP: eps 1e-5, with its
bias, no `gamma`); `causal` masks the CLIP text tower. The weights are the
towers' own torch Linear weights: `w_qkv` (3C, C) packed [q | k | v] with
interleaved heads, `w_proj` (C, C).

The plain version, `attention_halfblock_reference`, rounds where the JAX
package does (`_norm` and `_dot`, :43-61): RMS divides by the bf16 norm in
the input dtype and then multiplies `g`; LayerNorm takes f32 statistics and
casts before `* g + b`; each product accumulates in f32, is rounded to the
input dtype, and then the bias is added; every later step rounds in the
input dtype. The attention core is B1's plain version (f32 scores, as the
Pallas kernel's `_kernel` computes them; the JAX `_reference` rounds the
scores to bf16 first, and at f32 the two agree).

On a CUDA tensor the wrapper launches `csrc/attention_halfblock.cu` (three
kernels: norm-prologue qkv GEMM, attention core, residual projection GEMM;
built with nvcc at first use) or raises; the kernels take bf16 only. The
attention core runs the body B1 would run for the same call
(`fused_qkv_attention._sm90_body`). On a
CPU tensor it runs the plain version. The backward is autograd through the
plain version, like the TPU kernel's custom VJP; the frozen towers never
need it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from ._plain_backward import PlainBackward
from .fused_qkv_attention import _sm90_body, fused_qkv_attention_reference

__all__ = ["attention_halfblock", "attention_halfblock_reference", "norm_reference",
           "dot_reference"]

_MAX_SMEM_PER_BLOCK = 232_448  # bytes of shared memory a Hopper block may use
_GEMM_ROWS = 128               # rows of one GEMM block (halfblock_gemm.cuh kBM)
_GEMM_COLS = 128               # output columns of one GEMM block (kBN)
_GEMM_DEPTH = 32               # K step of the GEMM (kBK)
NORMS = ("rms", "ln")


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 accumulation for f32/bf16 inputs; float64 stays float64."""
    return torch.promote_types(x.dtype, torch.float32)


def norm_reference(x: torch.Tensor, g: torch.Tensor, b: Optional[torch.Tensor],
                   norm: str, eps: float) -> torch.Tensor:
    """The JAX package's `_norm` (attention_halfblock.py:43-54)."""
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


def attention_halfblock_reference(x, g, b, w_qkv, b_qkv, w_proj, b_proj, gamma,
                                  n_heads: int, norm: str = "rms", eps: float = 1e-8,
                                  causal: bool = False) -> torch.Tensor:
    """Plain version of the kernel (the JAX `_reference`, :107-129, with the
    attention core of the Pallas `_kernel`)."""
    xn = norm_reference(x, g, b, norm, eps)
    qkv = dot_reference(xn, w_qkv) + b_qkv
    att = fused_qkv_attention_reference(qkv, n_heads, causal)
    proj = dot_reference(att, w_proj) + b_proj
    if gamma is not None:
        proj = proj * gamma
    return x + proj


def check_halfblock(name: str, x: torch.Tensor, norm: str, b, shapes) -> None:
    """Checks shared by B4 and B5: x (B, T, C) contiguous; every tensor of
    `shapes` ({label: (tensor or None, expected shape)}) on x's device, in
    x's dtype, contiguous, of its shape; the norm's bias only with "ln"."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.ndim != 3:
        raise ValueError(f"{name}: x must be (B, T, C), got {tuple(x.shape)}")
    if norm not in NORMS:
        raise ValueError(f"{name}: norm must be one of {NORMS}, got {norm!r}")
    if norm == "rms" and b is not None:
        raise ValueError(f"{name}: the RMS norm takes no bias")
    allowed = (torch.bfloat16,) if x.device.type == "cuda" else (torch.float32,
                                                                 torch.bfloat16)
    for label, (t, shape) in {"x": (x, tuple(x.shape)), **shapes}.items():
        if t is None:
            continue
        if t.dtype not in allowed:
            raise TypeError(f"{name}: {label} is {t.dtype}; on {x.device.type} the "
                            f"half-blocks take {allowed}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: {label} in {t.dtype}, x in {x.dtype}; cast the "
                            "weights to the input's dtype")
        if t.device != x.device:
            raise ValueError(f"{name}: {label} on {t.device}, x on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def check_gemm_shapes(name: str, x: torch.Tensor, widths, tensors) -> None:
    """What the CUDA GEMM takes: every output width a multiple of its block,
    every depth of its K step, rows within the grid, 16-byte alignment."""
    for label, (width, multiple) in widths.items():
        if width % multiple:
            raise ValueError(f"{name}: {label}={width} is not a multiple of {multiple}")
    if -(-x.shape[0] * x.shape[1] // _GEMM_ROWS) > 65535:
        raise ValueError(f"{name}: {x.shape[0] * x.shape[1]} rows exceed the grid")
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: inputs and weights must be 16-byte aligned")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("attention_halfblock")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.mdt_attention_halfblock.argtypes = [ptr] * 11 + [i] * 5 + [ctypes.c_float, i, i, ptr]
    lib.mdt_attention_halfblock.restype = i
    lib.mdt_attention_halfblock_smem_bytes.argtypes = [i, i, i, i]
    lib.mdt_attention_halfblock_smem_bytes.restype = ctypes.c_size_t
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(x, g, b, w_qkv, b_qkv, w_proj, b_proj, gamma, *, n_heads: int,
            norm: str, eps: float, causal: bool) -> torch.Tensor:
    B, T, C = x.shape
    check_gemm_shapes("attention_halfblock", x,
                      {"C": (C, _GEMM_COLS), "C (depth)": (C, _GEMM_DEPTH)},
                      (x, g, b, w_qkv, b_qkv, w_proj, b_proj, gamma))
    if B > 65535:
        raise ValueError(f"attention_halfblock: batch {B} exceeds the grid's z limit")
    lib = _library()
    sm90 = int(_sm90_body(x.dtype, T, C, n_heads))  # B1's routing of the attention core
    smem = lib.mdt_attention_halfblock_smem_bytes(T, C, n_heads, sm90)
    if smem > _MAX_SMEM_PER_BLOCK:
        raise ValueError(f"attention_halfblock: T={T}, dh={C // n_heads} needs {smem} "
                         f"bytes of shared memory per block, over {_MAX_SMEM_PER_BLOCK}")
    qkv = torch.empty((B, T, 3 * C), dtype=x.dtype, device=x.device)
    att = torch.empty_like(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mdt_attention_halfblock(
            x.data_ptr(), g.data_ptr(), _ptr(b), w_qkv.data_ptr(), b_qkv.data_ptr(),
            w_proj.data_ptr(), b_proj.data_ptr(), _ptr(gamma), qkv.data_ptr(),
            att.data_ptr(), out.data_ptr(), B, T, C, n_heads, int(norm == "ln"),
            eps, int(causal), sm90, stream)
    if rc != 0:
        raise RuntimeError(f"attention_halfblock: CUDA launch failed with error {rc} "
                           f"for x {tuple(x.shape)}, n_heads={n_heads}, norm={norm}")
    _build.count_launch(attention_halfblock)
    return out


def attention_halfblock(x: torch.Tensor, g: torch.Tensor, b: Optional[torch.Tensor],
                        w_qkv: torch.Tensor, b_qkv: torch.Tensor, w_proj: torch.Tensor,
                        b_proj: torch.Tensor, gamma: Optional[torch.Tensor],
                        n_heads: int, norm: str = "rms", eps: float = 1e-8,
                        causal: bool = False) -> torch.Tensor:
    """x (B, T, C) -> x + [gamma *] proj(attention(qkv(norm(x)))).

    g, b: the norm's gain and bias (b None for "rms"); w_qkv (3C, C) and
    w_proj (C, C) torch Linear weights with biases b_qkv (3C,), b_proj (C,);
    gamma (C,) or None. Every tensor in the dtype of x. CUDA tensors (bf16)
    run the kernels, one call counted in `attention_halfblock.launches`;
    CPU tensors run the plain version."""
    C = x.shape[-1]
    check_halfblock("attention_halfblock", x, norm, b, {
        "g": (g, (C,)), "b": (b, (C,)), "w_qkv": (w_qkv, (3 * C, C)),
        "b_qkv": (b_qkv, (3 * C,)), "w_proj": (w_proj, (C, C)),
        "b_proj": (b_proj, (C,)), "gamma": (gamma, (C,))})
    if n_heads <= 0 or C % n_heads:
        raise ValueError(f"attention_halfblock: C={C} is not divisible by "
                         f"n_heads={n_heads}")
    kwargs = dict(n_heads=n_heads, norm=norm, eps=eps, causal=causal)
    tensors = (x, g, b, w_qkv, b_qkv, w_proj, b_proj, gamma)
    if x.device.type == "cpu":
        return attention_halfblock_reference(*tensors, **kwargs)
    return PlainBackward.apply(_launch, attention_halfblock_reference, kwargs, *tensors)


attention_halfblock.launches = 0
