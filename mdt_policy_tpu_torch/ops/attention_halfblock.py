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

On a CUDA tensor the wrapper launches four kernels on the current stream
(`ops/halfblock_gemm.py`, `csrc/halfblock_gemm.cu`: the norm pass, once a
row, and the qkv GEMM with its bias epilogue; `csrc/attention_halfblock.cu`:
the attention core; the projection GEMM with its residual epilogue) or
raises; the kernels take bf16 only. The attention core runs the body B1
would run for the same call (`fused_qkv_attention._sm90_body`). On a CPU
tensor it runs the plain version. The backward is autograd through the
plain version, like the TPU kernel's custom VJP; a call that autograd does
not record (under `no_grad`, or on the frozen towers' weights) launches the
kernels directly, with no autograd Function around them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from ._plain_backward import launch_with_plain_backward
from .fused_qkv_attention import _sm90_body, fused_qkv_attention_reference
from .halfblock_gemm import (GEMM_COLS, NORMS, check_gemm_shapes, check_tensors,
                             dot_reference, halfblock_norm_reference, launch_gemm,
                             launch_norm)

__all__ = ["attention_halfblock", "attention_halfblock_reference", "check_halfblock"]

_MAX_SMEM_PER_BLOCK = 232_448  # bytes of shared memory a Hopper block may use


def attention_halfblock_reference(x, g, b, w_qkv, b_qkv, w_proj, b_proj, gamma,
                                  n_heads: int, norm: str = "rms", eps: float = 1e-8,
                                  causal: bool = False) -> torch.Tensor:
    """Plain version of the kernel (the JAX `_reference`, :107-129, with the
    attention core of the Pallas `_kernel`)."""
    xn = halfblock_norm_reference(x, g, b, norm, eps)
    qkv = dot_reference(xn, w_qkv) + b_qkv
    att = fused_qkv_attention_reference(qkv, n_heads, causal)
    proj = dot_reference(att, w_proj) + b_proj
    if gamma is not None:
        proj = proj * gamma
    return x + proj


def check_halfblock(name: str, x: torch.Tensor, norm: str, b, shapes) -> None:
    """Checks shared by B4 and B5: x (B, T, C), the norm's bias only with
    "ln", and `check_tensors` on x and `shapes`."""
    if x.ndim != 3:
        raise ValueError(f"{name}: x must be (B, T, C), got {tuple(x.shape)}")
    if norm not in NORMS:
        raise ValueError(f"{name}: norm must be one of {NORMS}, got {norm!r}")
    if norm == "rms" and b is not None:
        raise ValueError(f"{name}: the RMS norm takes no bias")
    check_tensors(name, x, {"x": (x, tuple(x.shape)), **shapes})


@functools.cache
def _attention():
    """The ctypes functions of `csrc/attention_halfblock.cu` (the attention
    core), built, loaded and typed once per process."""
    lib = _build.load_library("attention_halfblock")
    i = ctypes.c_int
    core, smem = lib.mdt_halfblock_attention, lib.mdt_halfblock_attention_smem_bytes
    core.argtypes = [ctypes.c_void_p] * 2 + [i] * 6 + [ctypes.c_void_p]
    core.restype = i
    smem.argtypes = [i] * 4
    smem.restype = ctypes.c_size_t
    return core, smem


def _launch(x, g, b, w_qkv, b_qkv, w_proj, b_proj, gamma, *, n_heads: int,
            norm: str, eps: float, causal: bool) -> torch.Tensor:
    B, T, C = x.shape
    check_gemm_shapes("attention_halfblock", {"C": (C, GEMM_COLS)},
                      (x, g, b, w_qkv, b_qkv, w_proj, b_proj, gamma), norm_width=C)
    if B > 65535:
        raise ValueError(f"attention_halfblock: batch {B} exceeds the grid's z limit")
    core, core_smem = _attention()
    sm90 = int(_sm90_body(x.dtype, T, C, n_heads))  # B1's routing of the attention core
    smem = core_smem(T, C, n_heads, sm90)
    if smem > _MAX_SMEM_PER_BLOCK:
        raise ValueError(f"attention_halfblock: T={T}, dh={C // n_heads} needs {smem} "
                         f"bytes of shared memory per block, over {_MAX_SMEM_PER_BLOCK}")
    stream = _build.current_stream(x)
    xn = torch.empty_like(x)  # the normalized rows, then the attention output
    qkv = torch.empty((B, T, 3 * C), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    launch_norm(x, g, b, xn, norm, eps, stream)
    launch_gemm(xn, w_qkv, b_qkv, qkv, "bias", None, None, stream)
    rc = core(qkv.data_ptr(), xn.data_ptr(), B, T, C, n_heads, int(causal), sm90, stream)
    if rc != 0:
        raise RuntimeError(f"attention_halfblock: CUDA launch failed with error {rc} "
                           f"for x {tuple(x.shape)}, n_heads={n_heads}, norm={norm}")
    launch_gemm(xn, w_proj, b_proj, out, "residual", x, gamma, stream)
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
    run the kernels, one call counted in `attention_halfblock.launches`,
    through `PlainBackward` only where autograd wants a gradient; CPU
    tensors run the plain version."""
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
    return launch_with_plain_backward(_launch, attention_halfblock_reference, kwargs,
                                      *tensors)


attention_halfblock.launches = 0
