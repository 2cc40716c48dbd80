"""Multi-head attention straight off the packed qkv projection (kernel B1).

Port of the Pallas TPU kernel `mdt_policy_tpu/ops/fused_qkv_attention.py`
(`fused_qkv_attention`, kernels `_kernel` and `_kernel_pair`). It reads the
`(B, T, 3C)` output of a fused qkv Dense, laid out `[q | k | v]` with heads
interleaved, and writes the `(B, T, C)` head-concatenated attention output
that the out-projection takes.

On a CUDA tensor the wrapper launches the hand-written kernel in
`csrc/fused_qkv_attention.cu` (built with nvcc at first use, see `_build.py`)
or raises; on a CPU tensor it runs `fused_qkv_attention_reference`, the
plain PyTorch version of the same math. The kernel has two bodies under one
contract: `_sm90_body` sends bf16 calls with 64-wide heads and T <= 208 (every
tower call) to the tensor-core body `csrc/attention_sm90.cuh`, and every
other call (f32, other head widths) to `csrc/mha_core.cuh`. The backward,
like the TPU kernel's custom VJP, goes through the plain version; the frozen
towers never need it. A call that autograd does not record (under
`no_grad`, or on a qkv that needs no gradient) launches the kernel directly,
with no autograd Function, on the current stream and with no device
context; the ctypes functions are typed once. The two tensor maps are
encoded at each call: they hold qkv's address.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._plain_backward import launch_with_plain_backward

__all__ = ["fused_qkv_attention", "fused_qkv_attention_reference"]

_MAX_SMEM_PER_BLOCK = 232_448  # bytes of shared memory a Hopper block may use
SM90_HEAD_DIM = 64   # head width of the tensor-core body (attention_sm90.cuh)
SM90_MAX_SEQ = 208   # longest T it takes: 13 steps of 16 keys held in registers


def fused_qkv_attention_reference(qkv: torch.Tensor, n_heads: int,
                                  causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 scores scaled by dh^-0.5,
    causal mask at finfo(f32).min, f32 softmax, probabilities cast to the
    input dtype, P.V accumulated in f32 and cast to the input dtype (the math
    of the TPU kernel `_kernel`; at f32 it equals its einsum `_reference`).
    A float64 input stays in float64 throughout."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    dh = C // n_heads
    acc = torch.promote_types(qkv.dtype, torch.float32)
    q, k, v = (t.reshape(B, T, n_heads, dh).transpose(1, 2).to(acc)
               for t in qkv.split(C, dim=-1))
    scores = torch.matmul(q, k.transpose(-1, -2)) * dh ** -0.5
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=qkv.device).tril()
        scores = scores.masked_fill(~keep, torch.finfo(acc).min)
    probs = torch.softmax(scores, dim=-1).to(qkv.dtype)
    out = torch.matmul(probs.to(acc), v)
    return out.transpose(1, 2).reshape(B, T, C).to(qkv.dtype)


def _check(qkv: torch.Tensor, n_heads: int) -> None:
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_qkv_attention: unsupported device {qkv.device}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_qkv_attention: dtype {qkv.dtype} is not "
                        "float32 or bfloat16")
    if qkv.ndim != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"fused_qkv_attention: qkv must be (B, T, 3C), "
                         f"got {tuple(qkv.shape)}")
    C = qkv.shape[-1] // 3
    if n_heads <= 0 or C % n_heads:
        raise ValueError(f"fused_qkv_attention: C={C} is not divisible by "
                         f"n_heads={n_heads}")
    if not qkv.is_contiguous():
        raise ValueError("fused_qkv_attention: qkv must be contiguous")
    if qkv.device.type == "cuda" and _sm90_body(qkv.dtype, qkv.shape[1], C, n_heads) \
            and qkv.data_ptr() % 16:
        raise ValueError("fused_qkv_attention: the tensor-core body reads qkv in "
                         "16-byte pieces; its base address must be 16-byte aligned")


def _sm90_body(dtype: torch.dtype, T: int, C: int, n_heads: int) -> bool:
    """Whether a call runs the tensor-core body (`csrc/attention_sm90.cuh`):
    bf16, 64-wide heads, 1 <= T <= 208. Its rows (3C bf16 = 384 H bytes) are
    then 16-byte multiples; the base address is `_check`'s. Every other
    call runs `csrc/mha_core.cuh`."""
    return (dtype == torch.bfloat16 and n_heads > 0 and C == SM90_HEAD_DIM * n_heads
            and 1 <= T <= SM90_MAX_SEQ)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("fused_qkv_attention")
    lib.mdt_fused_qkv_attention.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.mdt_fused_qkv_attention.restype = ctypes.c_int
    lib.mdt_fused_qkv_attention_smem_bytes.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.mdt_fused_qkv_attention_smem_bytes.restype = ctypes.c_size_t
    lib.mdt_fused_qkv_attention_sm90.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.mdt_fused_qkv_attention_sm90.restype = ctypes.c_int
    return lib


def _launch(qkv: torch.Tensor, n_heads: int, causal: bool) -> torch.Tensor:
    B, T, C3 = qkv.shape
    C = C3 // 3
    lib = _library()
    # the tensor-core body's persistent grid takes any batch, and its shared
    # memory (at most 173,088 bytes at T <= 208) always fits
    sm90 = _sm90_body(qkv.dtype, T, C, n_heads)
    is_bf16 = int(qkv.dtype == torch.bfloat16)
    if not sm90:
        if B > 65535:
            raise ValueError(f"fused_qkv_attention: batch {B} exceeds the grid's "
                             "z limit of 65535")
        smem = lib.mdt_fused_qkv_attention_smem_bytes(T, C, n_heads, is_bf16)
        if smem > _MAX_SMEM_PER_BLOCK:
            raise ValueError(f"fused_qkv_attention: T={T}, dh={C // n_heads} needs "
                             f"{smem} bytes of shared memory per block, over "
                             f"{_MAX_SMEM_PER_BLOCK}")
    out = torch.empty((B, T, C), dtype=qkv.dtype, device=qkv.device)
    stream = _build.current_stream(qkv)
    if sm90:
        rc = lib.mdt_fused_qkv_attention_sm90(qkv.data_ptr(), out.data_ptr(), B, T, C,
                                              n_heads, int(causal), stream)
    else:
        rc = lib.mdt_fused_qkv_attention(qkv.data_ptr(), out.data_ptr(), B, T, C,
                                         n_heads, int(causal), is_bf16, stream)
    if rc != 0:
        raise RuntimeError(f"fused_qkv_attention: CUDA launch failed with "
                           f"error {rc} for qkv {tuple(qkv.shape)} "
                           f"{qkv.dtype}, n_heads={n_heads}")
    _build.count_launch(fused_qkv_attention)
    return out


def fused_qkv_attention(qkv: torch.Tensor, n_heads: int,
                        causal: bool = False) -> torch.Tensor:
    """Attention over the packed projection: qkv (B, T, 3C) -> (B, T, C).

    CUDA tensors run the kernel (and count one launch in
    `fused_qkv_attention.launches`), through `PlainBackward` only where
    autograd wants a gradient; CPU tensors run the plain version."""
    _check(qkv, n_heads)
    if qkv.device.type == "cpu":
        return fused_qkv_attention_reference(qkv, n_heads, causal)
    return launch_with_plain_backward(_launch, fused_qkv_attention_reference,
                                      {"n_heads": n_heads, "causal": causal}, qkv)


fused_qkv_attention.launches = 0
