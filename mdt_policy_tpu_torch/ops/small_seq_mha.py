"""Self-attention over tiny sequences, T <= 32 (kernel B2).

Port of the Pallas TPU kernel `mdt_policy_tpu/ops/pallas_attention.py`
(`small_seq_mha`, kernel `_mha_kernel`): the denoisers' self-attention, the
encoder over 3-4 tokens and the causal decoder over 10 action tokens, at
every replan and validation step. q, k and v are (B, H, T, D) with equal
shapes; q is multiplied by D^-1/2 in its own dtype, the scores accumulate in
f32, the causal mask keeps key j for query i when j <= i, the softmax is f32,
the probabilities are cast to v's dtype and P.V accumulates in f32 before
the cast to q's dtype.

On a CUDA tensor the wrapper launches the hand-written kernel in
`csrc/small_seq_mha.cu` (built with nvcc at first use, see `_build.py`) or
raises; on a CPU tensor it runs `small_seq_mha_reference`, the plain PyTorch
version of the same math. The kernel takes any strides, so the transposed
views of `models/blocks.py::Attention` go in without a copy, and writes its
output in (B, T, H, D) memory order: the returned (B, H, T, D) tensor is a
transposed view of it, and the head merge that follows costs nothing. The
backward, like the TPU kernel's custom VJP, differentiates the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ._plain_backward import PlainBackward

__all__ = ["MAX_SEQ", "MAX_DIM", "small_seq_mha", "small_seq_mha_reference"]

MAX_SEQ = 32   # one lane per key in the kernel's warp
MAX_DIM = 128  # four 32-channel chunks per lane


def small_seq_mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the arithmetic of
    `_small_seq_mha_impl` and `_mha_kernel`). A float64 input stays in
    float64 throughout."""
    acc = torch.promote_types(q.dtype, torch.float32)
    T, D = q.shape[-2], q.shape[-1]
    q = q * torch.tensor(D ** -0.5, dtype=q.dtype, device=q.device)
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, torch.finfo(acc).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs.to(acc), v.to(acc)).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type not in ("cpu", "cuda") or not q.device == k.device == v.device:
        raise ValueError(f"small_seq_mha: q, k, v on {q.device}, {k.device}, "
                         f"{v.device}: one CPU or CUDA device expected")
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"small_seq_mha: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                        "float32 or bfloat16, all three the same")
    if q.ndim != 4 or not q.shape == k.shape == v.shape:
        raise ValueError(f"small_seq_mha: q, k, v must be (B, H, T, D) of one shape "
                         f"(self-attention), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, T, D = q.shape
    if not (1 <= T <= MAX_SEQ and 1 <= D <= MAX_DIM and B * H >= 1):
        raise ValueError(f"small_seq_mha: T={T}, D={D}; the kernel takes "
                         f"1 <= T <= {MAX_SEQ}, 1 <= D <= {MAX_DIM} and B*H >= 1")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("small_seq_mha")
    lib.mdt_small_seq_mha.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.mdt_small_seq_mha.restype = ctypes.c_int
    return lib


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    B, H, T, D = q.shape
    lib = _library()
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride(), *k.stride(), *v.stride())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mdt_small_seq_mha(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), B, H, T, D, strides, D ** -0.5,
                                   int(causal), int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"small_seq_mha: CUDA launch failed with error {rc} "
                           f"for q {tuple(q.shape)} {q.dtype}, causal={causal}")
    small_seq_mha.launches += 1
    return out.transpose(1, 2)


def small_seq_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False) -> torch.Tensor:
    """Self-attention over (B, H, T, D) -> (B, H, T, D), T <= 32, D <= 128.

    CUDA tensors run the kernel (and count one launch in
    `small_seq_mha.launches`); CPU tensors run the plain version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return small_seq_mha_reference(q, k, v, causal)
    return PlainBackward.apply(_launch, small_seq_mha_reference,
                               {"causal": causal}, q, k, v)


small_seq_mha.launches = 0
