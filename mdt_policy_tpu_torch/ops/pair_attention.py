"""Head-pair attention off the packed qkv projection: the B1 variants V1 and V3.

Port of the two Pallas TPU kernels of the JAX repository's attention
microbench: V1, `tools/attn_kernel_experiment.py::make_pair_grid`, and V3,
`tools/attn_kernel_round3.py::make_pair_v3`. Both compute B1's non-causal
contract (`fused_qkv_attention.py`) on a (image block, head pair) grid: qkv
(B, T, 3C) laid out `[q | k | v]`, C % 128 == 0 and 64-wide heads, out
(B, T, C) in qkv's dtype. Per head the scores q.k accumulate in f32; V1 and
V3 without options scale them by 1/8, take an f32 softmax (exp(s - max) /
sum), round the probabilities to qkv's dtype and accumulate P.V in f32
before the output's rounding. V3's options change the rounding points:

- `exp2`: q is multiplied by bf16(log2(e) / 8) and rounded to its dtype
  before the product; no later scale; exp2 in place of exp.
- `mxu_sum`: e = exp(s - max) (or exp2) rounded to qkv's dtype, P.V taken
  with a ones column appended to V, so that the same product yields the row
  sums of the rounded e; out = acc / sum in f32. Takes precedence over
  `bf16_softmax`.
- `no_max` (only with `mxu_sum`): no max subtraction. Numerically unsafe:
  exp overflows for logits above ~88; a probe of the max pass's cost.
- `bf16_softmax`: f32 max, e = exp(bf16(s - max)) in bf16, f32 sum of the
  bf16 e, probabilities e * bf16(1 / sum) in bf16. As in the TPU kernel this
  branch takes exp even when `exp2` scaled q for exp2.

On a CUDA tensor the wrappers launch the hand-written kernels in
`csrc/attn_pair_grid.cu` (V1, `pair_grid_attention`) and
`csrc/attn_pair_v3.cu` (V3, `pair_attention`), built with nvcc at first use
(`_build.py`), or raise; they take bfloat16 only, the dtype the microbench
drives. Both are thin entries over B1's tensor-core body
`csrc/attention_sm90.cuh`: V1 is that body without options, bit for bit
B1's non-causal output, and V3 instantiates it once for each effective
option set (`_flags`). On a CPU tensor they run `pair_attention_reference`,
the plain PyTorch version. There is no backward: the TPU variants define no
VJP. A call takes the light launch: its ctypes functions are typed once
and it launches on the current stream, with no device context.

The TPU kernels' knobs, mapped onto the CUDA kernel:

- `block_b`: the TPU's image block. The kernel's persistent blocks take
  the (image, head) items in the TPU grid's order (image blocks of
  `block_b`, head pairs, then each pair's two heads over the block's
  images), so `block_b` changes only which items run side by side. A
  ragged batch is covered exactly: the last block stops at B, nothing is
  padded.
- `vmem_mb`: the dynamic shared memory (MiB, a fraction allowed) the launch
  may opt into, capped by the card's per-block limit; the launch raises
  when the body needs more (173,088 bytes for T > 80), as Mosaic fails past
  its VMEM budget. None allows the card's limit.
- `parallel`: the TPU's grid dimension semantics. CUDA thread blocks are
  always independent, so it has no CUDA meaning: `pair_attention` accepts
  it and changes nothing, and `tools.attn_kernel_round3.make_pair_v3`
  records it on the callable it returns.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["MAX_SEQ", "kernel_attributes", "pair_attention", "pair_attention_reference",
           "pair_grid_attention"]

LOG2E = 1.4426950408889634
HEAD_DIM = 64
MAX_SEQ = 208  # keys a thread's registers hold as score rows (13 steps of 16 keys)
_MAX_SMEM_PER_BLOCK = 232_448  # bytes of shared memory a Hopper block may use
# V3 option bits of the C interface (csrc/attn_pair_v3.cu)
_EXP2, _MXU_SUM, _NO_MAX, _BF16_SOFTMAX = 1, 2, 4, 8


def pair_attention_reference(qkv: torch.Tensor, n_heads: int, *, exp2: bool = False,
                             mxu_sum: bool = False, no_max: bool = False,
                             bf16_softmax: bool = False) -> torch.Tensor:
    """Plain PyTorch version of V1 (no options) and V3, rounding where the
    TPU kernels round (module docstring). Scores, sums and P.V in f32."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    dt = qkv.dtype
    f32 = torch.float32
    q, k, v = (t.reshape(B, T, n_heads, HEAD_DIM).transpose(1, 2)
               for t in qkv.split(C, dim=-1))
    if exp2:
        q = q * torch.tensor(HEAD_DIM ** -0.5 * LOG2E, dtype=dt, device=qkv.device)
    scores = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2))
    if not exp2:
        scores = scores * HEAD_DIM ** -0.5
    if mxu_sum:
        e = scores if no_max else scores - scores.amax(-1, keepdim=True)
        e = (torch.exp2(e) if exp2 else torch.exp(e)).to(dt).to(f32)
        out = torch.matmul(e, v.to(f32)) / e.sum(-1, keepdim=True)
    else:
        m = scores.amax(-1, keepdim=True)
        if bf16_softmax:
            e = torch.exp((scores - m).to(torch.bfloat16))
            s = e.to(f32).sum(-1, keepdim=True)
            probs = e * (1.0 / s).to(torch.bfloat16)
        else:
            e = torch.exp2(scores - m) if exp2 else torch.exp(scores - m)
            probs = e / e.sum(-1, keepdim=True)
        out = torch.matmul(probs.to(dt).to(f32), v.to(f32))
    return out.transpose(1, 2).reshape(B, T, C).to(dt)


def _flags(exp2: bool = False, mxu_sum: bool = False, no_max: bool = False,
           bf16_softmax: bool = False) -> int:
    """V3's option bits for the C entry, read with the TPU kernel's
    precedence: `no_max` only under `mxu_sum`, `bf16_softmax` only without
    it. Any of the 16 combinations maps onto one of the 8 the entry takes."""
    return (_EXP2 * exp2) | (_MXU_SUM * mxu_sum) | (_NO_MAX * (no_max and mxu_sum)) \
        | (_BF16_SOFTMAX * (bf16_softmax and not mxu_sum))


def _check(name: str, qkv: torch.Tensor, n_heads: int, block_b: int) -> None:
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {qkv.device}")
    if qkv.ndim != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"{name}: qkv must be (B, T, 3C), got {tuple(qkv.shape)}")
    C = qkv.shape[-1] // 3
    if C % 128 or n_heads * HEAD_DIM != C:
        raise ValueError(f"{name}: C={C} with n_heads={n_heads}: the head-pair "
                         f"kernels take C % 128 == 0 and {HEAD_DIM}-wide heads")
    if not qkv.is_contiguous():
        raise ValueError(f"{name}: qkv must be contiguous")
    if block_b < 1:
        raise ValueError(f"{name}: block_b={block_b} must be positive")
    if qkv.device.type == "cuda":
        if qkv.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got {qkv.dtype}")
    elif qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {qkv.dtype} is not float32 or bfloat16")
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise RuntimeError(f"{name}: has no backward (the TPU variants define no VJP)")


def _check_smem(name: str, smem: int, vmem_mb) -> None:
    """Raises where the body's `smem` bytes a block exceed the budget of
    `vmem_mb` MiB (None: the card's per-block limit)."""
    budget = _MAX_SMEM_PER_BLOCK if vmem_mb is None \
        else min(int(vmem_mb * (1 << 20)), _MAX_SMEM_PER_BLOCK)
    if smem > budget:
        raise ValueError(f"{name}: the body needs {smem} bytes of shared memory per "
                         f"block, over the budget of {budget} (vmem_mb={vmem_mb})")


@functools.cache
def _entries(name: str):
    """The ctypes functions of `csrc/<name>.cu` (launch, shared memory,
    attributes), built, loaded and typed once per process."""
    lib = _build.load_library(name)
    i, p = ctypes.c_int, ctypes.c_void_p
    v3 = name == "attn_pair_v3"
    launch = getattr(lib, f"mdt_{name}")
    # qkv, out, B, seq, C, H, block_b, [flags (V3),] stream
    launch.argtypes = [p, p] + [i] * (6 if v3 else 5) + [p]
    launch.restype = i
    smem = lib.mdt_attn_pair_smem_bytes
    smem.argtypes = [i]
    smem.restype = ctypes.c_size_t
    attributes = getattr(lib, f"mdt_{name}_attributes")
    # seq, [flags (V3),] regs, local_bytes
    attributes.argtypes = [i] * (2 if v3 else 1) + [ctypes.POINTER(i)] * 2
    attributes.restype = i
    return launch, smem, attributes


def _launch(name: str, qkv: torch.Tensor, n_heads: int, block_b: int,
            flags: tuple[int, ...], vmem_mb) -> torch.Tensor:
    B, T, C3 = qkv.shape
    if not 1 <= T <= MAX_SEQ:
        raise ValueError(f"{name}: T={T} is outside the kernel's 1..{MAX_SEQ} keys")
    if qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be 16-byte aligned")
    launch, smem, _ = _entries(name)
    _check_smem(name, smem(T), vmem_mb)
    out = torch.empty((B, T, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    rc = launch(qkv.data_ptr(), out.data_ptr(), B, T, C3 // 3, n_heads, block_b, *flags,
                _build.current_stream(qkv))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} for qkv "
                           f"{tuple(qkv.shape)}, block_b={block_b}, flags={flags}")
    return out


def kernel_attributes(wrapper, T: int, **options) -> dict:
    """Registers and local-memory bytes a thread (where spills land; 0
    without) of the instantiation that `wrapper` (`pair_grid_attention`, or
    `pair_attention` under V3's `options`) runs for T rows. Needs the CUDA
    toolkit (it builds the kernel) and a card."""
    name = "attn_pair_v3" if wrapper is pair_attention else "attn_pair_grid"
    flags = (_flags(**options),) if wrapper is pair_attention else ()
    regs, local = ctypes.c_int(), ctypes.c_int()
    rc = _entries(name)[2](T, *flags, ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"{name}: cudaFuncGetAttributes failed with error {rc}")
    return {"regs": regs.value, "local_bytes": local.value}


def pair_grid_attention(qkv: torch.Tensor, n_heads: int, block_b: int = 16) -> torch.Tensor:
    """V1: qkv (B, T, 3C) -> (B, T, C). CUDA tensors run the kernel (and
    count one launch in `pair_grid_attention.launches`); CPU tensors run the
    plain version."""
    _check("pair_grid_attention", qkv, n_heads, block_b)
    if qkv.device.type == "cpu":
        return pair_attention_reference(qkv, n_heads)
    out = _launch("attn_pair_grid", qkv, n_heads, block_b, (), None)
    _build.count_launch(pair_grid_attention)
    return out


def pair_attention(qkv: torch.Tensor, n_heads: int, block_b: int = 16, *,
                   vmem_mb: int | None = None, mxu_sum: bool = False,
                   exp2: bool = False, no_max: bool = False, parallel: bool = True,
                   bf16_softmax: bool = False) -> torch.Tensor:
    """V3: qkv (B, T, 3C) -> (B, T, C) under the options of the module
    docstring. CUDA tensors run the kernel (and count one launch in
    `pair_attention.launches`); CPU tensors run the plain version.
    `parallel` has no CUDA meaning and changes nothing."""
    del parallel  # every CUDA thread block is independent
    _check("pair_attention", qkv, n_heads, block_b)
    if vmem_mb is not None and not vmem_mb > 0:
        raise ValueError(f"pair_attention: vmem_mb={vmem_mb} must be positive")
    if qkv.device.type == "cpu":  # the plain version reads the options by the same precedence
        return pair_attention_reference(qkv, n_heads, exp2=exp2, mxu_sum=mxu_sum,
                                        no_max=no_max, bf16_softmax=bf16_softmax)
    out = _launch("attn_pair_v3", qkv, n_heads, block_b,
                  (_flags(exp2, mxu_sum, no_max, bf16_softmax),), vmem_mb)
    _build.count_launch(pair_attention)
    return out


pair_grid_attention.launches = 0
pair_attention.launches = 0

