"""The yardstick's arithmetic: the H100's peaks, operations counted by
dtype, and the least time of the hand kernels B1 and B2 from their shapes.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense:
989 TFLOP/s in bfloat16, 67 TFLOP/s in float32 outside the tensor cores
(the configurations keep TF32 off), 3.35 TB/s of HBM. A step's least time
is the sum over dtypes of its operations in that dtype over that dtype's
peak; its `mfu` is that least time over the time the step took.

`count_by_dtype` counts the aten matmuls and convolutions that a call
dispatches on this thread (forward and backward), keyed by the dtype of
their first operand, with the formulas of `torch.utils.flop_counter`.
The hand kernels launch through ctypes and dispatch nothing, so their
operations are added from their shapes (`attention_flops`, as the
program's `utils/flops.py` counts B1's; a causal call counts the half
that its mask keeps).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def attention_flops(batch: int, seq: int, width: int, causal: bool = False) -> float:
    """Q.K^T and P.V of `batch` sequences of `seq` tokens, `width` = heads
    x head width; a causal call needs the T (T + 1) / 2 pairs it keeps."""
    pairs = seq * (seq + 1) / 2 if causal else seq * seq
    return 4.0 * batch * pairs * width


def least_s(n_bytes: float, flops: float, dtype: str) -> float:
    """The larger of the bytes over HBM bandwidth and the operations over
    the dtype's peak."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def b1_least_s(batch: int, seq: int, width: int, causal: bool, elem: int = 2) -> float:
    """B1 (fused attention off the packed qkv, bf16): reads the (B, T, 3C)
    qkv once and writes the (B, T, C) output once."""
    n_bytes = batch * seq * 4 * width * elem
    return least_s(n_bytes, attention_flops(batch, seq, width, causal), "bfloat16")


def b2_least_s(batch: int, n_heads: int, seq: int, dim: int, causal: bool,
               elem: int = 4) -> float:
    """B2 (small-sequence attention, f32): reads q, k and v and writes the
    output once."""
    n_bytes = 4 * batch * n_heads * seq * dim * elem
    flops = attention_flops(batch * n_heads, seq, dim, causal)
    return least_s(n_bytes, flops, "float32" if elem == 4 else "bfloat16")


def least_time_s(by_dtype: Dict[str, float]) -> float:
    return sum(f / PEAK_FLOPS[d] for d, f in by_dtype.items())


def count_by_dtype(fn: Callable[[], object]) -> Dict[str, float]:
    """{dtype name: FLOPs} of the matmuls and convolutions `fn()` dispatches."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    counts: Dict[str, float] = defaultdict(float)

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            packet = func._overloadpacket
            if packet in flop_registry:
                first = next((a for a in args if isinstance(a, torch.Tensor)), None)
                dtype = str(first.dtype).replace("torch.", "") if first is not None else "float32"
                counts[dtype] += float(flop_registry[packet](*args, **kwargs, out_val=out))
            return out

    with Counter():
        fn()
    return dict(counts)
