"""Microbench of the head-pair attention kernel V3's options against B1.

The port of the JAX repository's `tools/attn_kernel_round3.py`: kernel V3
(`make_pair_v3`, `csrc/attn_pair_v3.cu`) under the round-3 option sets
(larger image blocks, bf16 softmax passes, the row sum from the P.V product
with a ones column, exp2 with the scale folded into q, and a numerically
unsafe no-max-subtract probe) in 12-layer chains at the towers' training
shapes, with chained fetch-barrier timing (`perf_probe.chain_bench`),
parity against the plain einsum attention, TFLOP/s against the H100's bf16
peak and SDPA's time beside each. `run` returns the rows;

    python -m mdt_policy_tpu_torch.tools.attn_kernel_round3 [n_voltron] [n_clip]

runs it on the GPU. `run(..., device="cpu")` drives the same path through
the plain versions and times nothing.
"""

from __future__ import annotations

import functools
import sys

from ..ops.pair_attention import pair_attention, pair_attention_reference
from .perf_probe import Variant, bench_variants, production

LOG2E = 1.4426950408889634


def make_pair_v3(n_heads: int, block_b: int, *, vmem_mb: int | None = None,
                 mxu_sum: bool = False, exp2: bool = False, no_max: bool = False,
                 parallel: bool = True, bf16_softmax: bool = False):
    """V3 with the given options (`ops/pair_attention.py` maps each onto the
    CUDA kernel): a callable on a (B, T, 3C) qkv, with its wrapper
    (`.kernel`), its plain version (`.plain`) and its options (`.options`;
    `parallel` is recorded there and has no CUDA meaning)."""
    options = {"vmem_mb": vmem_mb, "mxu_sum": mxu_sum, "exp2": exp2, "no_max": no_max,
               "parallel": parallel, "bf16_softmax": bf16_softmax}

    def run(qkv):
        return pair_attention(qkv, n_heads, block_b, **options)
    run.kernel = pair_attention
    run.plain = functools.partial(pair_attention_reference, n_heads=n_heads, exp2=exp2,
                                  mxu_sum=mxu_sum, no_max=no_max, bf16_softmax=bf16_softmax)
    run.options = {"block_b": block_b, **options}
    return run


def variants(H: int):
    """The option sets of the JAX tool's `main()`, in its order."""
    return [
        Variant("production (B1)", production(H)),
        Variant("pair bB=16 PARALLEL only", make_pair_v3(H, 16)),
        Variant("pair bB=16 bf16-softmax", make_pair_v3(H, 16, bf16_softmax=True)),
        Variant("pair bB=32 vmem=64M", make_pair_v3(H, 32, vmem_mb=64)),
        Variant("pair bB=64 vmem=110M", make_pair_v3(H, 64, vmem_mb=110)),
        Variant("pair bB=16 +mxusum+exp2",
                make_pair_v3(H, 16, vmem_mb=None, mxu_sum=True, exp2=True)),
        Variant("pair bB=32 vmem +mxusum+exp2",
                make_pair_v3(H, 32, vmem_mb=64, mxu_sum=True, exp2=True)),
        Variant("pair bB=64 vmem +mxusum+exp2",
                make_pair_v3(H, 64, vmem_mb=110, mxu_sum=True, exp2=True)),
        Variant("UNSAFE no-max probe bB=32",
                make_pair_v3(H, 32, vmem_mb=64, mxu_sum=True, exp2=True, no_max=True)),
    ]


def run(n_v: int = 1024, n_c: int = 512, *, device="cuda", n_layers: int = 12,
        n: int = 8, reps: int = 2):
    """The microbench's rows (`perf_probe.bench_variants`)."""
    return bench_variants("attn_kernel_round3", variants, n_v, n_c, device=device,
                          n_layers=n_layers, n=n, reps=reps)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    run(*(int(a) for a in argv[:2]))


if __name__ == "__main__":
    main()
