"""Microbench of the head-pair attention kernel V1 against B1 on the card.

The port of the JAX repository's `tools/attn_kernel_experiment.py`: the
(image block, head pair) variant of the production attention kernel B1
(`make_pair_grid`, kernel `csrc/attn_pair_grid.cu`) at block_b 16, 20 and
24, in 12-layer chains at the towers' training shapes, with chained
fetch-barrier timing (`perf_probe.chain_bench`), parity against the plain
einsum attention, and SDPA's time beside each. `run` returns the rows;

    python -m mdt_policy_tpu_torch.tools.attn_kernel_experiment [n_voltron] [n_clip]

runs it on the GPU. `run(..., device="cpu")` drives the same path through
the plain versions and times nothing.
"""

from __future__ import annotations

import functools
import sys

from ..ops.pair_attention import pair_attention_reference, pair_grid_attention
from .perf_probe import Variant, bench_variants, production


def make_pair_grid(n_heads: int, block_b: int):
    """V1 at `block_b` images per thread block: a callable on a (B, T, 3C)
    qkv, with its wrapper (`.kernel`) and its plain version (`.plain`)."""
    def run(qkv):
        return pair_grid_attention(qkv, n_heads, block_b)
    run.kernel = pair_grid_attention
    run.plain = functools.partial(pair_attention_reference, n_heads=n_heads)
    return run


def variants(n_heads: int):
    return [Variant("production (B1)", production(n_heads))] + [
        Variant(f"pair-grid bB={bB}", make_pair_grid(n_heads, bB)) for bB in (16, 20, 24)]


def run(n_v: int = 1024, n_c: int = 512, *, device="cuda", n_layers: int = 12,
        n: int = 8, reps: int = 2):
    """The microbench's rows (`perf_probe.bench_variants`)."""
    return bench_variants("attn_kernel_experiment", variants, n_v, n_c, device=device,
                          n_layers=n_layers, n=n, reps=reps)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    run(*(int(a) for a in argv[:2]))


if __name__ == "__main__":
    main()
