"""Run one cell of the port's benchmark once and print its result line.

    python port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration, traffic and
metrics are found by name from `BENCHMARK.json` (see `harness/bench.py`).
With `--trace 0` the line carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a profiled window. The last
lines of standard error, and the line's `checks`, give each number compared
with the plain reference beside its limit; `correct` is whether every one
is within it. Exits 1, printing no result, without a CUDA card (or fewer
than the cell needs), and 3 when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every kernel cache inside the checkout, at a fixed path
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton-cache"))
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    import torch
    from port_bench.harness.bench import Bench, forbidden_modules
    from port_bench.harness.runner import run_cell

    bench = Bench(ROOT)
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    try:
        line = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), T_START)
    except Exception:
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded {found}: nothing the benchmark runs may load JAX "
              "or the JAX package", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct = {line['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
