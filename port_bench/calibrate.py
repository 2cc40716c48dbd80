"""Readings that set a cell's limits: for each seed, the compared numbers
of the program (a short window at the cell's own load) and of the control
(the reference one step below the configuration's precision, in the
program's place), printed one JSON line a seed; with `--fault`, the
program's readings with that fault planted (`harness/faults.py`). One
process serves every seed, so kernels build once.

    python port_bench/calibrate.py --workload <name> --seeds 1,2,3 --seconds 3
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(bench, workload: str, seed: int, seconds: float, device, control: bool = True,
             fault: str = ""):
    """{"program": ..., "control": ...} readings of one seed; with `fault`
    (`harness/faults.py`), the program's with that fault planted."""
    import contextlib
    from port_bench.harness.faults import planted
    from port_bench.harness.runner import make_ctx
    ctx = make_ctx(bench, workload, seed, device)
    runner = bench.kind(ctx.traffic["kind"]).Runner(ctx)
    with planted(fault) if fault else contextlib.nullcontext():
        runner.setup()
        runner.window(seconds, False)
    runner.release()
    out = {"seed": seed, "program": runner.readings()}
    if getattr(runner, "worst", None):
        out["worst"] = runner.worst
    if control:
        out["control"] = runner.readings(control=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--fault", default="", help="answer, unchanged or half")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from port_bench.harness.bench import Bench
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = Bench(ROOT)
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        row = readings(bench, args.workload, int(s), args.seconds, torch.device("cuda", 0),
                       bool(args.control), fault=args.fault)
        row["s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
