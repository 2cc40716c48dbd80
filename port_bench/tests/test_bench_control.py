"""On the card, at each cell's own size: the control (the reference one
step below the configuration's precision: fp8 operands in the bfloat16
modules, TF32 in the float32 ones) put in the program's place fails at
least one of the cell's limits, on three seeds; and the program's own
readings stay within them. Run with `python -m pytest port_bench/tests -m
cuda` on a machine with the card (a few minutes a cell)."""

import json

import pytest

from port_bench.tests.conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, cuda_card):
    from port_bench.calibrate import readings
    from port_bench.harness.bench import Bench
    bench = Bench(ROOT)
    limits = bench.limits(cell)
    for seed in (9001, 9002, 9003):
        row = readings(bench, cell, seed, 2.0, cuda_card)
        assert any(row["control"][k] > limits[k] for k in limits), row
        assert all(row["program"][k] <= limits[k] for k in limits), row
