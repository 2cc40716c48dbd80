"""Each traffic kind's runner through the port's plain route on the CPU at
a tiny size, and the reference against the port there.

At float32 the two sides differ only by rounding: the serving cells' chunks
agree to 1e-4 of the actions' RMS. The train cells' losses and first
gradients agree to 1e-3 (MDT's ResNets see the train pipeline's bf16
frames, the reference float32 ones: about 1e-4 of the loss and 2e-2 of a
small leaf's gradient); the changes after three AdamW steps agree to 0.2,
since with four rows a scope the contrastive temperature's gradient is
round-off after the first step and AdamW moves that leaf by its sign."""

import math

import pytest

from port_bench.tests.conftest import run_tiny

TOL = {"mdtv-controller-b1": {"chunk_gap": 1e-4},
       "mdt-eval-b32": {"chunk_gap": 1e-4},
       "mdtv-train-b512": {"loss_gap": 1e-5, "grad_gap": 1e-3, "step_gap": 0.2,
                           "ema_gap": 0.2},
       "mdt-train-b512": {"loss_gap": 1e-3, "grad_gap": 0.05, "step_gap": 0.2,
                          "ema_gap": 0.2}}


@pytest.mark.parametrize("cell", sorted(TOL))
def test_kind_runs_and_reference_agrees(cell):
    line = run_tiny(cell, limits=TOL[cell])
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    for name, c in line["checks"].items():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"], (name, c)
    assert line["correct"] is True
    assert {"setup_s"} < set(line["metrics"])


@pytest.mark.parametrize("cell", sorted(TOL))
def test_traced_run_reads_its_metrics(cell):
    line = run_tiny(cell, limits={k: 1e9 for k in TOL[cell]}, trace=True)
    assert line["device"]["window_s"] > 0 and "breakdown" in line
    assert line["metrics"], line
    for m in line["metrics"].values():
        assert math.isfinite(m["value"])
