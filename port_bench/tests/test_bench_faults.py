"""The comparison fails a run whose timed path is broken underneath, with
the cells' own limits: an answer altered where it is produced (serving
cells), a step that leaves the state unchanged, and half of the batch left
out with the mean over the rest (train cells). The look for a chip is
skipped: the run drives the port's plain route on the CPU at a tiny size.
Four-chip exchanges do not exist in these one-chip cells."""

import numpy as np
import pytest

from port_bench.harness.faults import planted
from port_bench.tests.conftest import run_tiny


@pytest.mark.parametrize("cell,kind", [
    ("mdtv-controller-b1", "answer"), ("mdt-eval-b32", "answer"),
    ("mdtv-train-b512", "unchanged"), ("mdtv-train-b512", "half"),
    ("mdt-train-b512", "unchanged"), ("mdt-train-b512", "half")])
def test_broken_timed_path_is_not_correct(cell, kind):
    with planted(kind):
        line = run_tiny(cell)
    assert line["correct"] is False, line["checks"]
    if kind == "unchanged":
        for name in ("grad_gap", "step_gap", "ema_gap"):
            assert np.isclose(line["checks"][name]["value"], 1.0), name
