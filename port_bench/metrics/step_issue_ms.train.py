"""Host ms from the call of `train_step` to its return, no sync, as a
median over the untraced window's steps."""
import numpy as np

from port_bench.harness.readers import untraced


def read(obs):
    ms = untraced(obs, "issue_ms")
    return float(np.median(ms)) if ms is not None and len(ms) else None
