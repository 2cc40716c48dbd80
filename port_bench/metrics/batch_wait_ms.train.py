"""Host ms the step loop waits on the prefetcher's `next()`, as a mean over
the untraced window's steps."""
import numpy as np

from port_bench.harness.readers import untraced


def read(obs):
    ms = untraced(obs, "wait_ms")
    return float(np.mean(ms)) if ms is not None and len(ms) else None
