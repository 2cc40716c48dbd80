"""Host ms that a goal switch adds to a replan: the median of the replans
that switch goal minus the median of those that keep it, both timed by the
harness in the untraced window (the policy's one-goal cache and the CLIP
text tower)."""
import numpy as np

from port_bench.harness.readers import untraced


def read(obs):
    ms, sw = untraced(obs, "replan_ms"), untraced(obs, "switch")
    if ms is None or sw is None or not sw.any() or sw.all():
        return None
    return float(np.median(ms[sw]) - np.median(ms[~sw]))
