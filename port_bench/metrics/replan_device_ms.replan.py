"""Device ms of a replan that keeps its goal: the busy time of its env
step's device work (the raw frames' copies and preprocessing, the graph
replay of `_predict_emb`, the action's copy back), averaged over the traced
window's plain replans. Every env step copies one action to the host
(`Memcpy DtoH`), so those copies delimit the steps on the device's own
clock: a step's work is what ran after the step before it had copied its
action and until the step's own copy ended. Nothing when the trace's
count of those copies is not the window's count of env steps."""
import numpy as np


def read(obs):
    tr, sw = obs.get("trace"), obs.get("switch")
    if tr is None or sw is None:
        return None
    ends = sorted(e for n, s, e in tr.device if "DtoH" in n)
    if len(ends) != obs["env_steps"] or not len(ends):
        return None
    m = obs["runner"].multistep
    bounds = [float("-inf")] + ends
    ms = [tr.busy_us(bounds[r * m], bounds[r * m + 1]) for r in range(len(sw)) if not sw[r]]
    return float(np.mean(ms)) / 1e3 if ms else None
