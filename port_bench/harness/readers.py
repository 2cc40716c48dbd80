"""Reductions that several per-layer readers share."""

from __future__ import annotations

from typing import Dict, Optional


def unit_s(obs: Dict) -> Optional[float]:
    """Seconds a unit of the kind's work (a train step, an evaluator tick,
    a replan with its env steps) took in the untraced window that ran
    before the traced one."""
    u = obs.get("untraced") or {}
    return u["window_s"] / u["units"] if u.get("units") else None


def untraced(obs: Dict, key: str):
    """A host-clock reading of the untraced window."""
    return (obs.get("untraced") or {}).get(key)


def idle_share(obs: Dict) -> Optional[float]:
    """100 - the device's busy time a unit of work in the traced window (the
    union of its kernel, copy and memset intervals over the units) over the
    untraced time a unit, in %."""
    tr, per, units = obs.get("trace"), unit_s(obs), obs.get("units")
    if tr is None or per is None or not units:
        return None
    return 100.0 * (1.0 - tr.busy_us() / 1e6 / units / per)


def roofline(obs: Dict, match, least_s_per_iter: float, calls_per_iter: int,
             iters: int) -> Optional[float]:
    """Least time of a kernel's calls in the traced window over their device
    time by kernel name, in %; nothing when the trace's calls of that name
    are not `calls_per_iter` x `iters` (the path changed)."""
    tr = obs.get("trace")
    if tr is None or iters <= 0 or calls_per_iter <= 0:
        return None
    ks = tr.kernels(match)
    if len(ks) != calls_per_iter * iters:
        return None
    device_s = sum(e - s for _, s, e in ks) / 1e6
    return 100.0 * least_s_per_iter * iters / device_s if device_s > 0 else None
