"""The program's own spans and counters (`mdt_policy_tpu_torch.utils.
profiling.recorded()`), grouped by the harness span around each call and
placed on the traced window's clock.

The program stamps its spans with `time.time_ns()`, as `trace.Recorder`
stamps the harness's, and records them only while a profile runs, so the
buffer holds the traced window's. Each program root (a span with no parent)
is paired with the harness span around the same call, in order:

    policy.step  <->  pb.replan_plain, pb.replan_switch, pb.step
    eval.tick    <->  pb.tick
    train.step   <->  pb.train_step
    data.next    <->  pb.next_batch

The harness's spans lie on the profile's clock (`trace.from_profile`), the
program's on the raw wall clock. Their offset is one straight line over the
roots' raw starts (`_line`), and every root, its descendants (the spans of
its thread inside it) and its counters are placed by that line. `place(obs)`
returns nothing when the program records no spans (a commit without them),
when the roots and harness spans do not pair one to one, or when a placed
root ends after its harness span by more than `TOLERANCE_US`.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

PAIRS = {"policy.step": ("pb.replan_plain", "pb.replan_switch", "pb.step"),
         "eval.tick": ("pb.tick",),
         "train.step": ("pb.train_step",),
         "data.next": ("pb.next_batch",)}
TOLERANCE_US = 20.0

# (name, start_us, end_us, parent, thread, rid) on the profile's clock
Placed = Tuple[str, float, float, Optional[str], int, Optional[int]]


@dataclasses.dataclass
class Unit:
    """One program root with the harness span it paired with (`harness`),
    its descendants and the counters recorded inside it."""
    harness: str
    root: Placed
    spans: List[Placed]
    counts: Dict[str, int]

    def ms(self, name: str) -> float:
        """Host ms in the unit's spans of `name`."""
        return sum(s[2] - s[1] for s in self.spans if s[0] == name) / 1e3


def place(obs: Dict) -> Optional[List[Unit]]:
    """The traced window's units, by start (memoised in `obs`)."""
    if "program_spans" not in obs:
        obs["program_spans"] = _place(obs)
    return obs["program_spans"]


def units(obs: Dict, *harness: str) -> List[Unit]:
    """The units paired with the harness spans named `harness`."""
    return [u for u in place(obs) or () if u.harness in harness]


def _records():
    try:
        from mdt_policy_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    return recorded()


def _line(t: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The clocks' offset as a straight line over the roots' raw starts `t`
    (µs): the median slope between pairs of corrections `c` (harness start
    minus root start; Theil-Sen, so a root that the host reached late, after
    a collection or a thread switch, moves it little), through the highest
    correction. A root starts after its harness span does, never before, so
    the latest starters lie lowest and the soonest ones on the line."""
    slope = 0.0
    if np.ptp(t) > 0:
        k = np.linspace(0, len(t) - 1, min(len(t), 400)).astype(int)
        i, j = np.triu_indices(len(k), 1)
        dt = t[k][j] - t[k][i]
        slope = float(np.median((c[k][j] - c[k][i])[dt != 0] / dt[dt != 0]))
    return np.asarray([slope, float(np.max(c - slope * t))])


def _place(obs: Dict) -> Optional[List[Unit]]:
    tr, recs = obs.get("trace"), _records()
    if tr is None or not recs:
        return None
    spans = sorted((r for r in recs if hasattr(r, "end_ns")), key=lambda r: r.start_ns)
    if not spans:
        return None
    base = spans[0].start_ns
    us = lambda ns: (ns - base) / 1e3  # noqa: E731  exact in float64 after the shift

    pairs, extra = [], []  # (harness span, program root); the root before the pairs
    for root, names in PAIRS.items():
        hs = sorted((h for h in tr.host if h[0] in names), key=lambda h: h[1])
        if not hs:
            continue
        rs = [s for s in spans if s.name == root and s.parent is None]
        if len(rs) < len(hs):
            return None
        pairs += list(zip(hs, rs[-len(hs):]))
        extra += rs[-len(hs) - 1:-len(hs)]
    if not pairs:
        return None
    line = _line(np.asarray([us(r.start_ns) for _, r in pairs]),
                 np.asarray([h[1] - us(r.start_ns) for h, r in pairs]))
    at = lambda ns: us(ns) + float(np.polyval(line, us(ns)))  # noqa: E731
    if any(at(r.end_ns) - h[2] > TOLERANCE_US for h, r in pairs):
        return None
    if any(at(r.end_ns) > tr.window[0] for r in extra):
        return None  # a root inside the window that no harness span holds

    starts = [s.start_ns for s in spans]
    counts = sorted((r for r in recs if not hasattr(r, "end_ns")), key=lambda k: k.t_ns)
    k_ts = [k.t_ns for k in counts]
    out = []
    for h, r in pairs:
        put = lambda s: (s.name, at(s.start_ns), at(s.end_ns), s.parent, s.thread,  # noqa: E731
                         s.rid)
        mine = [put(s) for s in spans[bisect.bisect_left(starts, r.start_ns):
                                      bisect.bisect_right(starts, r.end_ns)]
                if s is not r and s.thread == r.thread and s.end_ns <= r.end_ns]
        n: Dict[str, int] = {}
        for k in counts[bisect.bisect_left(k_ts, r.start_ns):
                        bisect.bisect_right(k_ts, r.end_ns)]:
            n[k.name] = n.get(k.name, 0) + k.n
        out.append(Unit(h[0], put(r), mine, n))
    return sorted(out, key=lambda u: u.root[1])


def step_ms(obs: Dict, name: str) -> Optional[float]:
    """Host ms a train step spends in the program's spans of `name`, as a
    mean over the traced window's steps."""
    steps = units(obs, "pb.train_step")
    return float(np.mean([u.ms(name) for u in steps])) if steps else None
