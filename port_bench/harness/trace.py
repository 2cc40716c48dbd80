"""The traced window: `torch.profiler` over the window, reduced to what the
per-layer readers and the result line need.

The profile records the device's activity alone (kernels, copies,
memsets and the CUDA runtime calls that issued them), not the host's
PyTorch operators: recording every operator slows a host-bound loop by
half again, and the window's idle share and step time would then measure
the profiler. The harness's own spans (`Recorder.span`) are stamped with
the host's wall clock, on which the profile's events lie too, and are
placed among them when the profile is reduced:

* device intervals: every kernel, copy and memset the card ran, on one
  time base with the runtime calls and the spans;
* busy time: the union of those intervals, so work that overlaps on two
  streams counts once;
* the costliest device operations by name, and the idle gaps between the
  device intervals, each named by the innermost runtime call or span that
  was open at its middle ("(host)" where none was: Python and PyTorch's
  own host code).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def union_us(intervals: np.ndarray) -> float:
    """Length of the union of (start, end) rows, in their unit."""
    if len(intervals) == 0:
        return 0.0
    iv = intervals[np.argsort(intervals[:, 0])]
    total, cur_s, cur_e = 0.0, iv[0, 0], iv[0, 1]
    for s, e in iv[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return float(total + cur_e - cur_s)


def merged(intervals: np.ndarray) -> np.ndarray:
    """The union of (start, end) rows as disjoint sorted rows."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s > out[-1][1]:
            out.append([s, e])
        else:
            out[-1][1] = max(out[-1][1], e)
    return np.asarray(out)


class Trace:
    """What one profiled window left: device events (name, start, end) and
    host events (runtime calls and spans: name, start, end, thread) in µs,
    and the window's own bounds on the same clock (the `pb.window` span)."""

    def __init__(self, device: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float, int]], window: Tuple[float, float]):
        self.device, self.host, self.window = device, host, window
        self.dev_iv = np.asarray([(s, e) for _, s, e in device], dtype=np.float64).reshape(-1, 2)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def clipped(self, lo: float, hi: float) -> np.ndarray:
        iv = np.clip(self.dev_iv, lo, hi)
        return iv[iv[:, 1] > iv[:, 0]]

    def busy_us(self, lo: Optional[float] = None, hi: Optional[float] = None) -> float:
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        return union_us(self.clipped(lo, hi))

    def kernels(self, match) -> List[Tuple[str, float, float]]:
        return [d for d in self.device if match(d[0])]

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        lo, hi = self.window
        for n, s, e in self.device:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                by[n] = by.get(n, 0.0) + (e - s)
        return [[n[:120], v / 1e6] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10, longest: int = 400) -> List[List]:
        """Idle seconds by the host operation running at each gap's middle,
        over the `longest` gaps of the window; the `top` names."""
        lo, hi = self.window
        busy = merged(self.clipped(lo, hi))
        edges = np.concatenate([[lo], busy.ravel(), [hi]]).reshape(-1, 2)
        gaps = edges[edges[:, 1] > edges[:, 0]]
        gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:longest]
        if not len(gaps):
            return []
        host = sorted((h for h in self.host if h[0] != "pb.window"), key=lambda h: h[1])
        starts = np.asarray([h[1] for h in host], dtype=np.float64)
        by: Dict[str, float] = {}
        for s, e in gaps:
            mid = (s + e) / 2
            name = "(host)"
            # the latest-starting host range that holds the middle is the innermost
            for i in range(int(np.searchsorted(starts, mid, side="right")) - 1, -1, -1):
                if host[i][2] >= mid:
                    name = host[i][0]
                    break
            by[name] = by.get(name, 0.0) + (e - s)
        return [[n[:120], v / 1e6] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def from_profile(prof, spans: List[Tuple[str, int, int]], anchors: Sequence[int] = ()) -> Trace:
    """Reduce a finished `torch.profiler.profile` and the spans recorded
    beside it (name, start, end in wall-clock ns) to a `Trace`. `anchors`
    are wall-clock stamps taken as `profiled` returned from a device
    synchronisation before the block and from one after it; matched to
    the ends of those calls in the profile, they correct the spans' place
    on the profile's clock, linearly between them."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    origin = prof.profiler.kineto_results.trace_start_ns()
    device, host = [], []
    for e in prof.events():
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False):
                device.append((e.name, s, t))
        else:
            host.append((e.name, s, t, int(getattr(e, "thread", 0) or 0)))
    naive = lambda ns: (ns - origin) / 1e3  # noqa: E731
    place, fix = naive, (0.0, 0.0)
    # the first synchronisation of the profile warms its callbacks up; the
    # second and the last are the anchors'
    syncs = sorted(t for n, s, t, _ in host if n == "cudaDeviceSynchronize")
    if len(anchors) == 2 and len(syncs) >= 3:
        a0, a1 = naive(anchors[0]), naive(anchors[1])
        fix = (syncs[1] - a0, syncs[-1] - a1)
        place = lambda ns: naive(ns) + fix[0] + (fix[1] - fix[0]) * (  # noqa: E731
            naive(ns) - a0) / max(a1 - a0, 1e-9)
    window = None
    for name, s, t in spans:
        iv = (place(s), place(t))
        host.append((name, iv[0], iv[1], 0))
        if name == "pb.window":
            window = iv
    if window is None:
        raise RuntimeError("no pb.window span was recorded")
    trace = Trace(device, host, window)
    trace.clock_fix_us = fix
    return trace


class Recorder:
    """The traced block's spans and, once the block has ended, its `Trace`
    (None when not enabled). Each `span(name)` stamps its ends with
    `time.time_ns()`."""

    def __init__(self, enabled: bool):
        self.enabled, self.spans, self.trace = enabled, [], None

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))


NO_SPANS = Recorder(False)


@contextlib.contextmanager
def profiled(enabled: bool):
    """Yields a `Recorder`; when enabled, the block runs under a profile of
    the device's activity (of the host's operators on a machine with no
    CUDA card, where there is no device activity) and must mark its window
    with `span("pb.window")`."""
    rec = Recorder(enabled)
    if not enabled:
        yield rec
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    anchors = []
    with profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.synchronize()
            anchors.append(time.time_ns())
        yield rec
        if cuda:
            torch.cuda.synchronize()
            anchors.append(time.time_ns())
    rec.trace = from_profile(prof, rec.spans, anchors)
