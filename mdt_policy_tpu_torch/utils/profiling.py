"""Profiling of the port: `trace()`, a `torch.profiler` window written as a
Chrome trace with a summary, and the program's own spans and counters.

`span(name)` times a part of the program and `count(name, n)` counts work
where it happens. Both record only while a torch profile runs in the
process (`trace()`, the operator's `trainer.profile_steps`, or any
`torch.profiler.profile` around the program); otherwise `span` returns one
shared no-op object after a single flag read, and `count` returns at once.
A recorded span keeps (name, start, end, parent, thread, rid) in a bounded
buffer (`recorded()`), stamped with `time.time_ns()`: its parent is the span
open around it on the same thread, and `rid` (the replan cycle, the
evaluator's tick, the train step) is shared by every span of one request.
Inside `trace()` it also opens a `torch.profiler.record_function` range of
its name, so the Chrome trace shows it among the operators; under other
profiles it opens none, as a profile of the device's activity alone would
not show it and each range costs about 11 µs on an H100's host. Names are
`<layer>.<part>`: `policy.*`, `eval.*`, `data.*`, `train.*`, `net.*`. No
span sits inside a function that a CUDA graph captures: a replay runs no
host code.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple, Union

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger(__name__)

__all__ = ["Count", "NO_SPAN", "Span", "count", "device_summary", "recorded", "recording",
           "span", "span_summary", "trace", "union_us"]

MAX_RECORDS = 1 << 18  # the buffer keeps the newest records beyond this


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    thread: int
    rid: Optional[int]


class Count(NamedTuple):
    name: str
    t_ns: int
    n: int


_records: "collections.deque[Union[Span, Count]]" = collections.deque(maxlen=MAX_RECORDS)
_local = threading.local()
_ranges = False  # spans open record_function ranges: inside `trace()`


def recording() -> bool:
    """Whether spans and counters record: a torch profile is running. The
    flag is torch's process-wide one, so it reads the same on every thread
    (the prefetcher's worker too)."""
    return _autograd_profiler._is_profiler_enabled


class _Off:
    """The shared span of a process with no profile running."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _Off()


class _On:
    __slots__ = ("name", "rid", "parent", "t0", "range")

    def __init__(self, name: str, rid: Optional[int]):
        self.name, self.rid = name, rid

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        self.parent = top.name if top is not None else None
        if self.rid is None and top is not None:
            self.rid = top.rid
        stack.append(self)
        self.range = torch.profiler.record_function(self.name) if _ranges else None
        if self.range is not None:
            self.range.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.stack.pop()
        _records.append(Span(self.name, self.t0, t1, self.parent, threading.get_ident(),
                             self.rid))
        return False


def span(name: str, rid: Optional[int] = None):
    """A context manager that records `name`'s interval while a profile
    runs; `rid` names the request (children inherit their parent's)."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return _On(name, rid)


def count(name: str, n: int = 1) -> None:
    """Adds `n` to counter `name` at this instant while a profile runs."""
    if _autograd_profiler._is_profiler_enabled:
        _records.append(Count(name, time.time_ns(), n))


def recorded() -> List[Union[Span, Count]]:
    """The buffer's spans and counters, oldest first; `trace()` empties it
    as it starts."""
    return list(_records)


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def device_summary(prof, wall_ms: float) -> Dict[str, float]:
    """Device work in a finished profile: the union of its kernels', copies'
    and sets' intervals (not the device mirrors of `record_function`
    ranges), so work that overlaps on two streams counts once, their count,
    and their share of `wall_ms`."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda
              and not getattr(e, "is_user_annotation", False)]
    device_ms = union_us((e.time_range.start, e.time_range.end) for e in events) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms, "device_events": len(events),
            "busy_share": device_ms / wall_ms if wall_ms > 0 else 0.0}


def span_summary(records: Iterable[Union[Span, Count]]) -> Dict[str, Dict]:
    """Each span name's count, total ms and self ms (its time less its
    children's), and each counter's total."""
    spans: Dict[str, Dict] = {}
    children_ns: Dict[str, int] = collections.defaultdict(int)
    counters: Dict[str, int] = collections.defaultdict(int)
    for r in records:
        if isinstance(r, Count):
            counters[r.name] += r.n
            continue
        s = spans.setdefault(r.name, {"count": 0, "total_ns": 0})
        s["count"] += 1
        s["total_ns"] += r.end_ns - r.start_ns
        if r.parent is not None:
            children_ns[r.parent] += r.end_ns - r.start_ns
    return {"spans": {n: {"count": s["count"], "total_ms": s["total_ns"] / 1e6,
                          "self_ms": (s["total_ns"] - children_ns[n]) / 1e6}
                      for n, s in sorted(spans.items())},
            "counters": dict(sorted(counters.items()))}


@contextlib.contextmanager
def trace(log_dir, *, device=None) -> Iterator[None]:
    """torch.profiler over the region: the host, and the CUDA device when
    `device` is one (default: when CUDA is available). Writes
    `<log_dir>/trace.json` (Chrome trace, the spans among the operators;
    open it in Perfetto or chrome://tracing) and `<log_dir>/summary.json`
    (`device_summary`, the region's wall time measured after a device
    synchronize, and `span_summary` of the spans and counters recorded in
    the region)."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    cuda = (torch.device(device).type == "cuda") if device is not None \
        else torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    global _ranges
    with profile(activities=activities) as prof:
        _records.clear()
        _ranges = True
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _ranges = False
            if cuda:
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    summary = {**device_summary(prof, wall_ms), **span_summary(recorded())}
    (log_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    logger.info("profile written to %s: %s", log_dir,
                {k: v for k, v in summary.items() if k not in ("spans", "counters")})
