"""Profiling helpers (port of `mdt_policy_tpu/utils/profiling.py`): a
`torch.profiler` trace of a region, written as a Chrome trace with a
summary of the device's share, and rolling step-time statistics."""

from __future__ import annotations

import contextlib
import json
import logging
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["trace", "StepTimer", "device_summary"]


def device_summary(prof, wall_ms: float) -> Dict[str, float]:
    """Device work in a finished profile: the summed time of its kernels,
    copies and sets (not the device mirrors of `record_function` ranges),
    their count, and their share of `wall_ms`."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda
              and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms, "device_events": len(events),
            "busy_share": device_ms / wall_ms if wall_ms > 0 else 0.0}


@contextlib.contextmanager
def trace(log_dir, *, device=None) -> Iterator[None]:
    """torch.profiler over the region: the host, and the CUDA device when
    `device` is one (default: when CUDA is available). Writes
    `<log_dir>/trace.json` (Chrome trace; open it in Perfetto or
    chrome://tracing) and `<log_dir>/summary.json` (`device_summary`, the
    region's wall time measured after a device synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    cuda = (torch.device(device).type == "cuda") if device is not None \
        else torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    summary = device_summary(prof, wall_ms)
    (log_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    logger.info("profile written to %s: %s", log_dir, summary)


class StepTimer:
    """Rolling step-time statistics (p50/p90/max) with device sync points."""

    def __init__(self, window: int = 100):
        self.window = window
        self.samples = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None) -> float:
        """Seconds since `start`; with `sync_on` (a CUDA tensor or device),
        after a synchronize of its device, where JAX blocks on the array."""
        if sync_on is not None:
            dev = sync_on.device if torch.is_tensor(sync_on) else torch.device(sync_on)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self.samples.append(dt)
        if len(self.samples) > self.window:
            self.samples.pop(0)
        return dt

    def stats(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        a = np.asarray(self.samples)
        return {"p50_ms": float(np.median(a) * 1e3),
                "p90_ms": float(np.percentile(a, 90) * 1e3),
                "max_ms": float(a.max() * 1e3),
                "mean_ms": float(a.mean() * 1e3)}
