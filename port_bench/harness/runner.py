"""One run of one cell: set-up, the measured (or traced) window, the
program's state freed, the comparison with the reference, the metrics."""

from __future__ import annotations

import dataclasses
import math
import os
import subprocess
import sys
import time
from typing import Dict, Optional

import torch

from .bench import Bench


@dataclasses.dataclass
class Ctx:
    """What a traffic kind's runner gets: the cell, its configuration file
    and agent config, the traffic's parameters, the seed, the device and
    the configuration's reference module."""
    cell: Dict
    config: Dict
    traffic: Dict
    seed: int
    device: torch.device
    reference: object
    agent_cfg: object = None
    cfg_fields: Dict = None
    home: object = None


def card(device) -> Dict:
    """The device block's own facts: the card's name and count, and beside
    them its power limit, torch's version and the host's cores."""
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1, "torch": torch.__version__, "host_cores": os.cpu_count()}
    if device.type == "cuda":
        try:
            out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                  "--format=csv,noheader", f"--id={device.index or 0}"],
                                 capture_output=True, text=True, timeout=20)
            info["power_limit"] = out.stdout.strip()
        except (OSError, subprocess.TimeoutExpired):
            info["power_limit"] = "unknown"
    return info


def make_ctx(bench: Bench, cell_name: str, seed: int, device, agent_cfg=None,
             traffic: Optional[Dict] = None) -> Ctx:
    """The runner's context; `agent_cfg` and `traffic` (parameters that
    replace the mix's) serve the tests' small sizes."""
    from . import agent as A
    cell = bench.cell(cell_name)
    doc = bench.config(cell["config"])
    cfg = agent_cfg or A.agent_config(doc)
    mix = {**bench.traffic(cell["traffic"]), **(traffic or {})}
    return Ctx(cell=cell, config=doc, traffic=mix, seed=seed,
               device=torch.device(device), reference=bench.reference(doc), agent_cfg=cfg,
               cfg_fields=dataclasses.asdict(cfg), home=bench.home)


def run_cell(bench: Bench, cell_name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, agent_cfg=None, limits: Optional[Dict] = None,
             traffic: Optional[Dict] = None) -> Dict:
    """The result line of one run; `agent_cfg`, `limits` and `traffic`
    replace the cell's for the tests' small sizes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = make_ctx(bench, cell_name, seed, device, agent_cfg, traffic)
    runner = bench.kind(ctx.traffic["kind"]).Runner(ctx)
    runner.setup()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    if trace:
        # the host-clock readings and the untraced time a unit of work
        # (step, tick, replan) come from a window of their own, the device's
        # from the profiled one after it
        length = min(seconds, ctx.traffic["trace_seconds"])
        untraced = runner.window(length, False)
        obs = runner.window(length, True)
        obs["untraced"] = untraced
    else:
        obs = runner.window(seconds, False)
    dev = torch.device(device)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    runner.release()

    readings = runner.readings()
    limits = limits if limits is not None else bench.limits(cell_name)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())

    metrics = {}
    obs["runner"], obs["ctx"] = runner, ctx
    if trace:
        for m in bench.metrics_of(cell_name, "per_layer"):
            value = bench.reader(m["name"]).read(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench.metrics_of(cell_name, "end_to_end"):
            value = setup_s if m["name"] == "setup_s" else obs["values"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    info = card(dev)
    info["memory_peak_bytes"] = int(peak)
    line = {"correct": correct, "attempted": int(obs["attempted"]), "failed": 0,
            "metrics": metrics, "device": info}
    if trace and obs.get("trace") is not None:
        tr = obs["trace"]
        info["busy_s"] = tr.busy_us() / 1e6
        info["window_s"] = tr.window_us / 1e6
        line["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
        u = obs["untraced"]
        print(f"port_bench: a unit of work took {u['window_s'] / max(u['units'], 1)!r} s "
              f"untraced ({u['units']} units), {obs['window_s'] / max(obs['units'], 1)!r} s "
              f"traced ({obs['units']} units); spans moved by {tr.clock_fix_us!r} us at the "
              "window's ends", file=sys.stderr)
    line["checks"] = checks
    return line
