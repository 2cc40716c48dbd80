"""Checkpoints of a port `TrainState` (port of `mdt_policy_tpu/utils/checkpoint.py`,
`:29-125`, in a torch format: the card's machine has no orbax).

A run directory keeps its checkpoints under `checkpoints/`, one directory a
step, each holding `state.pt`: the step, the net's full `state_dict()` (the
frozen towers in their own dtype), the EMA of the trainables and the
optimizer's `state_dict()`. A step directory is written under a temporary
name and committed by `os.replace` (a step saved again has its file
replaced in place), so a directory named by its step is complete;
`best.json` is replaced the same way and names a step only after that step
is committed. `Checkpointer` keeps the JAX API: `save` (in a
background thread unless told to wait), `wait`, `restore`, `best_step`,
`keep`, and `best.json` under save_top_k=1 on a maximised metric.

`convert_run_dir` writes such a run directory from a JAX one's config and
the numpy trees of its checkpoints (read with orbax by the caller, on a
machine with JAX).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

__all__ = ["Checkpointer", "convert_run_dir", "latest_checkpoint"]

STATE_FILE = "state.pt"


def latest_checkpoint(ckpt_dir) -> Optional[Path]:
    """Newest committed step directory under ckpt_dir (step order)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [p for p in ckpt_dir.iterdir() if p.is_dir() and p.name.isdigit()]
    return max(steps, key=lambda p: int(p.name)) if steps else None


def _to_host(obj):
    """A copy of `obj` with every tensor copied to host memory."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write_json(path: Path, obj) -> None:
    """Write `obj` as JSON to `path` through a temporary file and
    `os.replace`: a reader sees the old file or the new one."""
    tmp = path.with_name(f".{path.name}.tmp")
    tmp.write_text(json.dumps(obj))
    os.replace(tmp, path)


class Checkpointer:
    """Saves and restores {step, params, ema, optimizer} of a `TrainState`."""

    def __init__(self, ckpt_dir, keep: int = 1):
        self.ckpt_dir = Path(ckpt_dir)
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._best_file = self.ckpt_dir / "best.json"
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[concurrent.futures.Future] = None

    def save(self, state, *, metric: Optional[float] = None,
             metric_name: str = "eval_lh/avg_seq_len", wait: bool = False) -> Path:
        """Copies the state to host memory before it returns (the caller may
        take the next step at once) and writes it in a background thread,
        one save in flight at a time. `wait=True` returns once the step is
        committed; a `metric` waits too, then updates `best.json`."""
        self.wait()
        step = int(state.step)
        tree = {"step": step, "params": _to_host(state.net.state_dict()),
                "ema": _to_host(state.ema), "optimizer": _to_host(state.optimizer.state_dict())}
        self._pending = self._pool.submit(self._commit, step, tree)
        if wait or metric is not None:
            self.wait()
        if metric is not None:
            self._update_best(step, metric, metric_name)
            self._gc()
        return self.ckpt_dir / str(step)

    def _commit(self, step: int, tree) -> None:
        tmp = Path(tempfile.mkdtemp(prefix=f".{step}.", dir=self.ckpt_dir))
        with open(tmp / STATE_FILE, "wb") as f:
            torch.save(tree, f)
            f.flush()
            os.fsync(f.fileno())
        final = self.ckpt_dir / str(step)
        if final.is_dir():
            # a step saved again: its file is replaced in one rename, so the
            # directory holds the old state or the new one, never neither
            os.replace(tmp / STATE_FILE, final / STATE_FILE)
            shutil.rmtree(tmp)
        else:
            os.replace(tmp, final)
        self._gc()

    def wait(self) -> None:
        """Block until the save in flight is committed; raise its error."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def _update_best(self, step: int, metric: float, metric_name: str) -> None:
        """save_top_k=1 on a max-metric (ref conf/callbacks/checkpoint/lh_sr.yaml)."""
        best = {"step": None, "metric": -np.inf, "metric_name": metric_name}
        if self._best_file.exists():
            best = json.loads(self._best_file.read_text())
        if metric >= best["metric"]:
            _write_json(self._best_file, {"step": step, "metric": metric,
                                          "metric_name": metric_name})

    def _gc(self) -> None:
        """Delete the committed steps older than the newest `keep`, never the
        best one."""
        steps = sorted((p for p in self.ckpt_dir.iterdir()
                        if p.is_dir() and p.name.isdigit()), key=lambda p: int(p.name))
        best_step = self.best_step()
        for p in steps[:-self.keep] if self.keep else []:
            if int(p.name) != best_step:
                shutil.rmtree(p)

    def restore(self, state, step: Optional[int] = None):
        """Load a step (default: the newest) into `state` in place and return
        it: the parameters and the EMA on the net's device, the optimizer's
        state beside its parameters (its `step` counters on the host, where
        torch's AdamW keeps them), and the step."""
        self.wait()
        path = (self.ckpt_dir / str(step)) if step is not None \
            else latest_checkpoint(self.ckpt_dir)
        if path is None:
            raise FileNotFoundError(f"no checkpoints under {self.ckpt_dir}")
        tree = torch.load(Path(path) / STATE_FILE, map_location=state.net.device,
                          weights_only=True)
        state.net.load_state_dict(tree["params"], strict=True)
        if set(tree["ema"]) != set(state.ema):
            raise ValueError(f"{path}: the EMA's keys are not the net's trainables")
        for name, value in state.ema.items():
            value.copy_(tree["ema"][name])
        optimizer = tree["optimizer"]
        for s in optimizer["state"].values():
            s["step"] = s["step"].cpu()
        state.optimizer.load_state_dict(optimizer)
        state.step = int(tree["step"])
        return state

    def best_step(self) -> Optional[int]:
        if self._best_file.exists():
            return json.loads(self._best_file.read_text())["step"]
        return None


def convert_run_dir(config_yaml, trees: Mapping[int, Mapping], best_json,
                    out_dir) -> Path:
    """A port run directory from a JAX one: `config.yaml` copied, each
    step's numpy trees (`params`, `ema_params`, `opt_state`, `step`: what
    the JAX `Checkpointer.restore` returns, after `jax.device_get`) saved
    under `checkpoints/` in the format above through `state_from_jax`, and
    the JAX `best.json` (a path, or None) carried over. Returns `out_dir`.

    Host-only by design: it reshapes arrays into files and does no device
    work, and it runs where the trees were read, on a machine with JAX and
    orbax that need have no CUDA. So it builds the net (for its parameter
    names and shapes) on the CPU and takes no device argument; the run
    directory it writes restores onto any device (`Checkpointer.restore`
    loads onto the net's)."""
    from ..agents import make_agent_net
    from ..training import _make_agent, load_config
    from .from_jax import state_from_jax

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(config_yaml, out / "config.yaml")
    net = make_agent_net(_make_agent(load_config(str(out / "config.yaml"), [])), device="cpu")
    ckpt = Checkpointer(out / "checkpoints", keep=len(trees))
    for step in sorted(trees):
        ckpt.save(state_from_jax(net, trees[step]), wait=True)
    if best_json is not None:
        best = json.loads(Path(best_json).read_text())
        if best["step"] is not None and best["step"] not in trees:
            raise ValueError(f"best.json names step {best['step']}, which is not among "
                             f"the converted steps {sorted(trees)}")
        _write_json(ckpt.ckpt_dir / "best.json", best)
    return out
