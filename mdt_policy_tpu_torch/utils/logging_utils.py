"""Metrics logging: CSV + console (a copy of
`mdt_policy_tpu/utils/logging_utils.py`; the wandb/LearningRateMonitor
equivalent, `mdt/training.py:101-121`). wandb is used when asked for and
importable; everything lands in metrics.csv under the run dir."""

from __future__ import annotations

import csv
import logging
import time
from pathlib import Path
from typing import Dict, Optional

logger = logging.getLogger(__name__)

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, run_dir, *, use_wandb: bool = False, project: str = "mdt_torch",
                 run_name: Optional[str] = None, config: Optional[dict] = None):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._csv_path = self.run_dir / "metrics.csv"
        self._fieldnames: Optional[list] = None
        self._t0 = time.time()
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(project=project, name=run_name,
                                         dir=str(self.run_dir), config=config)
            except Exception as e:  # wandb is optional
                logger.warning("wandb unavailable (%s); CSV-only logging", e)

    def log(self, metrics: Dict[str, float], step: int):
        row = {"step": step, "wall_time": round(time.time() - self._t0, 2)}
        row.update({k: float(v) for k, v in metrics.items()})
        write_header = not self._csv_path.exists() or self._fieldnames is None
        if self._fieldnames is None:
            self._fieldnames = list(row.keys())
        extra = [k for k in row if k not in self._fieldnames]
        if extra:
            self._fieldnames.extend(extra)
            write_header = True  # schema grew; rewrite header lazily
        with open(self._csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_image(self, name: str, file_path, step: int):
        """Register an image artifact (already on disk under the run dir)
        with wandb when active — the reference's wandb.Image logging of
        masked-foresight reconstructions (mdt/models/mdt_agent.py:403-417)."""
        if self._wandb is not None:
            try:
                import wandb
                self._wandb.log({name: wandb.Image(str(file_path))}, step=step)
            except Exception as e:
                logger.warning("wandb image log failed: %s", e)

    def info(self, msg: str, *args):
        logger.info(msg, *args)

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
