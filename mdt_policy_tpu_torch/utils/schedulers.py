"""Tri-stage learning-rate schedule (a copy of
`mdt_policy_tpu/utils/schedulers.py`, kept here so the port never imports
the JAX package).

  warmup: lr = init + (peak - init) * step / warmup_steps   (linear)
  hold:   lr = peak
  decay:  lr = final + 0.5 * (peak - final) * (1 + cos(pi * s / decay_steps))
  after:  lr = final

Evaluated in float32, as the JAX version is, at the step counter before
the update (optax's schedule, and the reference's, read it pre-increment).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

__all__ = ["tri_stage_schedule", "lr_schedule_from_cfg"]


def lr_schedule_from_cfg(cfg) -> Callable[[int], float]:
    """The schedule of an agent config's optimizer / lr_scheduler blocks."""
    return tri_stage_schedule(
        peak_lr=cfg.optimizer.learning_rate,
        init_lr_scale=cfg.lr_scheduler.init_lr_scale,
        final_lr_scale=cfg.lr_scheduler.final_lr_scale,
        total_steps=cfg.lr_scheduler.total_steps,
        phase_ratio=cfg.lr_scheduler.phase_ratio)


def tri_stage_schedule(peak_lr: float = 1e-4, init_lr_scale: float = 0.1,
                       final_lr_scale: float = 1e-6, total_steps: int = 50_000,
                       phase_ratio=(0.02, 0.08, 0.9)) -> Callable[[int], float]:
    warmup_steps = int(total_steps * phase_ratio[0])
    hold_steps = int(total_steps * phase_ratio[1])
    decay_steps = int(total_steps * phase_ratio[2])
    init_lr = init_lr_scale * peak_lr
    final_lr = final_lr_scale * peak_lr
    warmup_rate = (peak_lr - init_lr) / warmup_steps if warmup_steps else 0.0
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        if step < warmup_steps:
            return float(f32(init_lr) + f32(warmup_rate) * step)
        if step < warmup_steps + hold_steps:
            return float(f32(peak_lr))
        if step <= warmup_steps + hold_steps + decay_steps:
            s_decay = step - f32(warmup_steps + hold_steps)
            cos = np.cos(s_decay / f32(decay_steps) * f32(math.pi))
            return float(f32(final_lr) + f32(0.5 * (peak_lr - final_lr)) * (f32(1) + cos))
        return float(f32(final_lr))

    return schedule
