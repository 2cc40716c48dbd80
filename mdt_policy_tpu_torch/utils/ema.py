"""Exponential moving average of the trainable parameters (a copy of
`mdt_policy_tpu/utils/ema.py`):

    decay(step) = clip(1 - (1 + step/inv_gamma)^(-power), min_value, max_value)
    ema <- ema - (1 - decay) * (ema - params)

with the production power 2/3, inv_gamma 1, min 0, max 0.9999. The train
step passes the step counter after its increment, so the decay is 0 at the
first step and the EMA starts equal to the parameters.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

__all__ = ["ema_decay", "ema_update"]


def ema_decay(step: int, *, inv_gamma: float = 1.0, power: float = 2.0 / 3.0,
              min_value: float = 0.0, max_value: float = 0.9999,
              start_step: int = 0) -> float:
    """Warmup decay schedule (reference ema.py:84-91), in float32."""
    eff = np.float32(max(0, step - start_step - 1))
    value = np.float32(1.0) - (np.float32(1.0) + eff / np.float32(inv_gamma)) \
        ** np.float32(-power)
    return float(np.clip(value, np.float32(min_value), np.float32(max_value)))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor],
               params: Iterable[Tuple[str, torch.Tensor]], decay: float) -> None:
    """ema[name] <- ema[name] - (1 - decay) * (ema[name] - param), in place."""
    one_minus = float(np.float32(1.0) - np.float32(decay))
    for name, p in params:
        e = ema[name]
        e.sub_((e - p) * one_minus)
