"""Training-time sigma density (port of `mdt_policy_tpu/diffusion/densities.py`):
the truncated log-logistic, MDT-V's `sigma_sample_density_type`, with
loc = log(sigma_data) and scale = 0.5, truncated to [sigma_min, sigma_max].

The uniform draw is an argument, so a caller makes it from its own
`torch.Generator` (or hands in the same numbers as another run). The CDF
bounds are Python floats computed in float64 on the host, as in the JAX
package; the rest is float32 on the draw's device.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import torch

__all__ = ["rand_log_logistic", "make_sample_density"]

# the JAX package's other density families, not ported yet
_UNPORTED = ("lognormal", "loguniform", "uniform", "v-diffusion", "discrete",
             "split-lognormal")


def _sigmoid_f64(x: float, scale: float) -> float:
    if x == math.inf:
        return 1.0
    if x == -math.inf:
        return 0.0
    return 1.0 / (1.0 + math.exp(-x / scale))


def rand_log_logistic(u: torch.Tensor, loc: float = 0.0, scale: float = 1.0,
                      min_value: float = 0.0,
                      max_value: float = float("inf")) -> torch.Tensor:
    """Sigmas from a uniform [0, 1) draw `u` by the inverse CDF of the
    truncated log-logistic (reference edm_diffusion/utils.py:159-166)."""
    min_cdf = _sigmoid_f64((math.log(min_value) if min_value > 0 else -math.inf) - loc, scale)
    max_cdf = _sigmoid_f64((math.log(max_value) if max_value != math.inf else math.inf) - loc,
                           scale)
    u = u * (max_cdf - min_cdf) + min_cdf
    return torch.exp(torch.log(u / (1 - u)) * scale + loc)


def make_sample_density(density_type: str, sigma_data: float, sigma_min: float,
                        sigma_max: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """`u -> sigmas` for the config's density (JAX make_sample_density)."""
    if density_type == "loglogistic":
        return functools.partial(rand_log_logistic, loc=math.log(sigma_data),
                                 scale=0.5, min_value=sigma_min, max_value=sigma_max)
    if density_type in _UNPORTED:
        raise NotImplementedError(
            f"sigma density {density_type!r} is not ported yet (ROADMAP queue A, "
            "'The rest, behind the production defaults'); the port has 'loglogistic'")
    raise ValueError(f"Unknown sample density type: {density_type!r}")
