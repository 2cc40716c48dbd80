"""Training-time sigma densities (port of `mdt_policy_tpu/diffusion/densities.py`):
the seven families of the reference (`edm_diffusion/utils.py:154-203`) and
`make_sample_density`, which picks one by MDT-V's
`sigma_sample_density_type`. The production default is the truncated
log-logistic with loc = log(sigma_data) and scale = 0.5, truncated to
[sigma_min, sigma_max].

A density maps raw draws to sigmas, so a caller makes the draws from its own
`torch.Generator` (or hands in the same numbers as another run): a uniform
[0, 1) draw `u`, a standard normal draw `n`, both (split log-normal), or an
index into a grid (discrete). `DRAW_KINDS` names what each family takes and
`draw_sigma` makes it. Bounds that are Python floats are computed in float64
on the host, as in the JAX package; the rest is float32 on the draw's device.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence

import torch

__all__ = ["DRAW_KINDS", "draw_sigma", "rand_log_normal", "rand_log_logistic",
           "rand_log_uniform", "rand_uniform", "rand_v_diffusion",
           "rand_split_log_normal", "rand_discrete", "make_sample_density"]

# what each density takes: "uniform" (B,) in [0, 1), "normal" (B,) N(0, 1),
# "normal_uniform" (B, 2) with the normal draw in column 0 and the uniform in
# column 1, "index" (B,) int64 into the grid
DRAW_KINDS = {"lognormal": "normal", "loglogistic": "uniform", "loguniform": "uniform",
              "uniform": "uniform", "v-diffusion": "uniform",
              "split-lognormal": "normal_uniform", "discrete": "index"}


def draw_sigma(density_type: str, batch: int, generator: torch.Generator,
               n_values: Optional[int] = None) -> torch.Tensor:
    """The raw draw of `batch` sigmas of `density_type`, from `generator` on
    its device (`n_values`: the discrete grid's length)."""
    dev = generator.device
    kind = DRAW_KINDS.get(density_type)
    if kind == "uniform":
        return torch.rand((batch,), generator=generator, device=dev)
    if kind == "normal":
        return torch.randn((batch,), generator=generator, device=dev)
    if kind == "normal_uniform":
        n = torch.randn((batch,), generator=generator, device=dev)
        return torch.stack([n, torch.rand((batch,), generator=generator, device=dev)], 1)
    if kind == "index":
        if n_values is None:
            raise ValueError("discrete density needs the grid's length")
        return torch.randint(0, n_values, (batch,), generator=generator, device=dev)
    raise ValueError(f"Unknown sample density type: {density_type!r}")


def _sigmoid_f64(x: float, scale: float) -> float:
    if x == math.inf:
        return 1.0
    if x == -math.inf:
        return 0.0
    return 1.0 / (1.0 + math.exp(-x / scale))


def rand_log_normal(n: torch.Tensor, loc: float = 0.0, scale: float = 1.0) -> torch.Tensor:
    """Log-normal sigmas from a N(0, 1) draw (reference utils.py:154-156)."""
    return torch.exp(n * scale + loc)


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


def rand_log_uniform(u: torch.Tensor, min_value: float, max_value: float) -> torch.Tensor:
    """Log-uniform sigmas from a uniform draw (reference utils.py:169-173)."""
    lo, hi = math.log(min_value), math.log(max_value)
    return torch.exp(u * (hi - lo) + lo)


def rand_uniform(u: torch.Tensor, min_value: float, max_value: float) -> torch.Tensor:
    """Uniform sigmas from a uniform draw (reference utils.py:201-203)."""
    return u * (max_value - min_value) + min_value


def rand_v_diffusion(u: torch.Tensor, sigma_data: float = 1.0, min_value: float = 0.0,
                     max_value: float = float("inf")) -> torch.Tensor:
    """Truncated v-diffusion sigmas from a uniform draw (reference
    utils.py:176-181)."""
    min_cdf = math.atan(min_value / sigma_data) * 2 / math.pi
    max_cdf = math.atan(max_value / sigma_data) * 2 / math.pi if max_value != math.inf else 1.0
    u = u * (max_cdf - min_cdf) + min_cdf
    return torch.tan(u * math.pi / 2) * sigma_data


def rand_split_log_normal(nu: torch.Tensor, loc: float, scale_1: float,
                          scale_2: float) -> torch.Tensor:
    """Split log-normal sigmas from a (B, 2) draw: column 0 N(0, 1), column
    1 uniform (reference utils.py:184-191)."""
    n, u = nu[..., 0].abs(), nu[..., 1]
    ratio = scale_1 / (scale_1 + scale_2)
    return torch.exp(torch.where(u < ratio, n * -scale_1 + loc, n * scale_2 + loc))


def rand_discrete(idx: torch.Tensor, values: Sequence[float]) -> torch.Tensor:
    """The grid's sigma at each drawn index (reference utils.py:194-198)."""
    return torch.as_tensor(values, dtype=torch.float32, device=idx.device)[idx]


def make_sample_density(density_type: str, sigma_data: float, sigma_min: float,
                        sigma_max: float, *, loc: Optional[float] = None,
                        scale: Optional[float] = None, scale_1: Optional[float] = None,
                        scale_2: Optional[float] = None,
                        discrete_values: Optional[Sequence[float]] = None
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """`draw -> sigmas` of the density (JAX make_sample_density, reference
    mdtv_agent.py:552-591); `DRAW_KINDS[density_type]` says what it takes."""
    if density_type == "lognormal":
        return functools.partial(rand_log_normal, loc=loc if loc is not None else 0.0,
                                 scale=scale if scale is not None else 1.0)
    if density_type == "loglogistic":
        return functools.partial(
            rand_log_logistic, loc=loc if loc is not None else math.log(sigma_data),
            scale=scale if scale is not None else 0.5, min_value=sigma_min,
            max_value=sigma_max)
    if density_type == "loguniform":
        return functools.partial(rand_log_uniform, min_value=sigma_min, max_value=sigma_max)
    if density_type == "uniform":
        return functools.partial(rand_uniform, min_value=sigma_min, max_value=sigma_max)
    if density_type == "v-diffusion":
        return functools.partial(rand_v_diffusion, sigma_data=sigma_data,
                                 min_value=sigma_min, max_value=sigma_max)
    if density_type == "discrete":
        if discrete_values is None:
            raise ValueError("discrete density needs discrete_values")
        return functools.partial(rand_discrete, values=discrete_values)
    if density_type == "split-lognormal":
        if loc is None or scale_1 is None or scale_2 is None:
            raise ValueError("split-lognormal needs loc, scale_1, scale_2")
        return functools.partial(rand_split_log_normal, loc=loc, scale_1=scale_1,
                                 scale_2=scale_2)
    raise ValueError(f"Unknown sample density type: {density_type!r}")
