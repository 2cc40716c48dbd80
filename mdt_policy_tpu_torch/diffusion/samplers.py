"""Samplers over a `denoise_fn(x, sigma) -> denoised` closure (port of
`mdt_policy_tpu/diffusion/samplers.py`). Only DDIM, the production sampler,
is ported so far; the other names of the suite raise NotImplementedError.

The sigma schedule is host numpy float32, so the per-step coefficients are
computed on the host in float32, as the JAX version computes them in f32.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["sample_ddim", "sample_loop", "SAMPLER_NAMES"]

DenoiseFn = Callable[[torch.Tensor, np.float32], torch.Tensor]

SAMPLER_NAMES = (
    "ddim", "euler", "euler_ancestral", "heun", "dpm", "ancestral",
    "dpmpp_2m", "dpmpp_2s", "dpmpp_2s_ancestral", "dpmpp_2m_sde",
    "dpmpp_2_with_lms", "lms", "dpm_fast", "dpm_adaptive",
)


def _static_sigmas(sigmas) -> np.ndarray:
    s = np.asarray(sigmas, dtype=np.float32)
    if s.ndim != 1 or s.shape[0] < 2:
        raise ValueError("sigmas must be a 1-D schedule with >= 2 entries")
    return s


def sample_ddim(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas) -> torch.Tensor:
    """DDIM / DPM-Solver-1 (reference: gc_sampling.py:922-951):

        x_{i+1} = (sigma_{i+1}/sigma_i) * x - expm1(-(t_{i+1}-t_i)) * denoised,

    with t = -log(sigma). At the terminal sigma = 0 step the ratio is 0 and
    expm1(-inf) = -1, so x becomes the last denoised value (IEEE inf
    arithmetic, no NaN)."""
    s = _static_sigmas(sigmas)
    with np.errstate(divide="ignore"):  # log(0) = -inf is intended
        for sigma, sigma_next in zip(s[:-1], s[1:]):
            denoised = denoise_fn(x, sigma)
            t, t_next = -np.log(sigma), -np.log(sigma_next)
            h = t_next - t
            x = float(sigma_next / sigma) * x - float(np.expm1(-h)) * denoised
    return x


def sample_loop(sampler_type: str, denoise_fn: DenoiseFn, x: torch.Tensor,
                sigmas) -> torch.Tensor:
    """Sampler dispatch by the reference's config names."""
    s = _static_sigmas(sigmas)
    if sampler_type == "ddim":
        return sample_ddim(denoise_fn, x, s)
    if sampler_type in SAMPLER_NAMES:
        raise NotImplementedError(
            f"sampler {sampler_type!r} is not ported yet (ROADMAP queue A, "
            "'The rest, behind the production defaults'); the port has 'ddim'")
    raise ValueError(f"Unknown sampler type: {sampler_type!r}")
