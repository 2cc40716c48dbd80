"""EDM noise (sigma) schedules, numpy only.

A copy of `mdt_policy_tpu/diffusion/schedules.py` (the port never imports
the JAX package): the seven schedule families of the reference
(`mdt/models/edm_diffusion/gc_sampling.py:26-88`) as host `np.float32`
arrays. Every schedule ends with a terminal sigma = 0 entry, which the
sampler relies on to denoise all the way.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "append_zero",
    "get_sigmas_karras",
    "get_sigmas_exponential",
    "get_sigmas_linear",
    "cosine_beta_schedule",
    "get_sigmas_ve",
    "get_iddpm_sigmas",
    "get_sigmas_vp",
    "get_noise_schedule",
]


def append_zero(sigmas: np.ndarray) -> np.ndarray:
    """Appends a terminal sigma=0 entry (reference: gc_sampling.py:22-23).
    Returns host numpy float32."""
    sigmas = np.asarray(sigmas, dtype=np.float32)
    return np.concatenate([sigmas, np.zeros((1,), dtype=np.float32)])


def get_sigmas_karras(n: int, sigma_min: float, sigma_max: float, rho: float = 7.0) -> np.ndarray:
    """Karras et al. (2022) rho-schedule (reference: gc_sampling.py:26-32)."""
    ramp = np.linspace(0, 1, n, dtype=np.float64)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return append_zero(sigmas)


def get_sigmas_exponential(n: int, sigma_min: float, sigma_max: float) -> np.ndarray:
    """Exponential schedule — the production default for MDT
    (reference: gc_sampling.py:35-38; conf/model/mdt_agent.yaml noise_scheduler)."""
    sigmas = np.exp(np.linspace(math.log(sigma_max), math.log(sigma_min), n, dtype=np.float64))
    return append_zero(sigmas)


def get_sigmas_linear(n: int, sigma_min: float, sigma_max: float) -> np.ndarray:
    """Linear ramp from sigma_max to sigma_min (reference: gc_sampling.py:41-44)."""
    return append_zero(np.linspace(sigma_max, sigma_min, n, dtype=np.float64))


def cosine_beta_schedule(n: int, s: float = 0.008) -> np.ndarray:
    """Cosine beta schedule of Nichol & Dhariwal, flipped + zero-terminated
    (reference: gc_sampling.py:47-58)."""
    steps = n + 1
    x = np.linspace(0, steps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    betas_clipped = np.clip(betas, 0, 0.999)
    return append_zero(np.flip(betas_clipped))


def get_sigmas_ve(n: int, sigma_min: float = 0.02, sigma_max: float = 100.0) -> np.ndarray:
    """Variance-exploding schedule (reference: gc_sampling.py:61-68).

    Mirrors the reference exactly, including its use of linspace(0, n+1, n)
    as the step grid.
    """
    steps = n + 1
    t = np.linspace(0, steps, n, dtype=np.float64)
    t = (sigma_max ** 2) * ((sigma_min ** 2 / sigma_max ** 2) ** (t / (n - 1)))
    return append_zero(np.sqrt(t))


def get_iddpm_sigmas(
    n: int,
    sigma_min: float = 0.02,
    sigma_max: float = 100.0,
    M: int = 1000,
    j_0: int = 0,
    C_1: float = 0.001,
    C_2: float = 0.008,
) -> np.ndarray:
    """iDDPM sigma grid resampled to n steps (reference: gc_sampling.py:71-81)."""
    step_indices = np.arange(n, dtype=np.float64)
    u = np.zeros(M + 1, dtype=np.float64)
    alpha_bar = lambda j: np.sin(0.5 * np.pi * j / M / (C_2 + 1)) ** 2
    for j in range(M, j_0, -1):  # M, ..., 1
        u[j - 1] = np.sqrt((u[j] ** 2 + 1) / max(alpha_bar(j - 1) / alpha_bar(j), C_1) - 1)
    u_filtered = u[np.logical_and(u >= sigma_min, u <= sigma_max)]
    sigmas = u_filtered[np.round((len(u_filtered) - 1) / (n - 1) * step_indices).astype(np.int64)]
    return append_zero(sigmas)


def get_sigmas_vp(n: int, beta_d: float = 19.9, beta_min: float = 0.1, eps_s: float = 1e-3) -> np.ndarray:
    """Variance-preserving schedule (reference: gc_sampling.py:84-88)."""
    t = np.linspace(1, eps_s, n, dtype=np.float64)
    sigmas = np.sqrt(np.exp(beta_d * t ** 2 / 2 + beta_min * t) - 1)
    return append_zero(sigmas)


_SCHEDULES = {
    "karras": lambda n, smin, smax: get_sigmas_karras(n, smin, smax, 7.0),
    "exponential": get_sigmas_exponential,
    "linear": get_sigmas_linear,
    "cosine_beta": lambda n, smin, smax: cosine_beta_schedule(n),
    "ve": get_sigmas_ve,
    "iddpm": get_iddpm_sigmas,
    "vp": lambda n, smin, smax: get_sigmas_vp(n),
}


def get_noise_schedule(n_sampling_steps: int, noise_schedule_type: str,
                       sigma_min: float, sigma_max: float) -> np.ndarray:
    """Schedule dispatch mirroring `MDTVAgent.get_noise_schedule`
    (reference: mdt/models/mdtv_agent.py:660-678)."""
    try:
        fn = _SCHEDULES[noise_schedule_type]
    except KeyError:
        raise ValueError(f"Unknown noise schedule type: {noise_schedule_type!r}") from None
    return fn(n_sampling_steps, sigma_min, sigma_max)
