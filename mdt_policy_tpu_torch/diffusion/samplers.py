"""The k-diffusion sampler suite over a `denoise_fn(x, sigma) -> denoised`
closure (port of `mdt_policy_tpu/diffusion/samplers.py`, reference
`edm_diffusion/gc_sampling.py:164-994`).

The sigma schedule is host numpy float32, so every per-step coefficient is
computed on the host in float32, as the JAX version computes it in f32 on
its scalars, and the branches that JAX takes with `jnp.where` on sigma = 0
(the terminal Euler fallback of the second-order and ancestral steps) are
Python branches here: a step whose result JAX discards is not computed.

Randomness is passed in. A stochastic sampler takes its per-step N(0, 1)
draws as one tensor `noise` of shape (n_step_draws(...), *x.shape), where
JAX draws `jax.random.normal(keys[i], x.shape)` over `_split_keys(key, n)`:
draw i is JAX's key i (`dpmpp_2m_sde` takes two a step, keys 2i and 2i + 1).
Euler and Heun draw only under churn (`s_churn > 0`): without it JAX
multiplies its draws by 0; `sample_loop` runs DPM-2 without churn, as JAX's
does. `sample_dpm_adaptive` decides to accept or reject
each step on the host (one device sync a step), and `log_likelihood` runs a
Dormand-Prince integrator of its own with JAX's step control
(`jax.experimental.ode.odeint`) and a forward-mode product through the
denoiser (`torch.func.jvp`).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["SAMPLER_NAMES", "denoiser_evaluations", "log_likelihood", "n_step_draws",
           "sample_ddim", "sample_dpm_2", "sample_dpm_2_ancestral",
           "sample_dpm_adaptive", "sample_dpm_fast", "sample_dpmpp_2m",
           "sample_dpmpp_2s", "sample_dpmpp_2s_ancestral", "sample_dpmpp_sde",
           "sample_euler", "sample_euler_ancestral", "sample_heun", "sample_lms",
           "sample_loop"]

DenoiseFn = Callable[[torch.Tensor, np.float32], torch.Tensor]
f32 = np.float32

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


def _gammas(sigmas: np.ndarray, s_churn: float, s_tmin: float, s_tmax: float) -> np.ndarray:
    """Per-step churn factor (reference gc_sampling.py:195)."""
    n = len(sigmas) - 1
    gamma = min(s_churn / n, 2 ** 0.5 - 1) if s_churn else 0.0
    return np.where((sigmas[:-1] >= s_tmin) & (sigmas[:-1] <= s_tmax), gamma,
                    0.0).astype(np.float32)


def _ancestral_step(sigma_from: np.float32, sigma_to: np.float32, eta: float = 1.0):
    """(sigma_down, sigma_up) of an ancestral step in float32 (reference
    gc_sampling.py:102-109)."""
    if not eta:
        return f32(sigma_to), f32(0.0)
    var = f32(sigma_to ** 2) * f32(sigma_from ** 2 - sigma_to ** 2) \
        / max(f32(sigma_from ** 2), f32(1e-20))
    sigma_up = min(f32(sigma_to), f32(f32(eta) * np.sqrt(f32(var))))
    sigma_down = f32(np.sqrt(max(f32(sigma_to ** 2 - sigma_up ** 2), f32(0.0))))
    return sigma_down, sigma_up


def _to_d(x: torch.Tensor, sigma, denoised: torch.Tensor) -> torch.Tensor:
    """Karras ODE derivative (reference gc_sampling.py:91-93)."""
    return (x - denoised) / float(sigma)


def _step_noise(noise: Optional[torch.Tensor], i: int, x: torch.Tensor, name: str):
    if noise is None:
        raise ValueError(f"{name} needs its per-step draws `noise` "
                         "(n_step_draws(...), *x.shape)")
    return noise[i].to(x.dtype)


# N(0, 1) draws a step: "churn" only where a step's churn factor is > 0
_STEP_DRAWS = {"euler": "churn", "heun": "churn", "euler_ancestral": 1,
               "ancestral": 1, "dpmpp_2s_ancestral": 1, "dpmpp_2m_sde": 2}


def n_step_draws(sampler_type: str, sigmas, s_churn: float = 0.0,
                 s_tmin: float = 0.0) -> int:
    """The N(0, 1) draws of x's shape that `sample_loop(sampler_type, ...)`
    takes over the schedule `sigmas` (0 for a deterministic sampler)."""
    if sampler_type not in SAMPLER_NAMES:
        raise ValueError(f"Unknown sampler type: {sampler_type!r}")
    s = _static_sigmas(sigmas)
    per = _STEP_DRAWS.get(sampler_type, 0)
    if per == "churn":
        return len(s) - 1 if _gammas(s, s_churn, s_tmin, float("inf")).any() else 0
    return per * (len(s) - 1)


def denoiser_evaluations(sampler_type: str, sigmas) -> Optional[int]:
    """Denoiser calls of one `sample_loop` over `sigmas`: one a step, a
    second one in the steps of a second-order sampler that do not end at
    sigma = 0, `len(sigmas)` for dpm_fast; None for dpm_adaptive, whose
    step count depends on the data."""
    if sampler_type not in SAMPLER_NAMES:
        raise ValueError(f"Unknown sampler type: {sampler_type!r}")
    s = _static_sigmas(sigmas)
    n = len(s) - 1
    if sampler_type in ("heun", "dpm", "dpmpp_2s", "dpmpp_2m_sde"):
        return n + int((s[1:] != 0).sum())
    if sampler_type in ("ancestral", "dpmpp_2s_ancestral"):
        return n + int(sum(_ancestral_step(a, b)[0] != 0 for a, b in zip(s[:-1], s[1:])))
    if sampler_type == "dpm_fast":
        return len(s)
    if sampler_type == "dpm_adaptive":
        return None
    return n


def _churn(x, i, sigma, gamma, noise, s_noise, name):
    """(x, sigma_hat) after the step's churn (none when gamma is 0)."""
    sigma_hat = f32(sigma * (gamma + f32(1)))
    if gamma > 0:
        eps = _step_noise(noise, i, x, name) * s_noise
        x = x + eps * float(np.sqrt(max(f32(sigma_hat ** 2 - sigma ** 2), f32(0))))
    return x, sigma_hat


# ---------------------------------------------------------------------------
# First-order and exponential-integrator samplers
# ---------------------------------------------------------------------------

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


def sample_euler(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas, *,
                 noise: Optional[torch.Tensor] = None, s_churn: float = 0.0,
                 s_tmin: float = 0.0, s_tmax: float = float("inf"),
                 s_noise: float = 1.0) -> torch.Tensor:
    """Karras Algorithm 2, Euler variant (reference gc_sampling.py:164-210)."""
    s = _static_sigmas(sigmas)
    for i, (sigma, sigma_next, gamma) in enumerate(
            zip(s[:-1], s[1:], _gammas(s, s_churn, s_tmin, s_tmax))):
        x, sigma_hat = _churn(x, i, sigma, gamma, noise, s_noise, "euler")
        d = _to_d(x, sigma_hat, denoise_fn(x, sigma_hat))
        x = x + d * float(sigma_next - sigma_hat)
    return x


def sample_euler_ancestral(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas, *,
                           noise: Optional[torch.Tensor] = None,
                           eta: float = 1.0) -> torch.Tensor:
    """Ancestral Euler (reference gc_sampling.py:213-253)."""
    s = _static_sigmas(sigmas)
    for i, (sigma, sigma_next) in enumerate(zip(s[:-1], s[1:])):
        denoised = denoise_fn(x, sigma)
        sigma_down, sigma_up = _ancestral_step(sigma, sigma_next, eta)
        x = x + _to_d(x, sigma, denoised) * float(sigma_down - sigma)
        if sigma_down > 0:
            x = x + _step_noise(noise, i, x, "euler_ancestral") * float(sigma_up)
    return x


# ---------------------------------------------------------------------------
# Second-order samplers
# ---------------------------------------------------------------------------

def sample_heun(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas, *,
                noise: Optional[torch.Tensor] = None, s_churn: float = 0.0,
                s_tmin: float = 0.0, s_tmax: float = float("inf"),
                s_noise: float = 1.0) -> torch.Tensor:
    """Karras Algorithm 2 with the Heun correction (reference
    gc_sampling.py:256-311); Euler on the step to sigma = 0."""
    s = _static_sigmas(sigmas)
    for i, (sigma, sigma_next, gamma) in enumerate(
            zip(s[:-1], s[1:], _gammas(s, s_churn, s_tmin, s_tmax))):
        x, sigma_hat = _churn(x, i, sigma, gamma, noise, s_noise, "heun")
        d = _to_d(x, sigma_hat, denoise_fn(x, sigma_hat))
        dt = float(sigma_next - sigma_hat)
        x_euler = x + d * dt
        if sigma_next == 0:
            x = x_euler
            continue
        d_2 = _to_d(x_euler, sigma_next, denoise_fn(x_euler, sigma_next))
        x = x + (d + d_2) / 2 * dt
    return x


def sample_dpm_2(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas, *,
                 noise: Optional[torch.Tensor] = None, s_churn: float = 0.0,
                 s_tmin: float = 0.0, s_tmax: float = float("inf"),
                 s_noise: float = 1.0) -> torch.Tensor:
    """DPM-Solver-2, midpoint in log sigma (reference gc_sampling.py:314-372);
    Euler on the step to sigma = 0."""
    s = _static_sigmas(sigmas)
    for i, (sigma, sigma_next, gamma) in enumerate(
            zip(s[:-1], s[1:], _gammas(s, s_churn, s_tmin, s_tmax))):
        x, sigma_hat = _churn(x, i, sigma, gamma, noise, s_noise, "dpm")
        d = _to_d(x, sigma_hat, denoise_fn(x, sigma_hat))
        if sigma_next == 0:
            x = x + d * float(sigma_next - sigma_hat)
            continue
        sigma_mid = f32(np.exp(f32(np.log(sigma_hat) + np.log(sigma_next)) / f32(2)))
        x_2 = x + d * float(sigma_mid - sigma_hat)
        d_2 = _to_d(x_2, sigma_mid, denoise_fn(x_2, sigma_mid))
        x = x + d_2 * float(sigma_next - sigma_hat)
    return x


def sample_dpm_2_ancestral(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas, *,
                           noise: Optional[torch.Tensor] = None,
                           eta: float = 1.0) -> torch.Tensor:
    """Ancestral DPM-Solver-2, the reference's `'ancestral'` sampler_type
    (reference gc_sampling.py:375-410)."""
    s = _static_sigmas(sigmas)
    for i, (sigma, sigma_next) in enumerate(zip(s[:-1], s[1:])):
        denoised = denoise_fn(x, sigma)
        sigma_down, sigma_up = _ancestral_step(sigma, sigma_next, eta)
        d = _to_d(x, sigma, denoised)
        if sigma_down == 0:
            x = x + d * float(sigma_down - sigma)
            continue
        sigma_mid = f32(np.exp(f32(np.log(sigma) + np.log(sigma_down)) / f32(2)))
        x_2 = x + d * float(sigma_mid - sigma)
        d_2 = _to_d(x_2, sigma_mid, denoise_fn(x_2, sigma_mid))
        x = x + d_2 * float(sigma_down - sigma) \
            + _step_noise(noise, i, x, "ancestral") * float(sigma_up)
    return x


def sample_dpmpp_2m(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas) -> torch.Tensor:
    """DPM-Solver++(2M), multistep (reference gc_sampling.py:699-733); the
    first step and the step to sigma = 0 are single-step updates."""
    s = _static_sigmas(sigmas)
    old_denoised = None
    with np.errstate(divide="ignore"):
        for i, (sigma, sigma_next) in enumerate(zip(s[:-1], s[1:])):
            denoised = denoise_fn(x, sigma)
            t, t_next = -np.log(sigma), -np.log(sigma_next)
            h = f32(t_next - t)
            if i == 0 or sigma_next == 0:
                denoised_d = denoised
            else:
                r = f32(f32(t - (-np.log(s[i - 1]))) / h)
                a = f32(f32(1) + f32(1) / f32(f32(2) * r))
                b = f32(f32(1) / f32(f32(2) * r))
                denoised_d = float(a) * denoised - float(b) * old_denoised
            x = float(sigma_next / sigma) * x - float(np.expm1(-h)) * denoised_d
            old_denoised = denoised
    return x


def sample_dpmpp_2s(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas) -> torch.Tensor:
    """DPM-Solver++(2S) (reference gc_sampling.py:955-994); Euler on the
    step to sigma = 0."""
    s = _static_sigmas(sigmas)
    for sigma, sigma_next in zip(s[:-1], s[1:]):
        denoised = denoise_fn(x, sigma)
        if sigma_next == 0:
            x = x + _to_d(x, sigma, denoised) * float(sigma_next - sigma)
            continue
        t, t_next = -np.log(sigma), -np.log(sigma_next)
        h = f32(t_next - t)
        sig_mid = f32(np.exp(-f32(t + f32(0.5) * h)))
        x_2 = float(sig_mid / sigma) * x - float(np.expm1(-h * f32(0.5))) * denoised
        denoised_2 = denoise_fn(x_2, sig_mid)
        x = float(sigma_next / sigma) * x - float(np.expm1(-h)) * denoised_2
    return x


def sample_dpmpp_2s_ancestral(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas, *,
                              noise: Optional[torch.Tensor] = None, eta: float = 1.0,
                              s_noise: float = 1.0) -> torch.Tensor:
    """Ancestral DPM-Solver++(2S) (reference gc_sampling.py:873-919)."""
    s = _static_sigmas(sigmas)
    for i, (sigma, sigma_next) in enumerate(zip(s[:-1], s[1:])):
        denoised = denoise_fn(x, sigma)
        sigma_down, sigma_up = _ancestral_step(sigma, sigma_next, eta)
        if sigma_down == 0:
            x = x + _to_d(x, sigma, denoised) * float(sigma_down - sigma)
        else:
            t, t_next = -np.log(sigma), -np.log(sigma_down)
            h = f32(t_next - t)
            sig_mid = f32(np.exp(-f32(t + f32(0.5) * h)))
            x_2 = float(sig_mid / sigma) * x - float(np.expm1(-h * f32(0.5))) * denoised
            denoised_2 = denoise_fn(x_2, sig_mid)
            x = float(sigma_down / sigma) * x - float(np.expm1(-h)) * denoised_2
        if sigma_up > 0:
            x = x + _step_noise(noise, i, x, "dpmpp_2s_ancestral") * s_noise \
                * float(sigma_up)
    return x


def sample_dpmpp_sde(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas, *,
                     noise: Optional[torch.Tensor] = None, eta: float = 1.0,
                     s_noise: float = 1.0, r: float = 0.5) -> torch.Tensor:
    """DPM-Solver++ (stochastic) (reference gc_sampling.py:736-792), with the
    JAX package's Brownian pair: a step's two draws are n1 = noise[2i] and
    n2 = rho n1 + sqrt(1 - rho^2) noise[2i + 1], rho^2 = (sigma - sig_mid) /
    (sigma - sigma_next); Euler on the step to sigma = 0."""
    s = _static_sigmas(sigmas)
    for i, (sigma, sigma_next) in enumerate(zip(s[:-1], s[1:])):
        denoised = denoise_fn(x, sigma)
        if sigma_next == 0:
            x = x + _to_d(x, sigma, denoised) * float(sigma_next - sigma)
            continue
        t, t_next = -np.log(sigma), -np.log(sigma_next)
        h = f32(t_next - t)
        fac = 1 / (2 * r)
        sig_mid = f32(np.exp(-f32(t + h * f32(r))))
        rho = f32(np.sqrt(np.clip(f32(f32(sigma - sig_mid) / f32(sigma - sigma_next)),
                                  f32(0), f32(1))))
        n1 = _step_noise(noise, 2 * i, x, "dpmpp_2m_sde")
        n2 = float(rho) * n1 + float(np.sqrt(f32(f32(1) - rho * rho))) \
            * _step_noise(noise, 2 * i + 1, x, "dpmpp_2m_sde")
        # step 1
        sd, su = _ancestral_step(sigma, sig_mid, eta)
        s_ = f32(-np.log(max(sd, f32(1e-10))))
        x_2 = float(np.exp(-s_) / sigma) * x - float(np.expm1(f32(t - s_))) * denoised
        x_2 = x_2 + n1 * s_noise * float(su)
        denoised_2 = denoise_fn(x_2, sig_mid)
        # step 2
        sd, su = _ancestral_step(sigma, sigma_next, eta)
        t_next_ = f32(-np.log(max(sd, f32(1e-10))))
        denoised_d = (1 - fac) * denoised + fac * denoised_2
        x = float(np.exp(-t_next_) / sigma) * x \
            - float(np.expm1(f32(t - t_next_))) * denoised_d
        x = x + n2 * s_noise * float(su)
    return x


# ---------------------------------------------------------------------------
# Linear multistep
# ---------------------------------------------------------------------------

def _lms_coeff(order: int, t: np.ndarray, i: int, j: int) -> float:
    """Adams-Bashforth coefficient by quadrature (reference
    gc_sampling.py:413-426)."""
    from scipy import integrate

    def fn(tau):
        prod = 1.0
        for k in range(order):
            if j == k:
                continue
            prod *= (tau - t[i - k]) / (t[i - j] - t[i - k])
        return prod

    return integrate.quad(fn, t[i], t[i + 1], epsrel=1e-4)[0]


@functools.lru_cache(maxsize=64)
def _lms_coeffs(sigmas: tuple, order: int) -> tuple:
    """Each step's float32 coefficients, from the float64 schedule."""
    t = np.asarray(sigmas, dtype=np.float32).astype(np.float64)
    return tuple(tuple(f32(_lms_coeff(min(i + 1, order), t, i, j))
                       for j in range(min(i + 1, order))) for i in range(len(t) - 1))


def sample_lms(denoise_fn: DenoiseFn, x: torch.Tensor, sigmas, *,
               order: int = 4) -> torch.Tensor:
    """Linear multistep (reference gc_sampling.py:429-465): the quadrature
    coefficients, which depend only on the schedule, computed on the host
    in float64 and rounded to float32 (once per schedule), as the JAX
    version precomputes them."""
    s = _static_sigmas(sigmas)
    ds = []  # the last `order` derivatives, most recent first
    for sigma, coeffs in zip(s[:-1], _lms_coeffs(tuple(s.tolist()), order)):
        ds = [_to_d(x, sigma, denoise_fn(x, sigma))] + ds[:order - 1]
        update = float(coeffs[0]) * ds[0]
        for c, d in zip(coeffs[1:], ds[1:]):
            update = update + float(c) * d
        x = x + update
    return x


# ---------------------------------------------------------------------------
# DPM-Solver fast (fixed evaluations, orders 1/2/3)
# ---------------------------------------------------------------------------

def sample_dpm_fast(denoise_fn: DenoiseFn, x: torch.Tensor, sigma_min: float,
                    sigma_max: float, n: int) -> torch.Tensor:
    """DPM-Solver-Fast with `n` denoiser calls (reference
    gc_sampling.py:524-616, 672-696, eta = 0): the order sequence is fixed
    by `n`, so the steps are a fixed chain of 1st/2nd/3rd-order
    exponential-integrator updates with float64 host coefficients."""
    if sigma_min <= 0 or sigma_max <= 0:
        raise ValueError("sigma_min and sigma_max must be > 0")
    t_start, t_end = -math.log(sigma_max), -math.log(sigma_min)
    m = n // 3 + 1
    ts = np.linspace(t_start, t_end, m + 1, dtype=np.float64)
    orders = [3] * (m - 2) + [2, 1] if n % 3 == 0 else [3] * (m - 1) + [n % 3]

    def eps_at(x, t):
        sigma = math.exp(-t)
        return (x - denoise_fn(x, f32(sigma))) / sigma

    for i, order in enumerate(orders):
        t, t_next = float(ts[i]), float(ts[i + 1])
        h = t_next - t
        eps = eps_at(x, t)
        if order == 1:
            x = x - math.exp(-t_next) * math.expm1(h) * eps
        elif order == 2:
            r1 = 0.5
            s1 = t + r1 * h
            u1 = x - math.exp(-s1) * math.expm1(r1 * h) * eps
            eps_r1 = eps_at(u1, s1)
            x = (x - math.exp(-t_next) * math.expm1(h) * eps
                 - math.exp(-t_next) / (2 * r1) * math.expm1(h) * (eps_r1 - eps))
        else:
            r1, r2 = 1 / 3, 2 / 3
            s1, s2 = t + r1 * h, t + r2 * h
            u1 = x - math.exp(-s1) * math.expm1(r1 * h) * eps
            eps_r1 = eps_at(u1, s1)
            u2 = (x - math.exp(-s2) * math.expm1(r2 * h) * eps
                  - math.exp(-s2) * (r2 / r1) * (math.expm1(r2 * h) / (r2 * h) - 1)
                  * (eps_r1 - eps))
            eps_r2 = eps_at(u2, s2)
            x = (x - math.exp(-t_next) * math.expm1(h) * eps
                 - math.exp(-t_next) / r2 * (math.expm1(h) / h - 1) * (eps_r2 - eps))
    return x


# ---------------------------------------------------------------------------
# DPM-Solver adaptive (PID-controlled step size)
# ---------------------------------------------------------------------------

def sample_dpm_adaptive(denoise_fn: DenoiseFn, x: torch.Tensor, sigma_min: float,
                        sigma_max: float, *, order: int = 3, rtol: float = 0.05,
                        atol: float = 0.0078, h_init: float = 0.05, pcoeff: float = 0.0,
                        icoeff: float = 1.0, dcoeff: float = 0.0,
                        accept_safety: float = 0.81, eta: float = 0.0,
                        s_noise: float = 1.0, max_steps: int = 256,
                        generator: Optional[torch.Generator] = None,
                        stats: Optional[dict] = None) -> torch.Tensor:
    """DPM-Solver-12/23 with a PID-controlled step (reference
    gc_sampling.py:618-669, controller :495-521, with the JAX package's
    corrected noise and its first half-step that seeds the controller).
    JAX keeps the loop on the device (`lax.while_loop`); here the step's
    error norm comes to the host, which accepts or rejects it, so a call
    syncs once a step and cannot be captured in a CUDA graph. A rejected
    step reuses the step's first evaluation. `generator` gives the
    per-step draws when eta > 0. `stats`, when given, receives the steps,
    the accepted ones, the denoiser calls and each step's controller
    factor (accepted where >= accept_safety)."""
    if order not in (2, 3):
        raise ValueError("order should be 2 or 3")
    if eta and generator is None:
        raise ValueError("sample_dpm_adaptive with eta > 0 needs a generator")
    t_start, t_end = -math.log(sigma_max), -math.log(sigma_min)
    t_end32 = f32(t_end)
    pid_order = 1.5 if eta else order
    b1 = (pcoeff + icoeff + dcoeff) / pid_order
    b2 = -(pcoeff + 2 * dcoeff) / pid_order
    b3 = dcoeff / pid_order
    calls = [0]

    def sigma_of(t):
        return f32(np.exp(-f32(t)))

    def eps_at(x, t):
        sig = sigma_of(t)
        calls[0] += 1
        return (x - denoise_fn(x, max(sig, f32(1e-10)))) / float(sig)

    def low_high(x, t, t_next, eps):
        """(x_low, x_high): solvers 1 and 2, or 2 (r1 = 1/3) and 3, which
        share their first midpoint evaluation."""
        h = f32(t_next - t)
        sig_next = sigma_of(t_next)
        if order == 2:
            s1 = f32(t + f32(0.5) * h)
            u1 = x - float(sigma_of(s1) * f32(np.expm1(f32(0.5) * h))) * eps
            eps_r1 = eps_at(u1, s1)
            x_low = x - float(sig_next * f32(np.expm1(h))) * eps
            x_high = (x - float(sig_next * f32(np.expm1(h))) * eps
                      - float(sig_next / f32(2 * 0.5) * f32(np.expm1(h))) * (eps_r1 - eps))
            return x_low, x_high
        r1, r2 = f32(1 / 3), f32(2 / 3)
        s1, s2 = f32(t + r1 * h), f32(t + r2 * h)
        u1 = x - float(sigma_of(s1) * f32(np.expm1(r1 * h))) * eps
        eps_r1 = eps_at(u1, s1)
        x_low = (x - float(sig_next * f32(np.expm1(h))) * eps
                 - float(sig_next / f32(2 * r1) * f32(np.expm1(h))) * (eps_r1 - eps))
        em2 = f32(np.expm1(r2 * h))
        u2 = (x - float(sigma_of(s2) * em2) * eps
              - float(sigma_of(s2) * f32(r2 / r1) * f32(em2 / f32(r2 * h) - f32(1)))
              * (eps_r1 - eps))
        eps_r2 = eps_at(u2, s2)
        x_high = (x - float(sig_next * f32(np.expm1(h))) * eps
                  - float(sig_next / r2 * f32(f32(np.expm1(h)) / h - f32(1)))
                  * (eps_r2 - eps))
        return x_low, x_high

    def error(x_low, x_high, x_prev):
        delta = torch.clamp(rtol * torch.maximum(x_low.abs(), x_prev.abs()), min=atol)
        return f32(_norm((x_low - x_high) / delta) / f32(x.numel() ** 0.5))

    # the first half-step seeds the controller's error history (JAX :684-697)
    s, h = f32(t_start), f32(abs(h_init))
    eps = eps_at(x, s)
    x_low, x_high = low_high(x, s, min(t_end32, f32(t_start + abs(h_init))), eps)
    inv0 = f32(f32(1) / f32(error(x_low, x_high, x) + f32(1e-8)))
    errs = (inv0, inv0)
    x_prev, steps, accepted, factors = x, 0, 0, []
    while s < f32(t_end - 1e-5) and steps < max_steps:
        t = min(t_end32, f32(s + h))
        if eta:
            sd, _ = _ancestral_step(sigma_of(s), sigma_of(t), eta)
            t_ = min(t_end32, f32(-np.log(max(sd, f32(1e-20)))))
            su = f32(np.sqrt(max(f32(sigma_of(t) ** 2 - sigma_of(t_) ** 2), f32(0))))
        else:
            t_, su = t, f32(0)
        if eps is None:
            eps = eps_at(x, s)
        x_low, x_high = low_high(x, s, t_, eps)
        e0 = f32(f32(1) / f32(error(x_low, x_high, x_prev) + f32(1e-8)))
        factor = f32(e0 ** f32(b1) * errs[0] ** f32(b2) * errs[1] ** f32(b3))
        factor = f32(f32(1) + f32(np.arctan(f32(factor - f32(1)))))
        factors.append(float(factor))
        steps += 1
        if factor >= f32(accept_safety):
            x_new = x_high
            if su > 0:
                x_new = x_high + float(su) * s_noise * torch.randn(
                    x.shape, generator=generator, device=x.device, dtype=x.dtype)
            x, x_prev, s, errs = x_new, x_low, t, (e0, errs[0])
            eps = None  # a new x: the next step evaluates it
            accepted += 1
        h = f32(h * factor)
    if stats is not None:
        stats.update(steps=steps, accepted=accepted, evaluations=calls[0],
                     factors=factors)
    return x


# ---------------------------------------------------------------------------
# Log-likelihood: probability-flow ODE, Dormand-Prince, Hutchinson trace
# ---------------------------------------------------------------------------

_DOPRI_ALPHA = (1 / 5, 3 / 10, 4 / 5, 8 / 9, 1., 1., 0)
_DOPRI_BETA = ((1 / 5, 0, 0, 0, 0, 0, 0), (3 / 40, 9 / 40, 0, 0, 0, 0, 0),
               (44 / 45, -56 / 15, 32 / 9, 0, 0, 0, 0),
               (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0, 0),
               (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0, 0),
               (35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0))
_DOPRI_SOL = (35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0)
_DOPRI_ERR = (35 / 384 - 1951 / 21600, 0, 500 / 1113 - 22642 / 50085,
              125 / 192 - 451 / 720, -2187 / 6784 - -12231 / 42400,
              11 / 84 - 649 / 6300, -1. / 60.)
_DOPRI_MID = (6025192743 / 30085553152 / 2, 0, 51252292925 / 65400821598 / 2,
              -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
              -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2)


def _norm(v: torch.Tensor) -> np.float32:
    return f32(torch.linalg.vector_norm(v).item())


def _odeint_dopri5(func, y0: torch.Tensor, t0: float, t1: float, rtol: float,
                   atol: float, stats: Optional[dict] = None) -> torch.Tensor:
    """y(t1) of dy/dt = func(y, t) from y(t0) = y0 (a flat float32 vector),
    by `jax.experimental.ode.odeint`'s Dormand-Prince with its initial step,
    its error ratio, its step control and its 4th-order interpolation at
    t1; the accept/reject decisions on the host. `stats` receives the steps
    and the accepted ones."""
    tab = lambda rows: torch.tensor(rows, dtype=y0.dtype, device=y0.device)
    beta, c_sol, c_err, c_mid = (tab(_DOPRI_BETA), tab(_DOPRI_SOL), tab(_DOPRI_ERR),
                                 tab(_DOPRI_MID))
    t0, t1 = f32(t0), f32(t1)
    f0 = func(y0, t0)
    # initial step (Hairer, Norsett & Wanner, Sec. II.4)
    scale = atol + y0.abs() * rtol
    d0, d1 = _norm(y0 / scale), _norm(f0 / scale)
    h0 = f32(1e-6) if (d0 < 1e-5 or d1 < 1e-5) else f32(f32(0.01) * d0 / d1)
    f1 = func(y0 + float(h0) * f0, f32(t0 + h0))
    d2 = f32(_norm((f1 - f0) / scale) / h0)
    h1 = max(f32(1e-6), f32(h0 * f32(1e-3))) if (d1 <= 1e-15 and d2 <= 1e-15) \
        else f32(f32(f32(0.01) / max(d1, d2)) ** f32(1. / (4 + 1.)))
    dt = max(min(f32(f32(100.) * h0), h1), f32(0))
    y, f, t, last_t = y0, f0, t0, t0
    interp = [y0] * 5
    steps = accepted = 0
    while t < t1 and dt > 0:
        steps += 1
        k = [f]
        for i in range(1, 7):
            k.append(func(y + float(dt) * (beta[i - 1, :i] @ torch.stack(k)),
                          f32(t + dt * f32(_DOPRI_ALPHA[i - 1]))))
        k = torch.stack(k)
        y_next = float(dt) * (c_sol @ k) + y
        y_err = float(dt) * (c_err @ k)
        err_tol = atol + rtol * torch.maximum(y.abs(), y_next.abs())
        ratio = f32(torch.sqrt(torch.mean((y_err / err_tol) ** 2)).item())
        # 4th-order fit through y, y_next and the step's midpoint
        y_mid = y + float(dt) * (c_mid @ k)
        k0, k1 = k[0], k[-1]
        at = lambda c: float(f32(c) * dt)
        fit = [at(-2.) * k0 + at(2.) * k1 - 8. * y - 8. * y_next + 16. * y_mid,
               at(5.) * k0 - at(3.) * k1 + 18. * y + 14. * y_next - 32. * y_mid,
               at(-4.) * k0 + float(dt) * k1 - 11. * y - 5. * y_next + 16. * y_mid,
               float(dt) * k0, y]
        # the next step (safety 0.9, growth <= 10, shrink >= 0.2, order 5)
        if ratio == 0:
            new_dt = f32(dt * f32(10.0))
        else:
            dfactor = f32(1.0) if ratio < 1 else f32(0.2)
            new_dt = f32(dt * min(f32(10.0), max(f32(ratio ** f32(-1.0 / 5.0) * f32(0.9)),
                                                 dfactor)))
        if ratio <= 1:
            y, f, last_t, t, interp = y_next, k[-1], t, f32(t + dt), fit
            accepted += 1
        dt = max(new_dt, f32(0))
    if stats is not None:
        stats.update(steps=steps, accepted=accepted)
    rel = float(f32(f32(t1 - last_t) / f32(t - last_t)))
    out = interp[0]
    for c in interp[1:]:
        out = out * rel + c
    return out


def log_likelihood(denoise_fn: DenoiseFn, x: torch.Tensor, sigma_min: float,
                   sigma_max: float, *, v: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None, atol: float = 1e-4,
                   rtol: float = 1e-4, stats: Optional[dict] = None) -> torch.Tensor:
    """Log-likelihood (B,) of x under the probability-flow ODE with a
    Hutchinson trace estimator (reference gc_sampling.py:468-492): the ODE
    integrated from sigma_min to sigma_max by `_odeint_dopri5`, its
    divergence estimated as v . (J v) with the forward-mode product
    `torch.func.jvp` through the denoiser. `v` is the Rademacher draw of x's
    shape (JAX's `jax.random.rademacher`), else drawn from `generator`.
    `stats` as `_odeint_dopri5` takes it."""
    if v is None:
        if generator is None:
            raise ValueError("log_likelihood needs the Rademacher draw `v` or a generator")
        v = torch.randint(0, 2, x.shape, generator=generator,
                          device=x.device).to(torch.float32) * 2 - 1
    v = v.to(device=x.device, dtype=torch.float32)
    B, n = x.shape[0], x.numel()

    def ode(y: torch.Tensor, sigma: np.float32) -> torch.Tensor:
        def d_of(xx):
            return (xx - denoise_fn(xx, max(sigma, f32(1e-10)))) / float(sigma)
        d, jvp_v = torch.func.jvp(d_of, (y[:n].view(x.shape),), (v,))
        d_ll = (v * jvp_v).reshape(B, -1).sum(dim=1)
        return torch.cat([d.reshape(-1), d_ll])

    y0 = torch.cat([x.reshape(-1).float(), x.new_zeros((B,), dtype=torch.float32)])
    y1 = _odeint_dopri5(ode, y0, sigma_min, sigma_max, rtol, atol, stats)
    latent, delta_ll = y1[:n].view(x.shape), y1[n:]
    d = int(np.prod(x.shape[1:]))
    ll_prior = (-0.5 * ((latent / sigma_max) ** 2).reshape(B, -1).sum(dim=1)
                - 0.5 * d * math.log(2 * math.pi * sigma_max ** 2))
    return ll_prior + delta_ll


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def sample_loop(sampler_type: str, denoise_fn: DenoiseFn, x: torch.Tensor, sigmas, *,
                noise: Optional[torch.Tensor] = None, s_churn: float = 0.0,
                s_tmin: float = 0.0, stats: Optional[dict] = None) -> torch.Tensor:
    """Sampler dispatch by the reference's config names (JAX sample_loop,
    reference mdtv_agent.py:593-658). `noise`: the per-step draws,
    (n_step_draws(sampler_type, sigmas, s_churn, s_tmin), *x.shape);
    `stats`: dpm_adaptive's step counts."""
    s = _static_sigmas(sigmas)
    if sampler_type == "ddim":
        return sample_ddim(denoise_fn, x, s)
    if sampler_type in ("euler", "heun"):
        fn = sample_euler if sampler_type == "euler" else sample_heun
        return fn(denoise_fn, x, s, noise=noise, s_churn=s_churn, s_tmin=s_tmin)
    if sampler_type == "dpm":  # without churn, as JAX's sample_loop calls it
        return sample_dpm_2(denoise_fn, x, s)
    if sampler_type == "euler_ancestral":
        return sample_euler_ancestral(denoise_fn, x, s, noise=noise)
    if sampler_type == "ancestral":
        return sample_dpm_2_ancestral(denoise_fn, x, s, noise=noise)
    if sampler_type in ("dpmpp_2m", "dpmpp_2_with_lms"):
        # the reference's dpmpp_2_with_lms has dpmpp_2m's body
        # (gc_sampling.py:796-830 against :699-733)
        return sample_dpmpp_2m(denoise_fn, x, s)
    if sampler_type == "dpmpp_2s":
        return sample_dpmpp_2s(denoise_fn, x, s)
    if sampler_type == "dpmpp_2s_ancestral":
        return sample_dpmpp_2s_ancestral(denoise_fn, x, s, noise=noise)
    if sampler_type == "dpmpp_2m_sde":
        return sample_dpmpp_sde(denoise_fn, x, s, noise=noise)
    if sampler_type == "lms":
        return sample_lms(denoise_fn, x, s)
    if sampler_type == "dpm_fast":
        return sample_dpm_fast(denoise_fn, x, float(s[-2]), float(s[0]), len(s))
    if sampler_type == "dpm_adaptive":
        # the schedule's end points bound it (reference mdtv_agent.py:637-639)
        return sample_dpm_adaptive(denoise_fn, x, float(s[-2]), float(s[0]), stats=stats)
    raise ValueError(f"Unknown sampler type: {sampler_type!r}")
