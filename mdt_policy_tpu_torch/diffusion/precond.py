"""Karras (EDM) preconditioner as plain functions over an
`inner_fn(actions, sigma) -> model_out` closure (port of
`mdt_policy_tpu/diffusion/precond.py`).

    c_skip = sigma_data^2 / (sigma^2 + sigma_data^2)
    c_out  = sigma * sigma_data / sqrt(sigma^2 + sigma_data^2)
    c_in   = 1 / sqrt(sigma^2 + sigma_data^2)
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["append_dims", "get_scalings", "precond_loss", "precond_denoise"]

InnerFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def append_dims(x: torch.Tensor, target_ndim: int) -> torch.Tensor:
    """Appends trailing singleton dims up to `target_ndim`."""
    dims_to_append = target_ndim - x.ndim
    if dims_to_append < 0:
        raise ValueError(f"input has {x.ndim} dims but target_ndim is {target_ndim}")
    return x[(...,) + (None,) * dims_to_append]


def get_scalings(sigma: torch.Tensor, sigma_data: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(c_skip, c_out, c_in)."""
    var = sigma ** 2 + sigma_data ** 2
    c_skip = sigma_data ** 2 / var
    c_out = sigma * sigma_data * torch.rsqrt(var)
    c_in = torch.rsqrt(var)
    return c_skip, c_out, c_in


def precond_loss(inner_fn: InnerFn, actions: torch.Tensor, noise: torch.Tensor,
                 sigma: torch.Tensor, sigma_data: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score-matching loss in the preconditioned space (reference
    score_wrappers.py:45-63): the mean over every element of
    (F(c_in * noised, sigma) - (a - c_skip * noised) / c_out)^2, noised =
    a + noise * sigma. Returns (loss, model output). The agents' steps keep
    their own loss code; this is the library function."""
    c_skip, c_out, c_in = (append_dims(c, actions.ndim)
                           for c in get_scalings(sigma, sigma_data))
    noised = actions + noise * append_dims(sigma, actions.ndim)
    model_out = inner_fn(noised * c_in, sigma)
    target = (actions - c_skip * noised) / c_out
    return torch.mean(torch.square(model_out - target)), model_out


def precond_denoise(inner_fn: InnerFn, actions: torch.Tensor,
                    sigma: torch.Tensor, sigma_data: float) -> torch.Tensor:
    """D(x, sigma) = c_out * F(c_in * x, sigma) + c_skip * x."""
    c_skip, c_out, c_in = (append_dims(c, actions.ndim)
                           for c in get_scalings(sigma, sigma_data))
    return inner_fn(actions * c_in, sigma) * c_out + actions * c_skip
