"""EDM diffusion numerics of the port: schedules, preconditioner, the
sampler suite and the training sigma densities."""

from .densities import DRAW_KINDS, draw_sigma, make_sample_density, rand_log_logistic
from .precond import append_dims, get_scalings, precond_denoise
from .samplers import (SAMPLER_NAMES, denoiser_evaluations, log_likelihood, n_step_draws,
                       sample_ddim, sample_loop)
from .schedules import get_noise_schedule

__all__ = ["DRAW_KINDS", "draw_sigma", "make_sample_density", "rand_log_logistic",
           "append_dims", "get_scalings", "precond_denoise", "SAMPLER_NAMES",
           "denoiser_evaluations", "log_likelihood", "n_step_draws", "sample_ddim",
           "sample_loop", "get_noise_schedule"]
