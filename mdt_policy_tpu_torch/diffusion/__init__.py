"""EDM diffusion numerics of the port: schedules, preconditioner, sampler."""

from .precond import append_dims, get_scalings, precond_denoise
from .samplers import SAMPLER_NAMES, sample_ddim, sample_loop
from .schedules import get_noise_schedule

__all__ = ["append_dims", "get_scalings", "precond_denoise", "SAMPLER_NAMES",
           "sample_ddim", "sample_loop", "get_noise_schedule"]
