"""EDM diffusion numerics of the port: schedules, preconditioner, sampler,
training sigma density."""

from .densities import make_sample_density, rand_log_logistic
from .precond import append_dims, get_scalings, precond_denoise
from .samplers import SAMPLER_NAMES, sample_ddim, sample_loop
from .schedules import get_noise_schedule

__all__ = ["make_sample_density", "rand_log_logistic", "append_dims", "get_scalings", "precond_denoise", "SAMPLER_NAMES",
           "sample_ddim", "sample_loop", "get_noise_schedule"]
