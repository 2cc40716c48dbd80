"""The MDT-V agent of the port: networks, train and validation steps,
closed-loop policy."""

from .config import MDTVConfig
from .mdtv_agent import (FROZEN_PREFIXES, MDTVAgentNet, MDTVPolicy, TrainState,
                         denoise_actions, init_random_, init_train_state,
                         make_draws, make_optimizer, train_step,
                         validation_step)

__all__ = ["MDTVConfig", "FROZEN_PREFIXES", "MDTVAgentNet", "MDTVPolicy",
           "TrainState", "denoise_actions", "init_random_", "init_train_state",
           "make_draws", "make_optimizer", "train_step", "validation_step"]
