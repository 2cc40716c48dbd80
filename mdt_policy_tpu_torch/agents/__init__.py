"""The agents of the port: the MDT-V networks with their train and
validation steps, the MDT (ResNet) networks, and the closed-loop policy that
serves both (`MDTPolicy` is `MDTVPolicy`, as in the JAX package)."""

from .config import MDTVConfig
from .mdt_agent import MDT_FROZEN_PREFIXES, MDTAgentNet, MDTConfig
from .mdtv_agent import (FROZEN_PREFIXES, MDTVAgentNet, MDTVPolicy, TrainState,
                         denoise_actions, init_random_, init_train_state,
                         make_draws, make_optimizer, train_step,
                         validation_step)

MDTPolicy = MDTVPolicy  # uniform `perceive` entry (JAX agents/__init__.py)

__all__ = ["MDTVConfig", "MDTConfig", "FROZEN_PREFIXES", "MDT_FROZEN_PREFIXES",
           "MDTAgentNet", "MDTPolicy", "MDTVAgentNet", "MDTVPolicy",
           "TrainState", "denoise_actions", "init_random_", "init_train_state",
           "make_draws", "make_optimizer", "train_step", "validation_step"]
