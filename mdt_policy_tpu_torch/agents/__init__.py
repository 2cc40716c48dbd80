"""The MDT-V agent of the port (inference)."""

from .config import MDTVConfig
from .mdtv_agent import MDTVAgentNet, MDTVPolicy, denoise_actions, init_random_

__all__ = ["MDTVConfig", "MDTVAgentNet", "MDTVPolicy", "denoise_actions",
           "init_random_"]
