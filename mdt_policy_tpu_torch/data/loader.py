"""Evaluation-time preprocessing of raw camera frames (the `eval_batch` part
of `mdt_policy_tpu/data/loader.py::Preprocessor`), on the port's
`data/transforms.py`. The training loader is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..agents.mdtv_agent import default_device
from .transforms import preprocess_rgb_eval

__all__ = ["Preprocessor"]


class Preprocessor:
    """Raw uint8 frames -> the agent's float32 input frames on `device`
    (default: CUDA): the static camera resized to `static_size`, the gripper
    to `gripper_size`, the foresight frames to `gen_size`, then /255 and
    CLIP-normalized (the production eval pipelines, calvin_transforms.yaml)."""

    def __init__(self, *, static_size: int = 224, gripper_size: int = 84,
                 gen_size: int = 112, device=None):
        self.sizes = {"rgb_static": static_size, "rgb_gripper": gripper_size,
                      "gen_static": gen_size, "gen_gripper": gen_size}
        self.device = default_device(device)

    def eval_batch(self, raw: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Camera keys through the eval pipeline, `actions` as float32; other
        array keys pass through as tensors, lists and object arrays are
        dropped (as in JAX). A goal-image call carries only `rgb_static`."""
        out = {}
        for key, value in raw.items():
            if isinstance(value, list) or getattr(value, "dtype", None) == object:
                continue
            x = torch.as_tensor(np.asarray(value)).to(self.device)
            if key in self.sizes:
                x = preprocess_rgb_eval(x, size=self.sizes[key])
            elif key == "actions":
                x = x.float()
            out[key] = x
        return out
