"""Proprioceptive state processing + dataset statistics + env-reset state info
(a copy of `mdt_policy_tpu/data/proprio.py`).

Re-implements the reference's state pipeline
(`mdt/datasets/utils/episode_utils.py:14-61,160-215` +
`conf/datamodule/calvin.yaml:20-27`):

* `process_state`: normalize the 15-d CALVIN robot_obs with the dataset's
  NormalizeVector statistics, optionally keep the orientation block
  unnormalized, then slice `keep_indices` ([[0,7],[14,15]] -> 8-d proprio:
  EE pose + gripper width + gripper action).
* `load_statistics`: parse the dataset's statistics.yaml (the reference merges
  it into its hydra transform tree, episode_utils.py:178-215; here it is a
  plain mean/std table per modality).
* `get_state_info_dict`: raw robot/scene state for environment resets (the
  single-task Rollout callback's reset source, ref rollout.py:374-421).
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["ProprioConfig", "load_statistics", "process_state",
           "get_state_info_dict"]


@dataclasses.dataclass(frozen=True)
class ProprioConfig:
    """(ref conf/datamodule/calvin.yaml proprioception_dims)"""
    n_state_obs: int = 8
    keep_indices: Tuple[Tuple[int, int], ...] = ((0, 7), (14, 15))
    robot_orientation_idx: Tuple[int, int] = (3, 6)
    normalize: bool = True
    normalize_robot_orientation: bool = True


def load_statistics(dataset_dir) -> Dict[str, Dict[str, np.ndarray]]:
    """statistics.yaml -> {modality: {'mean': (D,), 'std': (D,)}}.

    The file lists hydra transform specs per modality; only NormalizeVector
    entries carry statistics (ref episode_utils.py:178-215 — the reference
    merges them over its config transforms; we read the numbers directly).
    Missing file -> {} (the reference logs a warning and changes nothing).
    """
    import yaml

    path = Path(dataset_dir) / "statistics.yaml"
    if not path.exists():
        logger.warning("no statistics.yaml under %s", dataset_dir)
        return {}
    raw = yaml.safe_load(path.read_text()) or {}
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for modality, specs in raw.items():
        if not isinstance(specs, list):
            continue
        for spec in specs:
            target = str(spec.get("_target_", ""))
            if target.rsplit(".", 1)[-1] == "NormalizeVector":
                out[modality] = {
                    "mean": np.asarray(spec.get("mean", 0.0), np.float32),
                    "std": np.asarray(spec.get("std", 1.0), np.float32),
                }
    return out


def process_state(robot_obs: np.ndarray,
                  statistics: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
                  cfg: ProprioConfig = ProprioConfig()) -> np.ndarray:
    """(..., 15) raw robot_obs -> (..., n_state_obs) proprio vector
    (ref process_state, episode_utils.py:14-61)."""
    x = np.asarray(robot_obs, np.float32)
    normalized = x
    stats = (statistics or {}).get("robot_obs")
    if cfg.normalize and stats is not None:
        std = np.where(stats["std"] == 0.0, 1.0, stats["std"])
        normalized = (x - stats["mean"]) / std
        if not cfg.normalize_robot_orientation and cfg.robot_orientation_idx:
            a, b = cfg.robot_orientation_idx
            normalized = normalized.copy()
            normalized[..., a:b] = x[..., a:b]
    out = np.concatenate([normalized[..., a:b] for a, b in cfg.keep_indices],
                         axis=-1)
    assert out.shape[-1] == cfg.n_state_obs, (out.shape, cfg.n_state_obs)
    return out


def get_state_info_dict(episode: Dict[str, np.ndarray]) -> Dict[str, Dict[str, np.ndarray]]:
    """Raw robot/scene state for env resets (ref episode_utils.py:160-176)."""
    return {"state_info": {
        "robot_obs": np.asarray(episode["robot_obs"]),
        "scene_obs": np.asarray(episode["scene_obs"]),
    }}
