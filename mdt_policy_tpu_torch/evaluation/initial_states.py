"""Deterministic environment initial states for evaluation chains (copy of
`mdt_policy_tpu/evaluation/initial_states.py`).

Re-implements `get_env_state_for_initial_condition`
(`mdt/evaluation/utils.py:277-345`): a fixed neutral robot pose plus a scene
vector assembled from the symbolic initial condition, with the residual
randomness (table-slot shuffle, block z-rotations) seeded by
fnv1_32(str(initial_condition.values())) — bit-compatible with the reference
because utils.fnv reproduces pyhash's UTF-16-LE hashing and temp_seed uses the
same legacy MT19937 stream.

Scene layout (CALVIN scene_obs, 24-dim):
  [0] slider pos   [1] drawer pos   [3] lightbulb switch  [4] lightbulb  [5] led
  [6:12]  red block  (xyz + euler)   [12:18] blue block    [18:24] pink block
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..utils.fnv import fnv1_32
from .sequences import temp_seed

__all__ = ["get_env_state_for_initial_condition", "NEUTRAL_ROBOT_OBS"]

# neutral reset pose: EE pose (xyz + euler + gripper width) and 7 joint angles
# + gripper action (ref evaluation/utils.py:278-296)
NEUTRAL_ROBOT_OBS = np.array([
    0.02586889, -0.2313129, 0.5712808,
    3.09045411, -0.02908596, 1.50013585,
    0.07999963,
    -1.21779124, 1.03987629, 2.11978254, -2.34205014, -0.87015899, 1.64119093,
    0.55344928,
    1.0,
])

_BLOCK_SLIDER_LEFT = np.array([-2.40851662e-01, 9.24044687e-02, 4.60990009e-01])
_BLOCK_SLIDER_RIGHT = np.array([7.03416330e-02, 9.24044687e-02, 4.60990009e-01])
_BLOCK_TABLE_SLOTS = (
    np.array([5.00000896e-02, -1.20000177e-01, 4.59990009e-01]),
    np.array([2.29995412e-01, -1.19995140e-01, 4.59990010e-01]),
)


def get_env_state_for_initial_condition(
    initial_condition: Dict,
) -> Tuple[np.ndarray, np.ndarray]:
    robot_obs = NEUTRAL_ROBOT_OBS.copy()
    rot_z_range = (np.pi / 2 - np.pi / 8, np.pi / 2 + np.pi / 8)
    block_table = [_BLOCK_TABLE_SLOTS[0].copy(), _BLOCK_TABLE_SLOTS[1].copy()]

    # deterministic per-condition seed; str(dict.values()) reproduces the
    # reference's hashed text exactly (utils.py:305)
    seed = fnv1_32(str(initial_condition.values()))
    with temp_seed(seed):
        np.random.shuffle(block_table)

        scene_obs = np.zeros(24)
        if initial_condition["slider"] == "left":
            scene_obs[0] = 0.28
        if initial_condition["drawer"] == "open":
            scene_obs[1] = 0.22
        if initial_condition["lightbulb"] == 1:
            scene_obs[3] = 0.088
        scene_obs[4] = initial_condition["lightbulb"]
        scene_obs[5] = initial_condition["led"]

        # red block (ref :319-325)
        if initial_condition["red_block"] == "slider_right":
            scene_obs[6:9] = _BLOCK_SLIDER_RIGHT
        elif initial_condition["red_block"] == "slider_left":
            scene_obs[6:9] = _BLOCK_SLIDER_LEFT
        else:
            scene_obs[6:9] = block_table[0]
        scene_obs[11] = np.random.uniform(*rot_z_range)

        # blue block — NOTE: the `red_block == "table"` branch is the
        # reference's own behavior (utils.py:331), kept for bit-parity
        if initial_condition["blue_block"] == "slider_right":
            scene_obs[12:15] = _BLOCK_SLIDER_RIGHT
        elif initial_condition["blue_block"] == "slider_left":
            scene_obs[12:15] = _BLOCK_SLIDER_LEFT
        elif initial_condition["red_block"] == "table":
            scene_obs[12:15] = block_table[1]
        else:
            scene_obs[12:15] = block_table[0]
        scene_obs[17] = np.random.uniform(*rot_z_range)

        # pink block (ref :337-343)
        if initial_condition["pink_block"] == "slider_right":
            scene_obs[18:21] = _BLOCK_SLIDER_RIGHT
        elif initial_condition["pink_block"] == "slider_left":
            scene_obs[18:21] = _BLOCK_SLIDER_LEFT
        else:
            scene_obs[18:21] = block_table[1]
        scene_obs[23] = np.random.uniform(*rot_z_range)

    return robot_obs, scene_obs
