"""CALVIN-free test double for the env + task-oracle protocols (copy of
`mdt_policy_tpu/evaluation/fake_env.py`: the same frames from the same seed).

The reference only exercises its rollout logic against the real PyBullet
calvin_env; SURVEY §4 recommends a fake reproducing the
`reset/step/get_obs/get_info` contract of `mdt/wrappers/hulc_wrapper.py:47-110`
so the evaluation loop, chunking and success accounting are testable in CI.
"""

from __future__ import annotations

from typing import Dict, Optional, Set

import numpy as np


class FakeEnv:
    """Emits random uint8 camera obs; tracks step counts and reset state."""

    def __init__(self, img_hw: int = 32, gripper_hw: int = 32, seed: int = 0):
        self.img_hw = img_hw
        self.gripper_hw = gripper_hw
        self.rng = np.random.default_rng(seed)
        self.robot_obs = None
        self.scene_obs = None
        self.t = 0

    def _obs(self) -> Dict:
        return {
            "rgb_obs": {
                "rgb_static": self.rng.integers(
                    0, 255, (1, 1, self.img_hw, self.img_hw, 3), dtype=np.uint8),
                "rgb_gripper": self.rng.integers(
                    0, 255, (1, 1, self.gripper_hw, self.gripper_hw, 3), dtype=np.uint8),
            },
            "robot_obs": np.zeros((1, 1, 8), np.float32),
        }

    def reset(self, robot_obs=None, scene_obs=None):
        self.robot_obs = robot_obs
        self.scene_obs = scene_obs
        self.t = 0
        return self._obs()

    def get_obs(self):
        return self._obs()

    def get_info(self) -> Dict:
        return {"t": self.t, "scene_obs": self.scene_obs}

    def step(self, action):
        self.t += 1
        return self._obs(), 0.0, False, self.get_info()


class ScriptedOracle:
    """Task oracle double: marks `subtask` solved once the env step counter
    crosses a per-task threshold."""

    def __init__(self, solve_at: Optional[Dict[str, int]] = None, default: int = 10**9):
        self.solve_at = solve_at or {}
        self.default = default

    def get_task_info_for_set(self, start_info, current_info, subtasks: Set[str]):
        solved = {t for t in subtasks
                  if current_info["t"] - start_info["t"] >= self.solve_at.get(t, self.default)}
        return solved


class RandomPolicy:
    """Policy double implementing reset()/step()."""

    def __init__(self, action_dim: int = 7, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.action_dim = action_dim

    def reset(self):
        pass

    def step(self, obs, goal):
        return self.rng.uniform(-1, 1, (1, self.action_dim)).astype(np.float32)
