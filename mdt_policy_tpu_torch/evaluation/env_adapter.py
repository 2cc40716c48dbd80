"""calvin_env adapter, the HulcWrapper equivalent (copy of
`mdt_policy_tpu/evaluation/env_adapter.py`).

Wraps the external PyBullet play-table simulator behind the Env protocol the
rollout loop consumes (re-design of `mdt/wrappers/hulc_wrapper.py:16-110`):

* obs: raw uint8 NHWC camera frames + proprio, shaped (1, T=1, ...) — pixel
  preprocessing happens on the device in the policy adapter
  (`policy_adapter.py`), not here;
* actions: 7-DoF relative action split into ((xyz), (euler), gripper) with
  gripper binarization `1 if a[-1] > 0 else -1` (ref :64-83);
* reset-to-state via (robot_obs, scene_obs) (ref :85-103).

calvin_env is an external dependency (the reference vendors it as an empty
submodule, .gitmodules:1-3); `make_calvin_env` imports it lazily and raises a
clear error when absent. The FakeEnv (evaluation/fake_env.py) implements the
same protocol for CI.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["CalvinEnvAdapter", "make_calvin_env"]


class CalvinEnvAdapter:
    def __init__(self, env):
        self.env = env

    # ---- obs ------------------------------------------------------------------

    def _process_obs(self, raw: Dict) -> Dict:
        rgb_static = np.asarray(raw["rgb_obs"]["rgb_static"], np.uint8)
        rgb_gripper = np.asarray(raw["rgb_obs"]["rgb_gripper"], np.uint8)
        return {
            "rgb_obs": {
                "rgb_static": rgb_static[None, None],
                "rgb_gripper": rgb_gripper[None, None],
            },
            "robot_obs": np.asarray(raw["robot_obs"], np.float32)[None, None],
        }

    def get_obs(self) -> Dict:
        return self._process_obs(self.env.get_obs())

    def get_info(self) -> Dict:
        return self.env.get_info()

    # ---- control ---------------------------------------------------------------

    def reset(self, robot_obs: Optional[np.ndarray] = None,
              scene_obs: Optional[np.ndarray] = None) -> Dict:
        self.env.reset(robot_obs=robot_obs, scene_obs=scene_obs)
        return self.get_obs()

    def step(self, action):
        """7-DoF relative action; gripper binarized (ref hulc_wrapper.py:64-83)."""
        action = np.asarray(action).reshape(-1)
        env_action = {
            "action": np.concatenate([action[:3], action[3:6],
                                      [1.0 if action[-1] > 0 else -1.0]]),
            "type": "cartesian_rel",
        }
        raw_obs, reward, done, info = self.env.step(env_action)
        return self._process_obs(raw_obs), reward, done, info


def make_calvin_env(dataset_path, *, show_gui: bool = False) -> CalvinEnvAdapter:
    """Build the PlayTable env from a CALVIN dataset dir (the reference's
    `get_env` path, mdt/wrappers/hulc_wrapper.py:9,19-21)."""
    try:
        from calvin_env.envs.play_table_env import get_env
    except ImportError as e:
        raise ImportError(
            "calvin_env is not installed (external PyBullet dependency); "
            "use evaluation.fake_env.FakeEnv for protocol testing") from e
    env = get_env(dataset_path, show_gui=show_gui)
    return CalvinEnvAdapter(env)
