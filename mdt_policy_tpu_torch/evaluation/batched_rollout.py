"""Batched multi-environment CALVIN evaluation (copy of
`mdt_policy_tpu/evaluation/batched_rollout.py`).

The reference evaluates 1000 chains strictly serially — one PyBullet env, one
policy call per env step (`mdt/evaluation/mdt_evaluate.py:112-220`), so eval
wall-time is sim-plus-policy latency times ~1.8M steps. This loop runs N
envs concurrently:

* env.step calls fan out to a thread pool (PyBullet is host CPU; threads
  overlap sim time across envs),
* the policy is called ONCE per tick on the stacked obs batch: one batched
  replan of all N action chunks together,
* chains advance in lockstep per subtask: every env in the wave runs subtask
  j of its own chain; finished/failed envs stop stepping (their sim state
  freezes, exactly like the serial loop's subtask boundary), and the wave
  moves on when all are done. Chunk phases stay aligned, so the
  re-plan-every-`multistep` semantics match the serial rollout exactly.

Policy protocol: `reset_batch(n)` + `step_batch(obs_batch, goals) ->
(N, action_dim)`; `BatchedPolicyAdapter` wraps a batched predict function with
per-wave action-chunk caching; `policy_adapter.make_batched_predict` is the
predict of the port's nets.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .initial_states import get_env_state_for_initial_condition
from .sequences import get_sequences

logger = logging.getLogger(__name__)

__all__ = ["BatchedPolicyAdapter", "evaluate_policy_batched"]


class BatchedPolicyAdapter:
    """Action-chunked batched policy: re-plans all N chunks every `multistep`
    ticks (the reference's per-env chunking, mdtv_agent.py:721-746, batched)."""

    def __init__(self, predict_batch: Callable, multistep: int = 10):
        self.predict_batch = predict_batch  # (obs_batch, goals) -> (N, W, A)
        self.multistep = multistep
        self.tick = 0
        self.plans: Optional[np.ndarray] = None

    def reset(self):
        self.tick = 0
        self.plans = None

    def step_batch(self, obs_batch: Dict[str, np.ndarray], goals) -> np.ndarray:
        if self.tick % self.multistep == 0:
            self.plans = np.asarray(self.predict_batch(obs_batch, goals))
        action = self.plans[:, self.tick % self.multistep]
        self.tick += 1
        if self.tick == self.multistep:
            self.tick = 0
        return action


def _stack_obs(obs_list: Sequence[Dict]) -> Dict[str, np.ndarray]:
    """Stack per-env obs dicts {'rgb_obs': {...}, ...} into batch arrays
    (leading env axis; squeezes the per-env (1,1,...) wrapping)."""
    out = {}
    first = obs_list[0]
    for k, v in first["rgb_obs"].items():
        out[k] = np.concatenate([o["rgb_obs"][k] for o in obs_list], axis=0)
    if "robot_obs" in first:
        out["robot_obs"] = np.concatenate([o["robot_obs"] for o in obs_list], axis=0)
    return out


def evaluate_policy_batched(
    policy: BatchedPolicyAdapter,
    envs: Sequence,
    task_oracle,
    goal_fn: Callable[[str], Dict],
    *,
    num_sequences: int = 1000,
    ep_len: int = 360,
    progress: bool = True,
) -> List[int]:
    """Run `num_sequences` chains over `len(envs)` concurrent envs.
    Returns per-chain consecutive-success counts (same contract as
    rollout.evaluate_policy)."""
    n = len(envs)
    sequences = get_sequences(num_sequences)
    results: List[int] = [0] * len(sequences)
    pool = ThreadPoolExecutor(max_workers=n)

    for wave_start in range(0, len(sequences), n):
        wave = list(range(wave_start, min(wave_start + n, len(sequences))))
        active_envs = envs[: len(wave)]
        # reset each env to its chain's initial state (threaded)
        def reset_one(i_env, seq_idx):
            initial_state, _ = sequences[seq_idx]
            robot_obs, scene_obs = get_env_state_for_initial_condition(dict(initial_state))
            return active_envs[i_env].reset(robot_obs=robot_obs, scene_obs=scene_obs)
        list(pool.map(lambda t: reset_one(*t), enumerate(wave)))

        success_counts = np.zeros(len(wave), np.int32)
        failed = np.zeros(len(wave), bool)

        for subtask_idx in range(5):
            live = [i for i in range(len(wave)) if not failed[i]]
            if not live:
                break
            subtasks = [sequences[wave[i]][1][subtask_idx] for i in range(len(wave))]
            goals = [goal_fn(subtasks[i]) for i in range(len(wave))]
            policy.reset()
            start_infos = [active_envs[i].get_info() for i in range(len(wave))]
            done = failed.copy()  # failed envs never step again
            obs_list = [active_envs[i].get_obs() for i in range(len(wave))]

            for _step in range(ep_len):
                if done.all():
                    break
                obs_batch = _stack_obs(obs_list)
                actions = policy.step_batch(obs_batch, goals)

                def step_one(i):
                    if done[i]:
                        return None
                    obs, _, _, info = active_envs[i].step(actions[i])
                    return obs, info

                stepped = list(pool.map(step_one, range(len(wave))))
                for i, res in enumerate(stepped):
                    if res is None:
                        continue
                    obs, info = res
                    obs_list[i] = obs
                    solved = task_oracle.get_task_info_for_set(
                        start_infos[i], info, {subtasks[i]})
                    if solved:
                        success_counts[i] += 1
                        done[i] = True

            # envs that never solved this subtask fail out of the chain
            for i in range(len(wave)):
                if not failed[i] and success_counts[i] <= subtask_idx:
                    failed[i] = True

        for i, seq_idx in enumerate(wave):
            results[seq_idx] = int(success_counts[i])
        if progress:
            logger.info("wave %d-%d done | running avg len %.2f",
                        wave[0], wave[-1],
                        float(np.mean(results[: wave[-1] + 1])))
    pool.shutdown()
    return results
