"""Env-facing rollout policies: raw env obs -> the port's policy inputs
(port of `mdt_policy_tpu/evaluation/policy_adapter.py`).

The env protocol (ref mdt/wrappers/hulc_wrapper.py:47-62) emits nested raw
uint8 camera obs `{'rgb_obs': {'rgb_static': ...}}`, while `MDTVPolicy`
consumes flat, CLIP-normalized frames. `PreprocessingPolicy` bridges the two
for the serial loop (`evaluation/rollout.py`), `make_batched_predict` for
the batched one (`evaluation/batched_rollout.py`). Either agent net works:
`MDTVPolicy` serves both.

Under a profile (`utils/profiling.py`) an env step is the span
`policy.step` (its rid the replan cycle), an evaluator tick `eval.tick`
(its rid the tick), each with the raw frames' preprocessing
(`policy.preprocess`, `eval.preprocess`), the replan (`policy.plan`, on
the steps that replan) and the action's copy to the host, where the host
waits on the card (`policy.fetch`, `eval.fetch`).
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..agents.mdtv_agent import MDTVPolicy
from ..data.loader import Preprocessor
from ..utils.profiling import span

__all__ = ["PreprocessingPolicy", "make_batched_predict", "make_rollout_policy"]


def _preprocessor(net) -> Preprocessor:
    cfg = net.cfg
    return Preprocessor(static_size=cfg.img_size, gripper_size=min(84, cfg.img_size),
                        gen_size=cfg.gen_img_res, device=net.device)


class PreprocessingPolicy:
    """Wraps an `MDTVPolicy` with on-device eval preprocessing of raw env
    observations (and of raw uint8 goal images for the 'vis' modality)."""

    def __init__(self, policy: MDTVPolicy, preprocessor: Preprocessor):
        self.inner = policy
        self.pp = preprocessor
        # (raw goal frame, processed): holding the raw object pins it, so its
        # identity cannot be recycled
        self._goal_cache = (None, None)
        self._cycles = 0  # replans so far: the rid of a cycle's spans

    def reset(self):
        self.inner.reset()

    def step(self, obs: Dict, goal: Dict) -> np.ndarray:
        if self.inner.rollout_step_counter == 0:
            self._cycles += 1
        with span("policy.step", self._cycles):
            with span("policy.preprocess"):
                batch = self.pp.eval_batch({
                    "rgb_static": obs["rgb_obs"]["rgb_static"],
                    "rgb_gripper": obs["rgb_obs"]["rgb_gripper"],
                })
                if "rgb_static_goal" in goal:
                    # the goal is constant for a whole rollout: cache by frame identity
                    raw = goal["rgb_static_goal"]
                    if self._goal_cache[0] is not raw:
                        g = self.pp.eval_batch({"rgb_static": np.asarray(raw)})
                        self._goal_cache = (raw, g["rgb_static"][:, -1])
                    goal = {**goal, "rgb_static_goal": self._goal_cache[1]}
            action = self.inner.step({"rgb_static": batch["rgb_static"],
                                      "rgb_gripper": batch["rgb_gripper"]}, goal)
            with span("policy.fetch"):
                return action.cpu().numpy()


def make_rollout_policy(net, *, generator: Optional[torch.Generator] = None
                        ) -> PreprocessingPolicy:
    """Chunked policy and raw-obs preprocessing in one object, on the net's
    device."""
    return PreprocessingPolicy(MDTVPolicy(net, generator), _preprocessor(net))


def _stack_goals(goals: Sequence[Dict]) -> Dict[str, np.ndarray]:
    """Per-env goal dicts -> one batched goal: tokens (N, L) or embeddings
    (N, E)."""
    if "lang_tokens" in goals[0]:
        return {"lang_tokens": np.concatenate(
            [np.asarray(g["lang_tokens"]).reshape(1, -1) for g in goals])}
    return {"lang": np.stack([np.asarray(g["lang"]).reshape(-1) for g in goals])}


def make_batched_predict(net, *, generator: Optional[torch.Generator] = None
                         ) -> Callable[[Dict[str, np.ndarray], Sequence[Dict]], np.ndarray]:
    """`predict_batch(obs_batch, goals) -> (N, W, A)` for
    `BatchedPolicyAdapter`: one replan of all N envs as one batch through
    `MDTVPolicy.plan`, the text tower once per set of goals."""
    policy, pp = MDTVPolicy(net, generator), _preprocessor(net)
    ticks = itertools.count()

    def predict_batch(obs_batch: Dict[str, np.ndarray], goals: Sequence[Dict]) -> np.ndarray:
        with span("eval.tick", next(ticks)):
            with span("eval.preprocess"):
                batch = pp.eval_batch({k: obs_batch[k] for k in ("rgb_static", "rgb_gripper")})
                goal = _stack_goals(goals)
            chunk = policy.plan(batch, goal)
            with span("eval.fetch"):
                return chunk.cpu().numpy()

    return predict_batch
