"""Closed-loop CALVIN evaluation loop (port of
`mdt_policy_tpu/evaluation/rollout.py`; video recording is not ported yet).

Re-implements the reference's evaluation loop
(`mdt/evaluation/mdt_evaluate.py:50-220`) against two small protocols instead
of calvin_env-specific types, so the same loop runs the real PyBullet env
(via an adapter) or the FakeEnv test double (SURVEY §4 recommends a
CALVIN-free harness for rollout-logic tests):

Env protocol (matches mdt/wrappers/hulc_wrapper.py:47-110):
    reset(robot_obs, scene_obs) -> obs
    get_obs() -> obs ; get_info() -> info
    step(action) -> (obs, reward, done, info)

Oracle protocol (calvin_env Tasks):
    get_task_info_for_set(start_info, current_info, {subtask}) -> set of solved

Policy protocol (reference inference protocol, mdt_agent.py:661-729):
    reset() ; step(obs, goal) -> action
"""

from __future__ import annotations

import json
import logging
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from .initial_states import get_env_state_for_initial_condition
from .sequences import get_sequences

logger = logging.getLogger(__name__)

__all__ = ["count_success", "evaluate_policy", "evaluate_sequence", "rollout",
           "LangEmbeddings", "print_and_save"]


def count_success(results: Sequence[int]) -> List[float]:
    """Per-chain-position success rates (ref mdt_evaluate.py:50-57):
    step_success[i] = fraction of chains that completed >= i+1 subtasks."""
    count = Counter(results)
    step_success = []
    for i in range(1, 6):
        n_success = sum(count[j] for j in range(i, 6))
        step_success.append(n_success / len(results))
    return step_success


class LangEmbeddings:
    """Precomputed language-goal lookup (ref evaluation/utils.py:219-240):
    maps a validation annotation string to its embedding from embeddings.npy."""

    def __init__(self, val_dataset_path, lang_folder: str = "lang_clip_resnet50"):
        embeddings = np.load(
            Path(val_dataset_path) / lang_folder / "embeddings.npy",
            allow_pickle=True).item()
        self.lang_embeddings = {v["ann"][0]: v["emb"] for v in embeddings.values()}

    def get_lang_goal(self, lang_text: str) -> Dict:
        return {"lang": np.asarray(self.lang_embeddings[lang_text]).squeeze(),
                "lang_text": lang_text}


def rollout(env, model, task_oracle, subtask: str, goal: Dict,
            ep_len: int = 360) -> bool:
    """Single-subtask closed loop (ref mdt_evaluate.py:185-220)."""
    obs = env.get_obs()
    model.reset()
    start_info = env.get_info()
    for _step in range(ep_len):
        action = model.step(obs, goal)
        obs, _, _, current_info = env.step(action)
        if task_oracle.get_task_info_for_set(start_info, current_info, {subtask}):
            return True
    return False


def evaluate_sequence(env, model, task_oracle, initial_state: Dict,
                      eval_sequence: Sequence[str], goal_fn,
                      ep_len: int = 360) -> int:
    """Run one 5-task chain; returns the count of consecutive successes
    (ref mdt_evaluate.py:157-182). `goal_fn(subtask) -> goal dict`."""
    robot_obs, scene_obs = get_env_state_for_initial_condition(initial_state)
    env.reset(robot_obs=robot_obs, scene_obs=scene_obs)
    success_counter = 0
    for subtask in eval_sequence:
        goal = goal_fn(subtask)
        success = rollout(env, model, task_oracle, subtask, goal, ep_len)
        # ref mdt_evaluate.py debug prints (:166-171,199-203)
        logger.debug("subtask %-28s | %-45s | %s", subtask,
                     goal.get("lang_text", ""), "success" if success else "fail")
        if not success:
            return success_counter
        success_counter += 1
    return success_counter


def evaluate_policy(model, env, task_oracle, goal_fn, *, num_sequences: int = 1000,
                    ep_len: int = 360, sequence_indices: Optional[Sequence[int]] = None,
                    progress: bool = True) -> List[int]:
    """Full benchmark (ref mdt_evaluate.py:112-154). `sequence_indices` shards
    chains across hosts (the RolloutLongHorizon DDP sharding equivalent,
    rollout_long_horizon.py:42-78)."""
    eval_sequences = get_sequences(num_sequences)
    if sequence_indices is not None:
        eval_sequences = [eval_sequences[i] for i in sequence_indices]
    results: List[int] = []
    for i, (initial_state, eval_sequence) in enumerate(eval_sequences):
        results.append(evaluate_sequence(env, model, task_oracle, initial_state,
                                         eval_sequence, goal_fn, ep_len))
        if progress and (i + 1) % 50 == 0:
            srs = count_success(results)
            avg = sum(srs)
            logger.info("chains %d/%d | %s | avg len %.2f", i + 1,
                        len(eval_sequences),
                        " ".join(f"{s*100:.1f}%" for s in srs), avg)
    return results


def print_and_save(results: Sequence[int], num_sequences: int, log_dir,
                   epoch: str = "0") -> Dict:
    """Aggregate + persist results.json (ref mdt_evaluate.py:60-109)."""
    sequences = get_sequences(num_sequences)
    avg_seq_len = float(np.mean(results))
    chain_sr = {i + 1: sr for i, sr in enumerate(count_success(results))}

    cnt_success, cnt_fail = Counter(), Counter()
    for result, (_, sequence) in zip(results, sequences):
        for successful_task in sequence[:result]:
            cnt_success[successful_task] += 1
        if result < len(sequence):
            cnt_fail[sequence[result]] += 1
    total = cnt_success + cnt_fail
    task_info = {t: {"success": cnt_success[t], "total": total[t]} for t in total}

    data = {"avg_seq_len": avg_seq_len, "chain_sr": chain_sr, "task_info": task_info}
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    results_file = log_dir / "results.json"
    previous = {}
    if results_file.exists():
        previous = json.loads(results_file.read_text())
    results_file.write_text(json.dumps({**previous, epoch: data}, indent=2))
    return data
