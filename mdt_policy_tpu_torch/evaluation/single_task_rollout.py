"""Single-task validation rollouts — the `Rollout` callback equivalent
(`mdt/rollout/rollout.py:27-427`; a copy of
`mdt_policy_tpu/evaluation/single_task_rollout.py`: the `task_dict.npy`
files of either package load in the other).

During validation the reference discovers solvable (start_state, task) pairs
from validation batches by resetting the env to a window's first/last states
and asking the oracle which task the demo completed (ref :374-421); then it
rolls the policy out per task and logs per-task success rates (ref :275-372).

Here the demo-discovery and rollout halves are separate, protocol-based
functions; task-id selection strategies match the reference
(select_first / balanced / longest, ref :27-51).
"""

from __future__ import annotations

import logging
from collections import Counter, defaultdict
from functools import partial
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from ..data.windows import get_validation_window_size

logger = logging.getLogger(__name__)

__all__ = ["select_first", "select_balanced", "select_longest",
           "discover_tasks", "state_pairs_from_batch", "SingleTaskRollout",
           "save_task_dict", "load_task_dict"]


def save_task_dict(path, task_to_states: Dict[str, List[Dict]]):
    """Persist discovered (task -> reset states) so discovery survives
    restarts (the reference stores these dicts in the Lightning checkpoint,
    rollout.py:404-415; here they live beside the run's checkpoints)."""
    from pathlib import Path

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, np.asarray(task_to_states, dtype=object), allow_pickle=True)
    return path


def load_task_dict(path) -> Dict[str, List[Dict]]:
    return np.load(path, allow_pickle=True).item()


def state_pairs_from_batch(batch: Dict) -> List[Tuple[Dict, Dict]]:
    """Build discovery state pairs from a validation batch that carries raw
    state info (dataset `include_scene_obs=True`; the reference reads
    state_info dicts off the val dataloader, rollout.py:374-421): pair i =
    (first frame state, goal/last frame state)."""
    rb = np.asarray(batch["robot_obs"])
    sc = np.asarray(batch["scene_obs"])
    return [
        ({"robot_obs": rb[i, 0], "scene_obs": sc[i, 0]},
         {"robot_obs": rb[i, -1], "scene_obs": sc[i, -1]})
        for i in range(len(rb))
    ]


def select_first(all_task_ids: Sequence[int], num: int, *a, **k) -> List[int]:
    """(ref rollout.py:27-31)"""
    return list(all_task_ids)[:num]


def select_balanced(all_task_ids: Sequence[int], num: int, *a, **k) -> List[int]:
    """(ref rollout.py:34-39)"""
    split_ids = np.array_split(sorted(all_task_ids), num)[: len(all_task_ids)]
    return [int(ids[0]) for ids in split_ids if len(ids)]


def select_longest(all_task_ids: Sequence[int], num: int,
                   min_window_size: int, max_window_size: int) -> List[int]:
    """(ref rollout.py:42-50) — hash-deterministic window size as the key."""
    key = partial(get_validation_window_size, min_window_size=min_window_size,
                  max_window_size=max_window_size)
    return sorted(all_task_ids, key=key, reverse=True)[:num]


SELECTORS = {"select_first": select_first, "select_balanced": select_balanced,
             "select_longest": select_longest}


def discover_tasks(env, task_oracle, state_pairs: Sequence[Tuple[Dict, Dict]]
                   ) -> Dict[str, List[int]]:
    """Map demo windows to the single task they complete (ref :374-421):
    reset the env to the window's first and last state and ask the oracle.
    `state_pairs[i]` = (start_state, end_state) with robot_obs/scene_obs."""
    task_to_ids: Dict[str, List[int]] = defaultdict(list)
    for i, (start, end) in enumerate(state_pairs):
        env.reset(robot_obs=start["robot_obs"], scene_obs=start["scene_obs"])
        start_info = env.get_info()
        env.reset(robot_obs=end["robot_obs"], scene_obs=end["scene_obs"])
        end_info = env.get_info()
        tasks = task_oracle.get_task_info_for_set(start_info, end_info, None) \
            if getattr(task_oracle, "supports_all", False) \
            else task_oracle.get_task_info(start_info, end_info)
        if len(tasks) == 1:
            task_to_ids[next(iter(tasks))].append(i)
    return dict(task_to_ids)


class SingleTaskRollout:
    """Per-task rollout evaluation; logs tasks/{task}_sr and average SR
    (ref Rollout.on_validation_epoch_end, :192-209)."""

    def __init__(self, env, task_oracle, goal_fn: Callable[[str], Dict], *,
                 ep_len: int = 240, rollouts_per_task: int = 10,
                 id_selection_strategy: str = "select_first",
                 min_window_size: int = 21, max_window_size: int = 50,
                 modalities: Sequence[str] = ("lang",)):
        self.env = env
        self.task_oracle = task_oracle
        self.goal_fn = goal_fn
        self.ep_len = ep_len
        self.rollouts_per_task = rollouts_per_task
        self.select = SELECTORS[id_selection_strategy]
        self.min_window_size = min_window_size
        self.max_window_size = max_window_size
        for m in modalities:
            if m not in ("lang", "vis"):
                raise ValueError(f"unknown rollout modality {m!r}")
        self.modalities = tuple(modalities)

    def _goal_for(self, mod: str, task: str, state) -> Dict:
        """'lang': the task's validation sentence through goal_fn; 'vis':
        the demo's end state rendered as a goal image (the reference uses the
        batch's last frame, rollout.py:324-330 — resetting the env to the end
        state renders the same accomplished scene)."""
        if mod == "lang":
            return self.goal_fn(task)
        if not (isinstance(state, (tuple, list)) and len(state) == 2):
            raise ValueError(
                "vis-modality rollouts need (start_state, end_state) pairs "
                "in task_to_states (see state_pairs_from_batch)")
        obs_goal = self.env.reset(robot_obs=state[1]["robot_obs"],
                                  scene_obs=state[1]["scene_obs"])
        return {"rgb_static_goal": obs_goal["rgb_obs"]["rgb_static"]}

    def __call__(self, policy, task_to_states: Dict[str, List]
                 ) -> Dict[str, float]:
        """task_to_states: {task: [reset states]} or {task: [(start, end)
        state pairs]} (required for the 'vis' modality). From discover_tasks
        or a precomputed dictionary — the reference persists these in the
        ckpt."""
        from .rollout import rollout

        counts = Counter()
        successes = Counter()
        for task, states in task_to_states.items():
            ids = self.select(list(range(len(states))), self.rollouts_per_task,
                              self.min_window_size, self.max_window_size)
            for mod in self.modalities:
                for i in ids:
                    st = states[i]
                    goal = self._goal_for(mod, task, st)
                    start = st[0] if isinstance(st, (tuple, list)) else st
                    self.env.reset(robot_obs=start["robot_obs"],
                                   scene_obs=start["scene_obs"])
                    ok = rollout(self.env, policy, self.task_oracle, task,
                                 goal.get("lang_text", task), goal, self.ep_len)
                    counts[(task, mod)] += 1
                    successes[(task, mod)] += int(ok)
        single = len(self.modalities) == 1
        metrics = {
            (f"tasks/{t}_sr" if single else f"tasks/{t}_{m}_sr"):
                successes[(t, m)] / counts[(t, m)]
            for (t, m) in counts
        }
        if counts:
            metrics["tasks/average_sr"] = (
                sum(successes.values()) / sum(counts.values()))
            if not single:
                for mod in self.modalities:
                    c = sum(v for (t, m), v in counts.items() if m == mod)
                    s = sum(v for (t, m), v in successes.items() if m == mod)
                    metrics[f"tasks/average_{mod}_sr"] = s / c if c else 0.0
        for k, v in sorted(metrics.items()):
            logger.info("%s: %.2f", k, v)
        return metrics
