"""CALVIN long-horizon chain generation (copy of
`mdt_policy_tpu/evaluation/sequences.py`: the same 1000 chains).

Re-implements the reference's deterministic 5-task chain sampler
(`mdt/evaluation/multistep_sequences.py:263-382`): rejection-sample 5 distinct
tasks per chain, validated against the symbolic state machine, with

* a fixed per-initial-state numpy seed (seed = state index) so chains are
  reproducible across machines and epochs (SURVEY §4 determinism),
* a global temp_seed(0) shuffle of the (state, chain) list.

The reference parallelizes over a ProcessPoolExecutor; per-state seeding makes
the result independent of scheduling, so a serial loop here is bit-identical
and avoids process forking on the single-core host.
"""

from __future__ import annotations

import contextlib
import functools
from copy import deepcopy
from itertools import product
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .tasks import TASKS, TASK_CATEGORIES, State

__all__ = ["temp_seed", "valid_task", "check_sequence", "get_sequences"]


@contextlib.contextmanager
def temp_seed(seed):
    """Temporarily pin the global numpy RNG (ref evaluation/utils.py:267-274)."""
    state = np.random.get_state()
    np.random.seed(seed)
    try:
        yield
    finally:
        np.random.set_state(state)


def _check_condition(state: State, condition: Dict) -> bool:
    """(ref multistep_sequences.py:263-273)"""
    for k, v in condition.items():
        if isinstance(v, list):
            if state[k] not in v:
                return False
        elif state[k] != v:
            return False
    return True


def valid_task(curr_state: State, task_clauses) -> List[State]:
    """All successor states reachable by the task's clauses
    (ref multistep_sequences.py:283-289)."""
    next_states = []
    for clause in task_clauses:
        if _check_condition(curr_state, clause["condition"]):
            nxt = deepcopy(curr_state)
            nxt.update(clause["effect"])
            next_states.append(nxt)
    return next_states


def check_sequence(state: State, seq: Sequence[str]) -> bool:
    """A chain is valid iff each task fires through exactly ONE clause and all
    five tasks come from distinct categories (ref multistep_sequences.py:324-331)."""
    for task_name in seq:
        states = valid_task(state, TASKS[task_name])
        if len(states) != 1:
            return False
        state = states[0]
    categories = [TASK_CATEGORIES[name] for name in seq]
    return len(categories) == len(set(categories))


def _sequences_for_state(state: State, num_sequences: int, state_index: int,
                         seq_len: int = 5) -> List[Tuple[str, ...]]:
    """Rejection sampling with the per-state seed (ref :334-344).

    The reference runs this in worker PROCESSES (np.random.seed(i) per
    worker), leaving the parent's temp_seed(0) stream untouched for the final
    shuffle. An isolated legacy RandomState(i) draws the identical MT19937
    stream while preserving that isolation serially."""
    rng = np.random.RandomState(state_index)
    task_names = list(TASKS.keys())
    results: List[Tuple[str, ...]] = []
    while len(results) < num_sequences:
        seq = rng.choice(task_names, size=seq_len, replace=False)
        if check_sequence(state, seq):
            results.append(tuple(seq.tolist()))
    return results


def _initial_states() -> List[State]:
    """Enumerate feasible initial symbolic states (ref :353-365): 1-2 blocks on
    the table, at most one block per slider compartment, hand free."""
    possible_conditions = {
        "led": [0, 1],
        "lightbulb": [0, 1],
        "slider": ["right", "left"],
        "drawer": ["closed", "open"],
        "red_block": ["table", "slider_right", "slider_left"],
        "blue_block": ["table", "slider_right", "slider_left"],
        "pink_block": ["table", "slider_right", "slider_left"],
        "grasped": [0],
    }
    keep = lambda vals: (list(vals).count("table") in (1, 2)
                         and list(vals).count("slider_right") < 2
                         and list(vals).count("slider_left") < 2)
    return [dict(zip(possible_conditions.keys(), vals))
            for vals in product(*possible_conditions.values()) if keep(vals)]


@functools.lru_cache
def get_sequences(num_sequences: int = 1000):
    """1000 deterministic (initial_state, 5-task-chain) pairs
    (ref multistep_sequences.py:351-382)."""
    initial_states = _initial_states()
    per_state = list(map(len, np.array_split(range(num_sequences), len(initial_states))))
    with temp_seed(0):
        chains: List[Tuple[str, ...]] = []
        for i, (state, n) in enumerate(zip(initial_states, per_state)):
            chains.extend(_sequences_for_state(state, n, i))
        results = list(zip(np.repeat(initial_states, per_state), chains))
        np.random.shuffle(results)
    return results
