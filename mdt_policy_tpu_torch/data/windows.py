"""Window-size sampling for episode datasets (a copy of
`mdt_policy_tpu/data/windows.py`).

Replicates the reference's sampling semantics
(`mdt/datasets/base_dataset.py:24-37,156-193`):

* validation: hash-deterministic window via fnv1_32(str(idx)) — identical
  across epochs/machines (the reference's de-facto regression mechanism,
  SURVEY §4);
* training: geometric(p=0.1) rejection-sampled into [min, max] (production,
  conf/config.yaml `window_sampling_strategy: geometric`) or uniform;
* both clipped by the episode-boundary-aware max window.
"""

from __future__ import annotations

import numpy as np

from ..utils.fnv import fnv1_32

__all__ = ["get_validation_window_size", "max_window_for_index", "sample_window_size"]


def get_validation_window_size(idx: int, min_window_size: int, max_window_size: int) -> int:
    """(ref base_dataset.py:24-37) — bit-exact with the pyhash-based original."""
    window_range = max_window_size - min_window_size + 1
    return min_window_size + fnv1_32(str(idx)) % window_range


def max_window_for_index(episode_lookup: np.ndarray, idx: int,
                         min_window_size: int, max_window_size: int) -> int:
    """Clip the max window so the sampled window never crosses an episode
    boundary (ref base_dataset.py:156-181)."""
    window_diff = max_window_size - min_window_size
    if len(episode_lookup) <= idx + window_diff:
        return min_window_size + len(episode_lookup) - idx - 1
    if episode_lookup[idx + window_diff] != episode_lookup[idx] + window_diff:
        steps_to_next_episode = int(np.nonzero(
            episode_lookup[idx: idx + window_diff + 1]
            - (episode_lookup[idx] + np.arange(window_diff + 1)))[0][0])
        return min(max_window_size, min_window_size + steps_to_next_episode - 1)
    return max_window_size


def sample_window_size(
    episode_lookup: np.ndarray,
    idx: int,
    min_window_size: int,
    max_window_size: int,
    *,
    validation: bool,
    strategy: str = "geometric",
    geometric_p: float = 0.1,
    rng: np.random.Generator | None = None,
) -> int:
    """Full sampling path (ref base_dataset.py:156-193)."""
    if min_window_size == max_window_size:
        return max_window_size
    if min_window_size > max_window_size:
        raise ValueError("min_window_size > max_window_size")
    max_window = max_window_for_index(episode_lookup, idx, min_window_size, max_window_size)
    if validation:
        return get_validation_window_size(idx, min_window_size, max_window)
    rng = rng or np.random.default_rng()
    if strategy == "geometric":
        while True:
            w = 1 + rng.geometric(geometric_p)
            if min_window_size <= w <= max_window:
                return int(w)
    elif strategy == "random":
        return int(rng.integers(min_window_size, max_window + 1))
    raise ValueError(f"unknown window sampling strategy {strategy!r}")
