"""Training-time closed-loop evaluation — the RolloutLongHorizon equivalent
(port of `mdt_policy_tpu/evaluation/training_callbacks.py`).

Re-design of `mdt/rollout/rollout_long_horizon.py:42-269`: every
`rollout_freq` epochs (after `skip_epochs`), run a shard of the 1000
five-task CALVIN chains against the live policy and report
`eval_lh/sr_chain_{1..5}` + `eval_lh/avg_seq_len` — the metric that drives
best-checkpoint selection (conf/callbacks/checkpoint/lh_sr.yaml).

Chains are sharded over the ranks of the `torch.distributed` group when one
is up (rank and world size 0 / 1 otherwise, `parallel.rank` /
`world_size`), the reference's DDP rank sharding (ref :42-78); the results
are gathered in rank order, the order of JAX's `process_allgather`.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import parallel
from .rollout import count_success, evaluate_policy

logger = logging.getLogger(__name__)

__all__ = ["RolloutLongHorizonCallback", "shard_indices"]


def shard_indices(num_sequences: int, process_index: int, process_count: int
                  ) -> List[int]:
    """Contiguous chain shards per rank (ref sequences_for_rank, :42-78)."""
    splits = np.array_split(np.arange(num_sequences), process_count)
    return splits[process_index].tolist()


class RolloutLongHorizonCallback:
    def __init__(self, env, task_oracle, goal_fn: Callable[[str], Dict], *,
                 num_sequences: int = 1000, ep_len: int = 360,
                 rollout_freq: int = 5, skip_epochs: int = 0,
                 num_videos: int = 0, video_dir: Optional[str] = None):
        self.env = env
        self.task_oracle = task_oracle
        self.goal_fn = goal_fn
        self.num_sequences = num_sequences
        self.ep_len = ep_len
        self.rollout_freq = rollout_freq
        self.skip_epochs = skip_epochs
        self.num_videos = num_videos
        self.video_dir = video_dir

    def should_run(self, epoch: int) -> bool:
        """(ref rollout_lh config: skip_epochs then every rollout_freq epochs)"""
        return epoch > self.skip_epochs and \
            (epoch - self.skip_epochs) % self.rollout_freq == 0

    def __call__(self, policy, epoch: int) -> Optional[Dict[str, float]]:
        if not self.should_run(epoch):
            return None
        idxs = shard_indices(self.num_sequences, parallel.rank(), parallel.world_size())
        # videos: the lead rank records its first chains (the reference
        # divides the video budget across ranks, rollout_long_horizon.py:154-155)
        n_videos = self.num_videos if parallel.is_lead() else 0
        results = evaluate_policy(
            policy, self.env, self.task_oracle, self.goal_fn,
            num_sequences=self.num_sequences, ep_len=self.ep_len,
            sequence_indices=idxs, num_videos=n_videos,
            video_dir=self.video_dir)
        results = self._gather(results)
        srs = count_success(results)
        metrics = {f"eval_lh/sr_chain_{i + 1}": sr for i, sr in enumerate(srs)}
        metrics["eval_lh/avg_seq_len"] = float(np.mean(results))
        logger.info("rollout epoch %d: avg_seq_len %.3f | %s", epoch,
                    metrics["eval_lh/avg_seq_len"],
                    " ".join(f"{s*100:.1f}%" for s in srs))
        return metrics

    @staticmethod
    def _gather(results: Sequence[int]) -> List[int]:
        """Every rank's results concatenated in rank order (ref
        all_gather_object, :81-89); one process: the results."""
        return [int(r) for part in parallel.all_gather_objects(list(results)) for r in part]
