"""Data parallel over processes, one a GPU (the counterpart of
`mdt_policy_tpu/parallel/`)."""

from .ddp import (all_gather_objects, all_gather_with_grad, all_reduce_gradients, barrier,
                  broadcast_trainables, check_equal_rows, free_port, init_distributed,
                  is_initialized, is_lead, rank, reduce_metrics, shutdown, vote,
                  world_size)

__all__ = ["all_gather_objects", "all_gather_with_grad", "all_reduce_gradients", "barrier",
           "broadcast_trainables", "check_equal_rows", "free_port", "init_distributed",
           "is_initialized", "is_lead", "rank", "reduce_metrics", "shutdown", "vote",
           "world_size"]
