"""CALVIN closed-loop evaluation of the port: the 5-task chains, their
initial states, the validation annotations, the serial and the batched
loops, the fake env and the policy adapters (the numpy-only modules of
`mdt_policy_tpu/evaluation/`, copied, and the adapters over the port's
policy)."""

from .batched_rollout import BatchedPolicyAdapter, evaluate_policy_batched
from .fake_env import FakeEnv, RandomPolicy, ScriptedOracle
from .initial_states import get_env_state_for_initial_condition
from .policy_adapter import PreprocessingPolicy, make_batched_predict, make_rollout_policy
from .rollout import (LangEmbeddings, count_success, evaluate_policy, evaluate_sequence,
                      print_and_save, rollout)
from .sequences import check_sequence, get_sequences, temp_seed, valid_task
from .tasks import TASK_CATEGORIES, TASKS

__all__ = ["BatchedPolicyAdapter", "FakeEnv", "LangEmbeddings", "PreprocessingPolicy",
           "RandomPolicy", "ScriptedOracle",
           "TASKS", "TASK_CATEGORIES", "check_sequence", "count_success",
           "evaluate_policy", "evaluate_policy_batched", "evaluate_sequence",
           "get_env_state_for_initial_condition", "get_sequences",
           "make_batched_predict", "make_rollout_policy", "print_and_save",
           "rollout", "temp_seed", "valid_task"]
