"""The tiny MDT (ResNet) train step at 2 gloo ranks x 2 rows against the
port's one-process step at 4 rows and the JAX `train_step` at 4 rows: the
MDT case of tests/test_torch_ddp.py, in a file of its own (its JAX
reference compiles take most of its time)."""

from test_torch_ddp import two_rank_step_equals_one_process_and_jax


def test_two_rank_mdt_step_equals_one_process_and_jax(tmp_path):
    two_rank_step_equals_one_process_and_jax("mdt", tmp_path)
