"""The MDT (ResNet) agent's `goal_drop` and `embed_pdrob` against the JAX
package, through the checks of tests/test_torch_denoiser_configs.py (the
JAX tree carried across, a replan chunk, one train step). MDT drops its
goal and state tokens at each encode as well as the action embedding, and
masks the goal at both encodes of the lang scope.
"""

import pytest

from test_torch_denoiser_configs import check_replan, check_round_trip, check_train_step

MDT_CASES = ("embed_pdrob", "goal_drop")


@pytest.mark.parametrize("case", MDT_CASES)
def test_mdt_option_from_jax_round_trip(case):
    check_round_trip(case, "mdt")


@pytest.mark.parametrize("case", MDT_CASES)
def test_mdt_option_replan_matches_jax(case):
    check_replan(case, "mdt")


@pytest.mark.parametrize("case", MDT_CASES)
def test_mdt_option_train_step_matches_jax(case):
    check_train_step(case, "mdt")
