"""The MDT-V goal-projection config values against the JAX package, through
the checks of tests/test_torch_denoiser_configs.py (the JAX tree carried
across, a replan chunk in the lang and the vis modality, one train step):
no `lang_emb` (`use_modality_encoder=False`, `goal_emb` serves both
modalities) and linear goal projections (`use_mlp_goal=False`).
"""

import pytest

from test_torch_denoiser_configs import check_replan, check_round_trip, check_train_step

GOAL_CASES = ("linear_goal", "no_modality_encoder")


@pytest.mark.parametrize("case", GOAL_CASES)
def test_goal_config_from_jax_round_trip(case):
    check_round_trip(case)


@pytest.mark.parametrize("case", GOAL_CASES)
def test_goal_config_replan_matches_jax(case):
    check_replan(case)


@pytest.mark.parametrize("case", GOAL_CASES)
def test_goal_config_train_step_matches_jax(case):
    check_train_step(case)
