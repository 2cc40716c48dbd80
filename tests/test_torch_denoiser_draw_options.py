"""`freeze_img_encoder=False` (which, as in the JAX package, leaves the
Voltron tower frozen) and the log-normal sigma density (a normal draw in
place of the uniform one) against the JAX package, through the checks of
tests/test_torch_denoiser_configs.py (the JAX tree carried across, a replan
chunk, one train step).
"""

import pytest

from test_torch_denoiser_configs import check_replan, check_round_trip, check_train_step

DRAW_OPTIONS = ("lognormal", "trainable_img_encoder")


@pytest.mark.parametrize("case", DRAW_OPTIONS)
def test_draw_option_from_jax_round_trip(case):
    check_round_trip(case)


@pytest.mark.parametrize("case", DRAW_OPTIONS)
def test_draw_option_replan_matches_jax(case):
    check_replan(case)


@pytest.mark.parametrize("case", DRAW_OPTIONS)
def test_draw_option_train_step_matches_jax(case):
    check_train_step(case)
