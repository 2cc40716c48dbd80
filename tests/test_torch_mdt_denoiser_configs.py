"""The MDT (ResNet) agent's denoiser config values against the JAX package,
through the checks of tests/test_torch_denoiser_configs.py (the JAX tree
carried across, a replan chunk, one train step): the sigma-token encoder,
the noise-encoder decoder and the bf16 denoiser here;
`goal_drop` and `embed_pdrob` in tests/test_torch_mdt_denoiser_options.py.
"""

import pytest

from test_torch_denoiser_configs import check_replan, check_round_trip, check_train_step

MDT_CASES = ("bf16_denoiser", "noise_encoder", "sigma_token")


@pytest.mark.parametrize("case", MDT_CASES)
def test_mdt_config_from_jax_round_trip(case):
    check_round_trip(case, "mdt")


@pytest.mark.parametrize("case", MDT_CASES)
def test_mdt_config_replan_matches_jax(case):
    check_replan(case, "mdt")


@pytest.mark.parametrize("case", ["sigma_token"])
def test_mdt_config_train_step_matches_jax(case):
    """MDT's own encode with the sigma token leading it; the noise-encoder
    decoder is MDT-V's module, whose train step
    tests/test_torch_denoiser_configs.py holds, and MDT's bf16 denoiser
    step runs in tests/test_torch_mdt_denoiser_bf16.py."""
    check_train_step(case, "mdt")
