"""The MDT-V config values that keep the production parameter tree, against
the JAX package through the checks of tests/test_torch_denoiser_configs.py
(the JAX tree carried across, a replan chunk, one train step): the bf16
denoiser, `embed_pdrob` and `goal_drop` here; `freeze_img_encoder=False`
and the log-normal sigma density in
tests/test_torch_denoiser_draw_options.py.
"""

import pytest
import torch

from test_torch_denoiser_configs import (_agents, _draws, _port_draws, check_replan,
                                         check_round_trip, check_train_step)
from test_torch_train_step import _batch

OPTIONS = ("bf16_denoiser", "embed_pdrob", "goal_drop")


@pytest.mark.parametrize("case", OPTIONS)
def test_option_from_jax_round_trip(case):
    check_round_trip(case)


@pytest.mark.parametrize("case", OPTIONS)
def test_option_replan_matches_jax(case):
    check_replan(case)


@pytest.mark.parametrize("case", OPTIONS)
def test_option_train_step_matches_jax(case):
    check_train_step(case)


def test_goal_drop_and_embed_dropout_need_their_draws():
    """Train mode with goal_drop > 0 and no goal masks, or with embed_pdrob
    > 0 and no dropout generator, raises; eval mode needs neither."""
    _, _, port = _agents("goal_drop")
    b = {k: torch.as_tensor(v) for k, v in _batch()["lang"].items()}
    draws = _port_draws(_draws(port.cfg))["lang"]
    with pytest.raises(ValueError, match="goal_mask"):
        port(b, "lang", train=True, draws={k: v for k, v in draws.items() if k != "goal_mask"})
    with torch.no_grad():
        out = port(b, "lang", train=False, draws={k: v for k, v in draws.items()
                                                  if k != "goal_mask"})
    assert torch.isfinite(out["total_loss"])
    _, _, port = _agents("embed_pdrob")
    with pytest.raises(ValueError, match="dropout"):
        port(b, "lang", train=True, draws=_port_draws(_draws(port.cfg))["lang"])
