"""One MDT (ResNet) validation step of the PyTorch port against the JAX
package, and the MDT agent's refusal of cache mode, at the tiny config of
tests/test_torch_mdt_train_step.py, whose helpers (agents, batch, draws)
these tests share. They sit in a file of their own so that `--dist
loadfile` can run the validation step's JAX compile beside that file's
train steps.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from mdt_policy_tpu.agents import mdtv_agent as jagent
from mdt_policy_tpu_torch.agents import validation_step
from test_torch_mdt_train_step import _agents, _batch, _draws, _patched_jax_random, _port_draws


def test_mdt_validation_step_matches_jax():
    """DDIM-10 from the hoisted context, the action MSE (chunk bound 1e-3)
    and the foresight loss (module bound) per scope."""
    net, state0, port = _agents("f32")
    batch, draws = _batch(seed=4), _draws(seed=5)
    patches, queues = _patched_jax_random(draws, ("noise", "mask"))
    with patches[0], patches[1]:
        jm = jax.jit(functools.partial(jagent.validation_step, net))(
            state0.params, batch, jax.random.PRNGKey(6))
    assert not any(queues.values())
    jm = {k: float(v) for k, v in jax.device_get(jm).items()}
    pm = {k: float(v) for k, v in
          validation_step(port, batch, draws=_port_draws(draws)).items()}
    assert sorted(pm) == sorted(jm)
    for k in jm:
        rtol = 1e-3 if "act_loss" in k or k == "val_act/action_loss" else 1e-4
        np.testing.assert_allclose(pm[k], jm[k], rtol=rtol, err_msg=k)


def test_mdt_has_no_cache_mode():
    _, _, port = _agents("f32")
    cache = {"voltron_tokens": torch.zeros(4, 392, 32),
             "image_latent_goal": torch.zeros(4, 16)}
    with pytest.raises(ValueError, match="no cache mode"):
        port.encode_towers(cache, "vis")
