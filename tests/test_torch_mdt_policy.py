"""The whole tiny MDT agent of the PyTorch port against the JAX package:
its action chunk after DDIM-10 and the closed-loop policy (`MDTPolicy`)
over three replans, with the same numpy inputs and initial noise on both
sides, at the agents of tests/test_torch_mdt.py, whose helpers these
tests share. They sit in a file of their own so that `--dist loadfile`
can run them beside that file's module tests. Chunk bound: 1e-3
(tests/test_torch_slice.py); modules: rtol 1e-4, atol 5e-5.
"""

import functools
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from mdt_policy_tpu.agents import MDTPolicy as JaxPolicy
from mdt_policy_tpu.agents.mdtv_agent import denoise_actions as jax_denoise
from mdt_policy_tpu_torch.agents import MDTPolicy, MDTVPolicy, denoise_actions
from test_torch_mdt import B, CHUNK_TOL, TOL, _agents, _inputs, _jax_noises


def test_mdt_chunk_matches_jax():
    net, params, port = _agents()
    x = _inputs()
    apply = functools.partial(net.apply, {"params": params})
    emb = apply(x["rgb_static"], x["rgb_gripper"], method="perceive")
    goal = apply(x["lang_tokens"], method="encode_language_goal")
    chunk = jax.jit(functools.partial(jax_denoise, net, modality="lang"))(
        params, emb, goal, jax.random.PRNGKey(7))
    k_init, _ = jax.random.split(jax.random.PRNGKey(7))
    noise = torch.from_numpy(np.array(jax.random.normal(k_init, (B, 10, 7))))
    with torch.no_grad():
        p_emb = port.perceive(torch.from_numpy(x["rgb_static"]),
                              torch.from_numpy(x["rgb_gripper"]))
        p_goal = port.encode_language_goal(torch.from_numpy(x["lang_tokens"]))
        p_chunk = denoise_actions(port, p_emb, p_goal, noise=noise)
    for key in ("static", "gripper"):
        np.testing.assert_allclose(p_emb[key].numpy(), np.asarray(emb[key]), **TOL)
    np.testing.assert_allclose(p_goal.numpy(), np.asarray(goal), **TOL)
    np.testing.assert_allclose(p_chunk.numpy(), np.asarray(chunk), **CHUNK_TOL)


@pytest.mark.parametrize("goal_kind", ["lang_tokens", "rgb_static_goal"])
def test_mdt_policy_matches_jax_over_replans(goal_kind):
    """21 steps (three replans) through both policies with the same frames,
    goal and initial draws: every action agrees; the text tower runs once."""
    assert MDTPolicy is MDTVPolicy
    net, params, port = _agents()
    x = _inputs(seed=4)
    obs = {k: x[k] for k in ("rgb_static", "rgb_gripper")}
    goal = {goal_kind: x["lang_tokens"] if goal_kind == "lang_tokens"
            else x["rgb_static"][:, 0]}
    jpolicy = JaxPolicy(net, params, rng=jax.random.PRNGKey(11))
    jactions = [np.asarray(jpolicy.step(obs, goal)) for _ in range(21)]
    noises = iter(_jax_noises(11, 3))
    policy = MDTPolicy(port, generator=torch.Generator().manual_seed(0))
    with mock.patch.object(policy, "_draw_noise", lambda batch: next(noises)), \
            mock.patch.object(port, "encode_language_goal",
                              wraps=port.encode_language_goal) as encode:
        actions = [policy.step(obs, goal).numpy() for _ in range(21)]
    assert encode.call_count == (goal_kind == "lang_tokens")
    np.testing.assert_allclose(np.stack(actions), np.stack(jactions), **CHUNK_TOL)
