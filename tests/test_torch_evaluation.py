"""The port's CALVIN evaluation against the JAX package's: the chains, their
initial states, the fnv hash, the task tables and annotations, the goal
tokens, the fake env's frames, the serial and batched loops and their
results.json, the eval preprocessing, and the env-facing rollout policy over
a tiny MDT-V net and a tiny MDT net (the chunk at the 1e-3 bound of
tests/test_torch_slice.py, the preprocessing at f32 1e-5)."""

import functools
import importlib
import json
import string
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from mdt_policy_tpu.evaluation import annotations as jann
from mdt_policy_tpu.evaluation import batched_rollout as jbatched
from mdt_policy_tpu.evaluation import fake_env as jfake
from mdt_policy_tpu.evaluation import initial_states as jinit
from mdt_policy_tpu.evaluation import sequences as jseq
from mdt_policy_tpu.evaluation import tasks as jtasks
from mdt_policy_tpu.utils import fnv as jfnv
from mdt_policy_tpu_torch.agents import mdtv_agent as port_agent
from mdt_policy_tpu_torch.data.loader import Preprocessor
from mdt_policy_tpu_torch.evaluation import annotations, batched_rollout, fake_env
from mdt_policy_tpu_torch.evaluation import initial_states, sequences, tasks
from mdt_policy_tpu_torch.evaluation.policy_adapter import (make_batched_predict,
                                                            make_rollout_policy)
from mdt_policy_tpu_torch.utils import fnv

# the modules, which the packages' `rollout` functions shadow
rollout = importlib.import_module("mdt_policy_tpu_torch.evaluation.rollout")
jrollout = importlib.import_module("mdt_policy_tpu.evaluation.rollout")


def test_task_tables_equal_jax():
    assert list(tasks.TASKS) == list(jtasks.TASKS)
    assert tasks.TASKS == jtasks.TASKS
    assert tasks.TASK_CATEGORIES == jtasks.TASK_CATEGORIES


def test_get_sequences_equal_jax():
    """32 chains whole, and the 1000 by their parts: the initial states, the
    chains per state, a spread of states' rejection-sampled chains (the
    final shuffle is the same code as for the 32). Drawing all 1000 takes
    minutes of CPU in either package."""
    mine, theirs = sequences.get_sequences(32), jseq.get_sequences(32)
    assert len(mine) == 32
    assert [(dict(s), c) for s, c in mine] == [(dict(s), c) for s, c in theirs]
    states = sequences._initial_states()
    assert states == jseq._initial_states() and len(states) == 192
    per_state = list(map(len, np.array_split(range(1000), len(states))))
    for i in range(0, 192, 48):
        assert sequences._sequences_for_state(states[i], per_state[i], i) == \
            jseq._sequences_for_state(states[i], per_state[i], i)


def test_fnv1_32_equals_jax():
    rng = np.random.default_rng(0)
    texts = ["", "a", str({"led": 0}.values())] + [
        "".join(rng.choice(list(string.printable), size=n)) for n in range(1, 60, 7)]
    for text in texts:
        assert fnv.fnv1_32(text) == jfnv.fnv1_32(text) == jfnv._fnv1_32_py(text)
    assert fnv.fnv1_32(b"\x00\xff") == jfnv._fnv1_32_py(b"\x00\xff")


def test_initial_states_equal_jax():
    for state in sequences._initial_states():
        robot, scene = initial_states.get_env_state_for_initial_condition(dict(state))
        jrobot, jscene = jinit.get_env_state_for_initial_condition(dict(state))
        np.testing.assert_array_equal(robot, jrobot)
        np.testing.assert_array_equal(scene, jscene)


def test_annotations_and_goal_tokens_equal_jax():
    table = annotations.validation_annotations()
    assert table == jann.validation_annotations()
    assert set(table) == set(tasks.TASKS)
    assert annotations.task_definitions() == jann.task_definitions()
    goal, jgoal = annotations.make_goal_fn(77), jann.make_goal_fn(77)
    for task in tasks.TASKS:
        mine, theirs = goal(task), jgoal(task)
        assert mine["lang_text"] == theirs["lang_text"] == table[task][0]
        np.testing.assert_array_equal(mine["lang_tokens"], theirs["lang_tokens"])
    with pytest.raises(KeyError):
        goal("no_such_task")


def test_fake_env_frames_equal_jax():
    env, jenv = fake_env.FakeEnv(40, 20, seed=3), jfake.FakeEnv(40, 20, seed=3)
    frames = [env.reset()] + [env.step(None)[0] for _ in range(3)]
    jframes = [jenv.reset()] + [jenv.step(None)[0] for _ in range(3)]
    for f, jf in zip(frames, jframes):
        for key in ("rgb_static", "rgb_gripper"):
            np.testing.assert_array_equal(f["rgb_obs"][key], jf["rgb_obs"][key])
    assert env.get_info()["t"] == jenv.get_info()["t"] == 3


N_CHAINS = 12


def _oracle_rule(seqs, never):
    """Every task solves 6 steps into its rollout except `never`; a chain
    scores the tasks before its first `never`."""
    return [next((j for j, t in enumerate(chain) if t == never), 5) for _, chain in seqs]


def _serial(pkg_rollout, pkg_fake, never, tmp_path):
    """FakeEnv, ScriptedOracle and RandomPolicy of one package through its
    serial loop."""
    oracle = pkg_fake.ScriptedOracle({t: 6 for t in tasks.TASKS if t != never})
    results = pkg_rollout.evaluate_policy(
        pkg_fake.RandomPolicy(seed=1), pkg_fake.FakeEnv(seed=2), oracle,
        lambda s: {"lang_text": s}, num_sequences=N_CHAINS, ep_len=10, progress=False)
    data = pkg_rollout.print_and_save(results, N_CHAINS, tmp_path)
    return results, data, (tmp_path / "results.json").read_text()


def test_evaluate_policy_and_results_json_equal_jax(tmp_path):
    never = sequences.get_sequences(N_CHAINS)[0][1][2]
    mine = _serial(rollout, fake_env, never, tmp_path / "port")
    theirs = _serial(jrollout, jfake, never, tmp_path / "jax")
    assert mine[0] == theirs[0] == _oracle_rule(sequences.get_sequences(N_CHAINS), never)
    assert mine[1] == theirs[1]
    assert json.loads(mine[2]) == json.loads(theirs[2]) and mine[2] == theirs[2]
    assert rollout.count_success(mine[0]) == jrollout.count_success(mine[0])


def test_batched_results_equal_serial():
    never = sequences.get_sequences(N_CHAINS)[1][1][1]
    calls = []

    def predict(obs_batch, goals):
        calls.append(len(goals))
        assert obs_batch["rgb_static"].shape == (len(goals), 1, 32, 32, 3)
        return np.zeros((len(goals), 10, 7), np.float32)

    results = {}
    for name, pkg in (("port", batched_rollout), ("jax", jbatched)):
        oracle = fake_env.ScriptedOracle({t: 6 for t in tasks.TASKS if t != never})
        envs = [fake_env.FakeEnv(seed=i) for i in range(5)]
        results[name] = pkg.evaluate_policy_batched(
            pkg.BatchedPolicyAdapter(predict, multistep=10), envs, oracle,
            lambda s: {"lang_text": s}, num_sequences=N_CHAINS, ep_len=10, progress=False)
    serial = _oracle_rule(sequences.get_sequences(N_CHAINS), never)
    assert results["port"] == results["jax"] == serial
    assert set(calls) == {5, 2}  # waves of 5, 5 and 2 envs, one call per tick


def test_preprocessor_eval_batch_equals_jax():
    from mdt_policy_tpu.data.loader import Preprocessor as JPreprocessor
    rng = np.random.default_rng(0)
    raw = {"rgb_static": rng.integers(0, 256, (2, 1, 50, 50, 3), dtype=np.uint8),
           "rgb_gripper": rng.integers(0, 256, (2, 1, 84, 84, 3), dtype=np.uint8),
           "gen_static": rng.integers(0, 256, (2, 40, 40, 3), dtype=np.uint8),
           "gen_gripper": rng.integers(0, 256, (2, 40, 40, 3), dtype=np.uint8),
           "actions": rng.normal(size=(2, 10, 7)).astype(np.float64),
           "lang_text": ["a", "b"]}
    sizes = dict(static_size=32, gripper_size=24, gen_size=16)
    mine = Preprocessor(**sizes, device="cpu").eval_batch(raw)
    theirs = JPreprocessor(**sizes).eval_batch(raw)
    assert set(mine) == set(theirs) == set(raw) - {"lang_text"}
    for key in mine:
        assert mine[key].dtype == torch.float32
        np.testing.assert_allclose(mine[key].numpy(), np.asarray(theirs[key]),
                                   rtol=1e-5, atol=1e-5)
    # a goal-image call carries the static camera only
    goal = Preprocessor(**sizes, device="cpu").eval_batch({"rgb_static": raw["rgb_static"]})
    assert set(goal) == {"rgb_static"} and goal["rgb_static"].shape == (2, 1, 32, 32, 3)


# ---------------------------------------------------------------------------
# the rollout policy over tiny nets of both families
# ---------------------------------------------------------------------------

TINY = dict(
    latent_dim=32, embed_dim=32, obs_dim=32, goal_dim=16, clip_embed_dim=16,
    n_enc_layers=1, n_dec_layers=1, n_heads=2, perceiver_dim=32, perceiver_depth=1,
    perceiver_heads=2, perceiver_dim_head=8, num_latents=3, img_size=32, vit_patch=16,
    vit_depth=1, vit_heads=2, clip_vision_width=32, clip_vision_layers=1,
    clip_vision_patch=16, clip_text_width=16, clip_text_layers=1, clip_text_heads=2,
    clip_context_length=77, clip_vocab_size=49408, gen_img_res=32, gen_patch_size=16,
    gen_decoder_depth=1, gen_decoder_dim=16, gen_decoder_heads=2,
    num_sampling_steps=10, compute_dtype="float32",
)


@functools.cache
def _agents(family):
    from mdt_policy_tpu import agents as jagents
    from mdt_policy_tpu_torch import agents
    from mdt_policy_tpu_torch.utils.from_jax import from_jax
    rng = np.random.default_rng(1)
    B = 2
    example = {
        "rgb_static": rng.uniform(size=(B, 2, 32, 32, 3)).astype(np.float32),
        "rgb_gripper": rng.uniform(size=(B, 2, 32, 32, 3)).astype(np.float32),
        "gen_static": rng.uniform(size=(B, 32, 32, 3)).astype(np.float32),
        "gen_gripper": rng.uniform(size=(B, 32, 32, 3)).astype(np.float32),
        "actions": rng.normal(size=(B, 10, 7)).astype(np.float32),
        "lang_tokens": rng.integers(1, 100, size=(B, 77)).astype(np.int32),
    }
    if family == "mdtv":
        net, state = jagents.init_agent(jagents.MDTVConfig(**TINY), jax.random.PRNGKey(0),
                                        example)
        port = agents.MDTVAgentNet(agents.MDTVConfig(**TINY), device="cpu")
    else:
        net, state = jagents.init_mdt_agent(jagents.MDTConfig(**TINY),
                                            jax.random.PRNGKey(0), example)
        port = agents.MDTAgentNet(agents.MDTConfig(**TINY), device="cpu")
    params = jax.device_get(state.params)
    port.load_state_dict(from_jax(params), strict=True)
    return net, params, port


def _first_noise(seed, batch):
    _, k = jax.random.split(jax.random.PRNGKey(seed))
    k_init, _ = jax.random.split(k)
    return torch.from_numpy(np.array(jax.random.normal(k_init, (batch, 10, 7))))


@pytest.mark.parametrize("family", ["mdtv", "mdt"])
def test_rollout_policy_gives_the_jax_chunk(family):
    """Raw FakeEnv frames (200 px static, 84 px gripper) and the goal_fn's
    tokens through both packages' `make_rollout_policy`: the same chunk."""
    from mdt_policy_tpu.evaluation.policy_adapter import make_rollout_policy as jmake
    net, params, port = _agents(family)
    env = fake_env.FakeEnv(img_hw=200, gripper_hw=84, seed=0)
    obs = env.reset()
    goal = annotations.make_goal_fn(77)("open_drawer")
    jpolicy = jmake(net, params, rng=jax.random.PRNGKey(5))
    jaction = jpolicy.step(obs, goal)
    noise = _first_noise(5, 1)
    policy = make_rollout_policy(port)
    with mock.patch.object(port_agent.MDTVPolicy, "_draw_noise", lambda self, batch: noise):
        action = policy.step(obs, goal)
    assert action.shape == (1, 7) and isinstance(action, np.ndarray)
    np.testing.assert_allclose(policy.inner.pred_action_seq.numpy(),
                               np.asarray(jpolicy.inner.pred_action_seq), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(action, np.asarray(jaction), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("family", ["mdtv", "mdt"])
def test_batched_predict_is_the_serial_policys_replan(family):
    """`make_batched_predict` over stacked frames of three envs gives, per
    env, the chunk the serial rollout policy plans for that env alone."""
    _, _, port = _agents(family)
    envs = [fake_env.FakeEnv(img_hw=200, gripper_hw=84, seed=i) for i in range(3)]
    obs = [e.reset() for e in envs]
    goal_fn = annotations.make_goal_fn(77)
    goals = [goal_fn(t) for t in ("open_drawer", "push_into_drawer", "open_drawer")]
    noise = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 10, 7))
                             .astype(np.float32))
    with mock.patch.object(port_agent.MDTVPolicy, "_draw_noise", lambda self, batch: noise):
        chunks = make_batched_predict(port)(batched_rollout._stack_obs(obs), goals)
    assert chunks.shape == (3, 10, 7)
    for i in range(3):
        policy = make_rollout_policy(port)
        with mock.patch.object(port_agent.MDTVPolicy, "_draw_noise",
                               lambda self, batch: noise[i:i + 1]):
            policy.step(obs[i], goals[i])
        np.testing.assert_allclose(chunks[i], policy.inner.pred_action_seq[0].numpy(),
                                   rtol=1e-4, atol=1e-5)
