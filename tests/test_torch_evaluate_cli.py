"""The evaluate CLI of the PyTorch port (`mdt_policy_tpu_torch/evaluate.py`)
on the CPU, against the JAX package's (`mdt_policy_tpu/evaluate.py`), from a
tiny run directory of each agent family: saved by the JAX `Checkpointer`
(orbax), converted by the port's `convert_run_dir`. The JAX `train()` is the
slow tier and is not called: the run's state is the JAX agent's initial
state with its parameters perturbed and an EMA that differs from them.
Also the calvin_env adapter on a stub `calvin_env`.
"""

import dataclasses
import json
import shutil
import sys
import types
from unittest import mock

import jax
import numpy as np
import pytest
import torch
import yaml

from mdt_policy_tpu import evaluate as jax_evaluate
from mdt_policy_tpu import training as jax_training
from mdt_policy_tpu.agents import MDTConfig as JaxMDTConfig
from mdt_policy_tpu.agents import MDTVConfig as JaxMDTVConfig
from mdt_policy_tpu.agents import init_agent, init_mdt_agent
from mdt_policy_tpu.evaluation import env_adapter as jax_env_adapter
from mdt_policy_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from mdt_policy_tpu_torch import evaluate
from mdt_policy_tpu_torch.evaluation import env_adapter, get_sequences
from mdt_policy_tpu_torch.evaluation.annotations import make_goal_fn
from mdt_policy_tpu_torch.utils.checkpoint import convert_run_dir
from mdt_policy_tpu_torch.utils.from_jax import from_jax
from test_torch_mdt_train_step import TINY as MDT_TINY
from test_torch_train_step import TINY as MDTV_TINY

# f32 towers for the 1e-3 chunk bound; the CLIP vocabulary in full, since
# the goals are tokenized validation sentences
F32 = dict(compute_dtype="float32", gen_compute_dtype="float32", clip_vocab_size=49408)
FAMILIES = {"mdtv": (JaxMDTVConfig, init_agent, {**MDTV_TINY, **F32}),
            "mdt": (JaxMDTConfig, init_mdt_agent, {**MDT_TINY, **F32})}
STEP = 7
CHUNK_TOL = dict(rtol=1e-3, atol=1e-3)  # the 10-step chunk bound of the port's tests


def _jax_state(family):
    """The JAX initial state as the JAX `load_run_agent` builds it (the same
    example batch and key, so the compiled init is shared), with every
    parameter perturbed by N(0, 0.1) and an EMA that adds another N(0, 0.05)
    to the trainables: raw and EMA weights differ everywhere but in the
    frozen towers."""
    cfg_cls, init, overrides = FAMILIES[family]
    cfg = cfg_cls(**overrides)
    s, g = cfg.img_size, cfg.gen_img_res
    example = {"rgb_static": np.zeros((1, 2, s, s, 3), np.float32),
               "rgb_gripper": np.zeros((1, 2, s, s, 3), np.float32),
               "gen_static": np.zeros((1, g, g, 3), np.float32),
               "gen_gripper": np.zeros((1, g, g, 3), np.float32),
               "actions": np.zeros((1, cfg.act_window_size, cfg.action_dim), np.float32),
               "lang_tokens": np.zeros((1, cfg.clip_context_length), np.int32)}
    net, state = init(cfg, jax.random.PRNGKey(0), example)
    rng = np.random.default_rng(3)
    noisy = lambda tree, std: jax.tree.map(
        lambda p: (np.asarray(p) + rng.normal(size=np.shape(p)) * std).astype(np.float32), tree)
    params = noisy(jax.device_get(state.params), 0.1)
    ema = {k: v if k in net.frozen_prefixes else noisy(v, 0.05) for k, v in params.items()}
    return state, state.replace(params=params, ema_params=ema, step=STEP)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """family -> (JAX run dir, converted port run dir, the saved JAX state)."""
    out = {}
    for family, (_, _, overrides) in FAMILIES.items():
        root = tmp_path_factory.mktemp(family)
        jax_dir, port_dir = root / "jax_run", root / "port_run"
        template, state = _jax_state(family)
        jax_dir.mkdir()
        (jax_dir / "config.yaml").write_text(yaml.safe_dump(dataclasses.asdict(
            jax_training.RunConfig(agent=family, agent_overrides=dict(overrides)))))
        JaxCheckpointer(jax_dir / "checkpoints").save(state, metric=1.5, wait=True)
        # what a machine with JAX runs: restore, fetch, convert
        restored = JaxCheckpointer(jax_dir / "checkpoints").restore(template, step=STEP)
        trees = {STEP: jax.device_get({"params": restored.params,
                                       "ema_params": restored.ema_params,
                                       "opt_state": restored.opt_state,
                                       "step": restored.step})}
        convert_run_dir(jax_dir / "config.yaml", trees,
                        jax_dir / "checkpoints" / "best.json", port_dir)
        out[family] = (jax_dir, port_dir, jax.device_get(state))
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_converted_run_dir_holds_the_jax_run(runs, family):
    """The port run dir: config.yaml copied, best.json carried over, the
    step in the port's format; `load_run_agent` builds the run's family
    with the EMA of the trainables (raw weights under use_ema=False) and
    the frozen towers' own weights, bit for bit."""
    jax_dir, port_dir, state = runs[family]
    assert (port_dir / "config.yaml").read_text() == (jax_dir / "config.yaml").read_text()
    assert json.loads((port_dir / "checkpoints" / "best.json").read_text()) == \
        json.loads((jax_dir / "checkpoints" / "best.json").read_text())
    assert [p.name for p in (port_dir / "checkpoints").iterdir() if p.is_dir()] == [str(STEP)]
    params, ema = from_jax(state.params), from_jax(state.ema_params)
    for use_ema in (True, False):
        net, agent_cfg, run_cfg = evaluate.load_run_agent(port_dir, use_ema=use_ema,
                                                          device="cpu")
        assert run_cfg.agent == family and type(net).__name__ == (
            "MDTAgentNet" if family == "mdt" else "MDTVAgentNet")
        trainable = dict(net.trainable_parameters())
        for name, value in net.state_dict().items():
            want = (ema if use_ema and name in trainable else params)[name]
            assert torch.equal(value, want), name
        assert any(not torch.equal(ema[n], params[n]) for n in trainable)


def _jax_noise(seed=0):
    """The first replan's initial draw of the JAX policy (mdtv_agent.py:702,
    :535-536) at B=1."""
    _, k = jax.random.split(jax.random.PRNGKey(seed))
    k_init, _ = jax.random.split(k)
    return torch.from_numpy(np.array(jax.random.normal(k_init, (1, 10, 7))))


@pytest.fixture(scope="module")
def policies(runs):
    """family -> (JAX `build_policy` on the JAX run, the port's on the
    converted run, on the CPU)."""
    return {family: (jax_evaluate.build_policy(str(jax_dir)),
                     evaluate.build_policy(port_dir, device="cpu"))
            for family, (jax_dir, port_dir, _) in runs.items()}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("goal_kind", ["lang_tokens", "rgb_static_goal"])
def test_build_policy_chunk_matches_jax(policies, family, goal_kind):
    """The port's `build_policy` on the converted run against the JAX
    `build_policy` on the JAX run: the same raw uint8 frames, goal and
    initial noise give the same chunk (1e-3) and action."""
    (jpolicy, jcfg, _), (policy, cfg, _) = policies[family]
    jpolicy.reset()
    jpolicy.inner.rng = jax.random.PRNGKey(0)  # the first replan's key again
    policy.reset()
    rng = np.random.default_rng(8)
    obs = {"rgb_obs": {"rgb_static": rng.integers(0, 255, (1, 1, 64, 64, 3), dtype=np.uint8),
                       "rgb_gripper": rng.integers(0, 255, (1, 1, 32, 32, 3), dtype=np.uint8)}}
    goal = make_goal_fn(cfg.clip_context_length)("open_drawer") if goal_kind == "lang_tokens" \
        else {"rgb_static_goal": rng.integers(0, 255, (1, 1, 64, 64, 3), dtype=np.uint8)}
    jaction = np.asarray(jpolicy.step(obs, goal))
    with mock.patch.object(policy.inner, "_draw_noise", lambda batch: _jax_noise()):
        action = policy.step(obs, goal)
    np.testing.assert_allclose(policy.inner.pred_action_seq.numpy(),
                               np.asarray(jpolicy.inner.pred_action_seq), **CHUNK_TOL)
    np.testing.assert_allclose(action, jaction, **CHUNK_TOL)
    assert dataclasses.asdict(cfg).items() >= dataclasses.asdict(jcfg).items()


@pytest.mark.parametrize("family", FAMILIES)
def test_main_fake_env_writes_the_oracles_results(runs, family, capsys):
    """`main([... --fake-env --device cpu])`: the scripted oracle never
    solves, so every chain fails its first task after a whole episode;
    results.json says so (what the JAX CLI writes on the JAX run), and the
    policy replanned every `multistep` steps."""
    jax_dir, port_dir, _ = runs[family]
    args = ["--fake-env", "--num-sequences", "2", "--ep-len", "12"]
    from mdt_policy_tpu_torch.agents import MDTVPolicy
    with mock.patch.object(MDTVPolicy, "plan", autospec=True,
                           side_effect=MDTVPolicy.plan) as plan:
        evaluate.main(["--train-folder", str(port_dir), "--device", "cpu", *args])
    printed = json.loads(capsys.readouterr().out)
    assert plan.call_count == 2 * -(-12 // 10)
    jax_evaluate.main(["--train-folder", str(jax_dir), *args])
    port = json.loads((port_dir / "evaluation" / "results.json").read_text())
    ref = json.loads((jax_dir / "evaluation" / "results.json").read_text())
    firsts = [chain[0] for _, chain in get_sequences(2)]
    assert port == ref == {"0": {
        "avg_seq_len": 0.0, "chain_sr": {str(i): 0.0 for i in range(1, 6)},
        "task_info": {t: {"success": 0, "total": firsts.count(t)} for t in firsts}}}
    assert printed == {"avg_seq_len": 0.0, "chain_sr": port["0"]["chain_sr"]}


def test_cli_refuses_what_the_port_lacks(runs, tmp_path):
    """What the CLI once refused runs now: a sweep over two samplers
    (ddim and the stochastic euler_ancestral) on the CPU writes one row a
    combination; an unknown sampler name is refused by argparse. The
    default device is CUDA, which raises where there is none.
    `--num-videos` writes the first chain's GIF under
    <train_folder>/evaluation/videos."""
    port_dir = str(runs["mdtv"][1])
    copy = shutil.copytree(port_dir, tmp_path / "run")  # its results.json is its own
    evaluate.main(["--train-folder", str(copy), "--fake-env", "--device", "cpu",
                   "--num-videos", "1", "--num-sequences", "1", "--ep-len", "3"])
    assert (copy / "evaluation" / "videos" / "lh-sequence_0.gif").stat().st_size > 0
    evaluate.main(["--train-folder", str(copy), "--fake-env", "--device", "cpu",
                   "--sweep-sampler", "ddim", "euler_ancestral", "--sweep-steps", "3", "5",
                   "--num-sequences", "1", "--ep-len", "2"])
    rows = json.loads((copy / "evaluation" / "sweep_results.json").read_text())
    assert [(r["sampler"], r["steps"]) for r in rows] == [
        ("ddim", 3), ("ddim", 5), ("euler_ancestral", 3), ("euler_ancestral", 5)]
    assert all(r["avg_seq_len"] == 0.0 for r in rows)  # the oracle never solves
    with pytest.raises(SystemExit):
        evaluate.main(["--train-folder", port_dir, "--fake-env", "--device", "cpu",
                       "--sampler", "nope"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            evaluate.main(["--train-folder", port_dir, "--fake-env"])


class _StubPlayTable:
    """calvin_env's PlayTable protocol: raw obs dicts, a step counter."""

    def __init__(self):
        self.t, self.actions, self.resets = 0, [], []

    def get_obs(self):
        rng = np.random.default_rng(self.t)
        return {"rgb_obs": {"rgb_static": rng.integers(0, 255, (8, 8, 3), dtype=np.uint8),
                            "rgb_gripper": rng.integers(0, 255, (4, 4, 3), dtype=np.uint8)},
                "robot_obs": rng.normal(size=15)}

    def get_info(self):
        return {"t": self.t}

    def reset(self, robot_obs=None, scene_obs=None):
        self.t = 0
        self.resets.append((robot_obs, scene_obs))

    def step(self, action):
        self.t += 1
        self.actions.append(action)
        return self.get_obs(), 0.0, False, self.get_info()


def test_make_calvin_env_on_a_stub():
    """`make_calvin_env` imports calvin_env lazily and wraps its env as the
    JAX adapter does (obs shaped (1, 1, ...), the gripper binarized); without
    calvin_env it raises the JAX package's error."""
    envs = []

    def get_env(path, show_gui=False):
        envs.append((path, show_gui, _StubPlayTable()))
        return envs[-1][2]
    stub = {"calvin_env": types.ModuleType("calvin_env"),
            "calvin_env.envs": types.ModuleType("calvin_env.envs"),
            "calvin_env.envs.play_table_env": types.ModuleType("calvin_env.envs.play_table_env")}
    stub["calvin_env.envs.play_table_env"].get_env = get_env
    with mock.patch.dict(sys.modules, stub):
        port, ref = env_adapter.make_calvin_env("/data/x"), jax_env_adapter.make_calvin_env("/data/x")
    assert [e[:2] for e in envs] == [("/data/x", False)] * 2
    robot, scene = np.arange(15.0), np.arange(24.0)
    outs = []
    for adapter in (port, ref):
        first = adapter.reset(robot_obs=robot, scene_obs=scene)
        stepped = adapter.step(np.array([0.1, 0.2, 0.3, 0.0, 0.1, 0.2, -0.4]))
        outs.append((first, stepped[0], stepped[3], adapter.env.actions[-1]))
    for a, b in zip(*outs):
        if isinstance(a, dict) and "action" in a:
            np.testing.assert_array_equal(a["action"], b["action"])
            assert a["type"] == b["type"] == "cartesian_rel"
            assert a["action"][-1] == -1.0
        elif isinstance(a, dict) and "rgb_obs" in a:
            for k in ("rgb_static", "rgb_gripper"):
                np.testing.assert_array_equal(a["rgb_obs"][k], b["rgb_obs"][k])
            assert a["rgb_obs"]["rgb_static"].shape == (1, 1, 8, 8, 3)
            np.testing.assert_array_equal(a["robot_obs"], b["robot_obs"])
        else:
            assert a == b
    with mock.patch.dict(sys.modules, {"calvin_env": None}):
        with pytest.raises(ImportError, match="calvin_env is not installed"):
            env_adapter.make_calvin_env("/data/x")
