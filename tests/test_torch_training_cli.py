"""The training runtime of the PyTorch port, on the CPU at a tiny config
(mirrors tests/test_training_cli.py): `train()` on synthetic batches and on
an on-disk CALVIN split (that test is in tests/test_torch_extract_cli.py,
beside the other on-disk runs); the run directory (metrics.csv, config.yaml that the JAX
`load_config` reads, system_info.json with the TF32 flags, checkpoints, the
recon grid, the profile); the preemption resume bit for bit; SIGTERM; the
divergence guard; the warm start; what raises; the training-time rollouts
(the chain rollout's `eval_lh/*` and `best.json`, the single-task rollouts,
a run with them bit-equal to one without, the default factory paths
resolved onto the port without JAX); and the evaluate CLI on a run
directory that `train()` wrote.
"""

import csv
import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import yaml

from mdt_policy_tpu import training as jax_training
from mdt_policy_tpu_torch import agents, evaluate, training
from mdt_policy_tpu_torch.agents import (init_random_, init_train_state, make_agent_net,
                                         train_step, validation_step)
from mdt_policy_tpu_torch.evaluation import annotations, env_adapter, policy_adapter
from mdt_policy_tpu_torch.evaluation.fake_env import FakeEnv, ScriptedOracle
from mdt_policy_tpu_torch.evaluation.policy_adapter import make_rollout_policy
from mdt_policy_tpu_torch.training import (DataConfig, RolloutConfig, RunConfig,
                                           TaskRolloutConfig, TrainerConfig,
                                           TrainingDivergedError, ema_weights,
                                           stream_generator, train)
from mdt_policy_tpu_torch.utils.checkpoint import latest_checkpoint
from test_torch_data import write_split
from test_torch_train_step import TINY

REPO = Path(__file__).resolve().parents[1]
# real annotation text tokenizes to CLIP BPE ids up to 49407
REAL = {**TINY, "clip_vocab_size": 49408}
SYNTHETIC = DataConfig(root_data_dir=None, synthetic_static_hw=32, synthetic_gripper_hw=32)


def _cfg(tmp_path, name, *, agent="mdtv", data=SYNTHETIC, overrides=TINY, **trainer):
    trainer = {"batch_size": 2, "max_epochs": 2, "steps_per_epoch": 2, "limit_val_batches": 1,
               "seed": 0, "log_every": 100, "keep_checkpoints": 1,
               "log_recon_images": False, **trainer}
    return RunConfig(agent=agent, log_dir=str(tmp_path), run_name=name, data=data,
                     trainer=TrainerConfig(**trainer), agent_overrides=dict(overrides))


def _tensors(state):
    """Every tensor of a train state by name: the net's state_dict, the EMA,
    the optimizer's per-parameter state (steps and moments)."""
    out = {f"params/{k}": v for k, v in state.net.state_dict().items()}
    out.update({f"ema/{k}": v for k, v in state.ema.items()})
    names = {id(p): n for n, p in state.net.trainable_parameters()}
    for p, s in state.optimizer.state.items():
        out.update({f"opt/{names[id(p)]}/{k}": v for k, v in s.items()})
    return out


def _assert_bit_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k
    assert a.step == b.step


def _metrics(run_dir):
    """metrics.csv as a list of {column: value} rows (the header is written
    again when the columns grow)."""
    rows, header = [], None
    with open(run_dir / "metrics.csv") as f:
        for row in csv.reader(f):
            if row[0] == "step":
                header = row
            else:
                rows.append({k: float(v) for k, v in zip(header, row) if v != ""})
    return rows


def test_synthetic_run_writes_the_run_directory(tmp_path):
    cfg = _cfg(tmp_path, "smoke", log_every=2, keep_checkpoints=2, profile_steps="1:2",
               log_recon_images=True)
    state = train(cfg, device="cpu")
    assert state.step == 4
    run = tmp_path / "smoke"
    rows = _metrics(run)
    for col in ("train/grad_norm", "train/param_norm", "train/lr", "perf/chunks_per_sec",
                "val_act/action_loss", "val_act/lang_img_gen_loss"):
        assert any(col in r for r in rows), col
    assert [r["step"] for r in rows if "train/total_loss" in r] == [2, 4]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    # the snapshot: the JAX load_config reads it into an equal RunConfig
    snap = jax_training.load_config(str(run / "config.yaml"), [])
    assert dataclasses.asdict(snap) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(training.load_config(str(run / "config.yaml"), [])) == \
        dataclasses.asdict(cfg)
    info = json.loads((run / "system_info.json").read_text())
    assert info["cudnn_allow_tf32"] is False and info["matmul_allow_tf32"] is False
    assert info["cudnn_deterministic"] is True
    assert info["torch"] == torch.__version__ and info["training_device"] == "cpu"
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    assert sorted(p.name for p in (run / "checkpoints").iterdir() if p.is_dir()) == ["2", "4"]
    assert not (run / "checkpoints" / "best.json").exists()
    assert sorted(p.name for p in (run / "media").iterdir()) == \
        ["img_gen_pred_step2.png", "img_gen_pred_step4.png"]
    summary = json.loads((run / "profile" / "summary.json").read_text())
    assert summary["wall_ms"] > 0
    # the profiled step's spans: its parts' self times under the step's
    spans = summary["spans"]
    assert spans["train.step"]["count"] == 1 and spans["train.forward"]["count"] == 2
    assert spans["train.backward"]["count"] == 1 and spans["train.ema"]["count"] == 1
    assert spans["net.contrastive"]["count"] == 1 and spans["data.next"]["count"] == 1
    for s in spans.values():
        assert 0 <= s["self_ms"] <= s["total_ms"]
    parts = sum(spans[n]["total_ms"] for n in ("train.forward", "train.backward", "train.tail"))
    assert parts <= spans["train.step"]["total_ms"]
    assert summary["counters"] == {}
    assert (run / "profile" / "trace.json").stat().st_size > 0
    # auto-resume: the same run directory restores step 4 and stops there
    again = train(cfg, device="cpu")
    assert again.step == 4
    _assert_bit_equal(state, again)


def test_mdt_run_logs_validation_metrics(tmp_path):
    state = train(_cfg(tmp_path, "mdt", agent="mdt", max_epochs=1, steps_per_epoch=1,
                       log_every=1, keep_checkpoints=0), device="cpu")
    assert state.step == 1 and type(state.net).__name__ == "MDTAgentNet"
    rows = _metrics(tmp_path / "mdt")
    assert any("val_act/action_loss" in r for r in rows)
    assert not (tmp_path / "mdt" / "checkpoints").exists()


def test_preemption_resume_is_bit_for_bit(tmp_path):
    """4 straight steps == 2 steps, a stop, 2 resumed steps: every parameter,
    EMA entry, Adam moment and step; the production dropout rates on."""
    drop = {**TINY, "attn_pdrop": 0.3, "resid_pdrop": 0.1, "mlp_pdrop": 0.05}
    straight = train(_cfg(tmp_path, "straight", overrides=drop), device="cpu")
    first = train(_cfg(tmp_path, "resumed", overrides=drop, max_epochs=1), device="cpu")
    assert first.step == 2
    resumed = train(_cfg(tmp_path, "resumed", overrides=drop), device="cpu")
    assert resumed.step == 4
    _assert_bit_equal(straight, resumed)


def test_a_step_after_validation_equals_one_without():
    """`ema_weights` swaps the EMA in and the live tensors back: validating
    between two steps changes neither the weights nor the next step."""
    from test_torch_train_step import _batch
    from mdt_policy_tpu_torch.agents import MDTVConfig
    cfg = MDTVConfig(**TINY)

    def state():
        net = make_agent_net(cfg, device="cpu")
        return init_train_state(init_random_(net, torch.Generator().manual_seed(0)))

    a, b = state(), state()
    for s in (a, b):
        train_step(s, _batch(0), generator=torch.Generator().manual_seed(1))
    live = {n: p.data_ptr() for n, p in a.net.trainable_parameters()}
    with ema_weights(a):
        for n, p in a.net.trainable_parameters():
            assert p.data_ptr() == a.ema[n].data_ptr()
        validation_step(a.net, _batch(2), generator=torch.Generator().manual_seed(3))
    assert all(p.data_ptr() == live[n] for n, p in a.net.trainable_parameters())
    for s in (a, b):
        train_step(s, _batch(4), generator=torch.Generator().manual_seed(5))
    _assert_bit_equal(a, b)


def test_sigterm_checkpoints_and_exits_zero(tmp_path):
    """The CLI in a subprocess: a SIGTERM after the first logged step
    finishes the step, saves it with wait=True and exits 0."""
    cfg = _cfg(tmp_path, "preempt", max_epochs=500, steps_per_epoch=1000, log_every=1)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(dataclasses.asdict(cfg)))
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen([sys.executable, "-m", "mdt_policy_tpu_torch.training",
                             "--config", str(path), "--device", "cpu"],
                            cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while not (tmp_path / "preempt" / "metrics.csv").exists():
            assert proc.poll() is None and time.time() < deadline, proc.stderr.read()
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err
    last = latest_checkpoint(tmp_path / "preempt" / "checkpoints")
    assert last is not None and 0 < int(last.name) < 500_000
    assert "preemption checkpoint saved" in err


def test_divergence_guard_halts_without_a_checkpoint(tmp_path):
    overrides = {**TINY, "optimizer": {"learning_rate": 1e18},
                 "lr_scheduler": {"init_lr": 1e18, "init_lr_scale": 1.0}}
    cfg = _cfg(tmp_path, "diverge", overrides=overrides, max_epochs=5, steps_per_epoch=20,
               log_every=1)
    with pytest.raises(TrainingDivergedError):
        train(cfg, device="cpu")
    assert latest_checkpoint(tmp_path / "diverge" / "checkpoints") is None


# the task rollout's factories (`task_rollout.env_target` / `oracle_target`
# name them by dotted path), as tests/fake_targets.py has them for the JAX
# package
class DiscoveryOracle:
    """Demo discovery maps every demo to `open_drawer`; a rollout solves any
    task after one env step."""

    def get_task_info(self, start_info, end_info):
        return {"open_drawer"}

    def get_task_info_for_set(self, start_info, current_info, subtasks):
        return set(subtasks) if current_info["t"] - start_info["t"] >= 1 else set()


def make_env(dataset_path=None):
    return FakeEnv(img_hw=32, gripper_hw=32)


def make_oracle():
    return DiscoveryOracle()


# the chain rollout's scripted oracle: every task after 2 env steps but one
CHAIN_RULE = {"rotate_blue_block_right": 10 ** 9}


@pytest.fixture(scope="module")
def rollout_runs(tmp_path_factory):
    """`train()` over an on-disk split, 2 epochs of 2 steps, with both
    rollouts at each epoch (`make_calvin_env` and `make_task_oracle` patched
    to the fake env and a scripted oracle; the task rollout's factories
    above), and the same run with both off. Records, at each rollout
    policy's construction, whether the net held the EMA."""
    tmp = tmp_path_factory.mktemp("rollouts")
    data = tmp / "calvin"
    write_split(data / "training")
    write_split(data / "validation", seed=1)
    split = DataConfig(root_data_dir=str(data), min_window_size=21, max_window_size=30,
                       num_workers=1)
    off = _cfg(tmp, "off", data=split, overrides=REAL)
    on = dataclasses.replace(
        off, run_name="on",
        rollout=RolloutConfig(enabled=True, num_sequences=3, ep_len=4, rollout_freq=1,
                              skip_epochs=0),
        task_rollout=TaskRolloutConfig(
            enabled=True, skip_epochs=0, rollout_freq=1, rollouts_per_task=1, ep_len=4,
            discovery_batches=1, id_selection_strategy="select_first",
            env_target="test_torch_training_cli.make_env",
            oracle_target="test_torch_training_cli.make_oracle"))
    on_ema = []

    def recording(net, **kw):
        state = states_seen[-1]
        on_ema.append(all(p.data_ptr() == state.ema[n].data_ptr()
                          for n, p in net.trainable_parameters()))
        return make_rollout_policy(net, **kw)
    states_seen = []
    real_init = agents.init_train_state

    def init_train_state(net):
        states_seen.append(real_init(net))
        return states_seen[-1]
    with mock.patch.object(env_adapter, "make_calvin_env",
                           lambda path: FakeEnv(img_hw=32, gripper_hw=32, seed=4)), \
            mock.patch.object(annotations, "make_task_oracle",
                              lambda: ScriptedOracle(CHAIN_RULE, default=2)), \
            mock.patch.object(policy_adapter, "make_rollout_policy", recording), \
            mock.patch.object(agents, "init_train_state", init_train_state):
        states = {"on": train(on, device="cpu")}
    states["off"] = train(off, device="cpu")
    return tmp, states, on_ema


def test_train_rollout_logs_eval_lh_and_picks_best_json(rollout_runs):
    """The chain rollout at each epoch on the EMA weights: `eval_lh/*` rows in
    metrics.csv, and `best.json` names the epoch's save with its
    `eval_lh/avg_seq_len` (ties go to the later step)."""
    tmp, _, on_ema = rollout_runs
    rows = _metrics(tmp / "on")
    lh = [r for r in rows if "eval_lh/avg_seq_len" in r]
    assert [r["step"] for r in lh] == [2, 4]
    avg = lh[0]["eval_lh/avg_seq_len"]
    assert 0 < avg <= 5 and lh[1]["eval_lh/avg_seq_len"] == avg
    assert avg == pytest.approx(sum(lh[0][f"eval_lh/sr_chain_{i}"] for i in range(1, 6)))
    best = json.loads((tmp / "on" / "checkpoints" / "best.json").read_text())
    assert best == {"step": 4, "metric": avg, "metric_name": "eval_lh/avg_seq_len"}
    assert on_ema == [True] * 4  # two rollouts an epoch, each on the EMA
    assert not (tmp / "off" / "checkpoints" / "best.json").exists()


def test_task_rollout_through_train(rollout_runs):
    """The single-task rollouts through `train()` (the JAX
    tests/test_train_real_data.py:111-160): demo discovery from validation
    batches, the task dictionary beside the run, per-task success rates for
    both goal modalities at each epoch."""
    tmp, _, _ = rollout_runs
    task_dict = tmp / "on" / "task_dict.npy"
    assert task_dict.exists()
    from mdt_policy_tpu.evaluation.single_task_rollout import load_task_dict
    assert sorted(load_task_dict(task_dict)) == ["open_drawer"]
    rows = [r for r in _metrics(tmp / "on") if "tasks/average_sr" in r]
    assert [r["step"] for r in rows] == [2, 4]
    for r in rows:
        assert r["tasks/open_drawer_vis_sr"] == r["tasks/open_drawer_lang_sr"] == 1.0
        assert r["tasks/average_sr"] == 1.0
    assert not (tmp / "off" / "task_dict.npy").exists()


def test_a_run_with_rollouts_ends_bit_equal_to_one_without(rollout_runs):
    """The rollouts draw from their own streams and run on the EMA swapped
    in and out: every parameter, EMA entry, Adam moment and step of the run
    with both rollouts equals the run without them, and so do its losses."""
    tmp, states, _ = rollout_runs
    _assert_bit_equal(states["on"], states["off"])
    pick = lambda rows: [(r["step"], r["train/total_loss"]) for r in rows
                         if "train/total_loss" in r]
    assert pick(_metrics(tmp / "on")) == pick(_metrics(tmp / "off"))


def test_default_targets_resolve_to_the_port_without_jax():
    """`TaskRolloutConfig`'s default `env_target` and `oracle_target` name
    the JAX package (the snapshot both packages read); the port's resolver
    maps them onto its own modules, in a process where importing
    `mdt_policy_tpu` fails, and imports any other path as given."""
    code = textwrap.dedent("""
        import sys
        sys.modules["mdt_policy_tpu"] = None
        from mdt_policy_tpu_torch import training
        from mdt_policy_tpu_torch.evaluation import annotations, env_adapter
        cfg = training.TaskRolloutConfig()
        assert cfg.env_target.startswith("mdt_policy_tpu.evaluation.")
        assert cfg.oracle_target.startswith("mdt_policy_tpu.evaluation.")
        assert training._resolve_target(cfg.env_target) is env_adapter.make_calvin_env
        assert training._resolve_target(cfg.oracle_target) is annotations.make_task_oracle
        import os.path
        assert training._resolve_target("os.path.join") is os.path.join
        loaded = [m for m in sys.modules if sys.modules[m] is not None
                  and (m.split(".")[0] in ("jax", "flax", "optax", "mdt_policy_tpu"))]
        assert not loaded, loaded
        print("resolved")
        """)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "resolved", proc.stderr


def test_cache_mode_needs_mdtv_and_the_default_device_is_cuda(tmp_path):
    cfg = _cfg(tmp_path, "cache", agent="mdt")
    cfg.data = dataclasses.replace(SYNTHETIC, use_extracted_embeddings=True)
    with pytest.raises(ValueError, match="agent=mdtv"):
        train(cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train(_cfg(tmp_path, "nocard"))


def test_warm_start_copies_the_matching_tensors(tmp_path):
    source = train(_cfg(tmp_path, "source", max_epochs=1), device="cpu")
    saved = {k: v.clone() for k, v in source.net.state_dict().items()}
    # a fresh run of another seed and a wider foresight decoder: no step
    other = {**TINY, "gen_decoder_dim": 32}
    cfg = _cfg(tmp_path, "warm", overrides=other, seed=9, max_epochs=0,
               pretrain_checkpoint=str(tmp_path / "source" / "checkpoints"))
    warm = train(cfg, device="cpu")
    own = init_random_(make_agent_net(training._make_agent(cfg), device="cpu"),
                       stream_generator(9, "init", 0, "cpu")).state_dict()
    copied = 0
    for k, v in warm.net.state_dict().items():
        if k in saved and saved[k].shape == v.shape:
            assert torch.equal(v, saved[k]), k
            copied += 1
        else:
            assert k.startswith("gen_img.") and torch.equal(v, own[k]), k
    assert copied > 0 and copied < len(own)
    for n, p in warm.net.trainable_parameters():
        assert torch.equal(warm.ema[n], p), n


def test_evaluate_cli_reads_a_run_directory_of_train(tmp_path, capsys):
    cfg = _cfg(tmp_path, "evaluated", overrides=REAL, max_epochs=1)
    state = train(cfg, device="cpu")
    run = tmp_path / "evaluated"
    evaluate.main(["--train-folder", str(run), "--fake-env", "--device", "cpu",
                   "--num-sequences", "2", "--ep-len", "5"])
    printed = json.loads(capsys.readouterr().out)
    results = json.loads((run / "evaluation" / "results.json").read_text())
    assert printed["avg_seq_len"] == results["0"]["avg_seq_len"] == 0.0
    net, _, _ = evaluate.load_run_agent(run, device="cpu")
    for n, p in net.trainable_parameters():
        assert torch.equal(p, state.ema[n]), n
