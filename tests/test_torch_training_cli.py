"""The training runtime of the PyTorch port, on the CPU at a tiny config
(mirrors tests/test_training_cli.py): `train()` on synthetic batches and on
an on-disk CALVIN split (that test is in tests/test_torch_extract_cli.py,
beside the other on-disk runs); the run directory (metrics.csv, config.yaml that the JAX
`load_config` reads, system_info.json with the TF32 flags, checkpoints, the
recon grid, the profile); the preemption resume bit for bit; SIGTERM; the
divergence guard; the warm start; what raises; and the evaluate CLI on a
run directory that `train()` wrote.
"""

import csv
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from mdt_policy_tpu import training as jax_training
from mdt_policy_tpu_torch import evaluate, training
from mdt_policy_tpu_torch.agents import (init_random_, init_train_state, make_agent_net,
                                         train_step, validation_step)
from mdt_policy_tpu_torch.training import (DataConfig, RunConfig, TrainerConfig,
                                           TrainingDivergedError, ema_weights,
                                           stream_generator, train)
from mdt_policy_tpu_torch.utils.checkpoint import latest_checkpoint
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
    assert json.loads((run / "profile" / "summary.json").read_text())["wall_ms"] > 0
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


@pytest.mark.parametrize("section,field", [("rollout", "enabled"), ("task_rollout", "enabled"),
                                           ("distributed", "enabled"), ("trainer", "devices")])
def test_unported_options_raise_before_any_work(tmp_path, section, field):
    cfg = _cfg(tmp_path, "refused")
    setattr(getattr(cfg, section), field, 2 if field == "devices" else True)
    item = "item 7" if section in ("distributed", "trainer") else "item 5"
    with pytest.raises(NotImplementedError, match=item):
        train(cfg, device="cpu")
    assert not (tmp_path / "refused").exists()


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
