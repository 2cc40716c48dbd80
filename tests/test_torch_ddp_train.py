"""`train()` of the port at 2 gloo ranks on the CPU (`trainer.devices=2`),
each run a subprocess with a timeout of its own (tests/test_torch_ddp.py's
`_run`): only the lead writes the run directory, a resumed 2-rank run is
bit-equal to an uninterrupted one, the long-horizon rollout's metrics at 2
ranks equal those at 1 (a calvin_env stub on the ranks' path, which the
port's `make_calvin_env` and `make_task_oracle` import), and what raises
before any work."""

import csv
import dataclasses
import json
import pickle
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_ddp import ROWS, WORLD, _run

CALVIN_STUB = {
    "calvin_env/__init__.py": "",
    "calvin_env/envs/__init__.py": "",
    "calvin_env/envs/play_table_env.py": '''
        import numpy as np

        class PlayTable:
            """calvin_env's env protocol: raw frames from a seeded generator,
            a step counter in the info."""

            def __init__(self):
                self.rng, self.t = np.random.default_rng(0), 0

            def get_obs(self):
                return {"rgb_obs": {
                            "rgb_static": self.rng.integers(0, 255, (32, 32, 3), np.uint8),
                            "rgb_gripper": self.rng.integers(0, 255, (32, 32, 3), np.uint8)},
                        "robot_obs": np.zeros(15, np.float32)}

            def get_info(self):
                return {"t": self.t}

            def reset(self, robot_obs=None, scene_obs=None):
                self.t = 0

            def step(self, action):
                self.t += 1
                return self.get_obs(), 0.0, False, self.get_info()

        def get_env(dataset_path, show_gui=False):
            return PlayTable()
        ''',
    "calvin_env/envs/tasks.py": '''
        class Tasks:
            """calvin_env's oracle: a task is solved after 1 + (its name's
            length mod 3) steps, except those with "rotate" in the name."""

            def __init__(self, definitions):
                self.definitions = definitions

            def get_task_info_for_set(self, start_info, current_info, subtasks):
                steps = current_info["t"] - start_info["t"]
                return {t for t in subtasks
                        if "rotate" not in t and steps >= 1 + len(t) % 3}
        ''',
}


def write_calvin_stub(root: Path) -> Path:
    """A `calvin_env` package under `root` (put `root` on the path): the
    env and the oracle that `make_calvin_env` and `make_task_oracle` build."""
    for rel, text in CALVIN_STUB.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))
    return root


def _train_cfg(tmp_path, name, epochs, **rollout):
    from mdt_policy_tpu_torch.training import DataConfig, RolloutConfig, RunConfig, TrainerConfig
    from test_torch_train_step import TINY
    overrides = {**TINY, "clip_vocab_size": 49408, "attn_pdrop": 0.3, "resid_pdrop": 0.1,
                 "mlp_pdrop": 0.05}
    return RunConfig(
        agent="mdtv", log_dir=str(tmp_path / "runs"), run_name=name,
        data=DataConfig(root_data_dir=None, synthetic_static_hw=32, synthetic_gripper_hw=32),
        trainer=TrainerConfig(batch_size=ROWS, max_epochs=epochs, steps_per_epoch=2,
                              limit_val_batches=1, seed=3, log_every=1, keep_checkpoints=1,
                              log_recon_images=False, devices=WORLD),
        rollout=RolloutConfig(**{"enabled": False, "num_sequences": 4, "ep_len": 3,
                                 "rollout_freq": 1, "skip_epochs": 0, **rollout}),
        agent_overrides=overrides)


def _train_two_ranks(cfg, tmp_path):
    """`train(cfg, device="cpu")` in a subprocess (it starts the ranks), the
    calvin_env stub on the path."""
    stub = write_calvin_stub(tmp_path / "stub")
    path = tmp_path / f"{cfg.run_name}.pkl"
    path.write_bytes(pickle.dumps(cfg))
    script = ("import pickle, sys; sys.path.insert(0, %r); "
              "from mdt_policy_tpu_torch.training import train; "
              "assert train(pickle.load(open(%r, 'rb')), device='cpu') is None"
              % (str(stub), str(path)))
    return _run([[sys.executable, "-c", script]], tmp_path)[0]


def _rows(run):
    rows, header = [], None
    with open(run / "metrics.csv") as f:
        for row in csv.reader(f):
            if row[0] == "step":
                header = row
            else:
                rows.append({k: float(v) for k, v in zip(header, row) if v != ""})
    return rows


def _state(run):
    from mdt_policy_tpu_torch.utils.checkpoint import STATE_FILE, latest_checkpoint
    return torch.load(latest_checkpoint(run / "checkpoints") / STATE_FILE, weights_only=True)


def _assert_trees_equal(a, b, where=""):
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), where
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{where}/{i}")
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def two_rank_runs(tmp_path_factory):
    """The 2-rank runs, each `train()` in its own process: 2 epochs with the
    chain rollout at both; the same 1 epoch, then resumed to 2."""
    tmp = tmp_path_factory.mktemp("ddp_train")
    straight = _train_cfg(tmp, "straight", 2, enabled=True)
    log = _train_two_ranks(straight, tmp)
    _train_two_ranks(_train_cfg(tmp, "resumed", 1, enabled=True), tmp)
    _train_two_ranks(_train_cfg(tmp, "resumed", 2, enabled=True), tmp)
    return tmp, log


def test_two_rank_train_only_the_lead_writes(two_rank_runs):
    tmp, log = two_rank_runs
    run = tmp / "runs" / "straight"
    assert "rank 1 of 2" in log and "rank 0 of 2" in log
    assert sorted(p.name for p in run.iterdir()) == \
        ["checkpoints", "config.yaml", "metrics.csv", "system_info.json"]
    info = json.loads((run / "system_info.json").read_text())
    assert info["process_count"] == WORLD and info["training_device"] == "cpu"
    rows = _rows(run)
    # one row a step and a rollout and a validation per epoch: written once
    steps = [r["step"] for r in rows if "train/total_loss" in r]
    assert steps == [1, 2, 3, 4]
    assert [r["step"] for r in rows if "eval_lh/avg_seq_len" in r] == [2, 4]
    assert [r["step"] for r in rows if "val_act/action_loss" in r] == [2, 4]
    # chunks/s counts the global batch: 2 streams x 4 rows over the step time
    r = rows[0]
    np.testing.assert_allclose(r["perf/chunks_per_sec"], 2 * ROWS * r["perf/steps_per_sec"])
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["4", "best.json"]
    best = json.loads((run / "checkpoints" / "best.json").read_text())
    assert best["step"] == 4 and best["metric_name"] == "eval_lh/avg_seq_len"


def test_two_rank_resume_is_bit_equal(two_rank_runs):
    tmp, _ = two_rank_runs
    a, b = _state(tmp / "runs" / "straight"), _state(tmp / "runs" / "resumed")
    assert a["step"] == b["step"] == 4
    _assert_trees_equal(a, b)
    ra, rb = _rows(tmp / "runs" / "straight"), _rows(tmp / "runs" / "resumed")
    pick = lambda rows: [(r["step"], r["train/total_loss"]) for r in rows
                         if "train/total_loss" in r]
    assert pick(ra) == pick(rb)


def test_long_horizon_metrics_at_two_ranks_equal_one(two_rank_runs, tmp_path, monkeypatch):
    """The chains sharded over 2 ranks and gathered give the metrics of one
    process running them all (the same env and oracle stub)."""
    from mdt_policy_tpu_torch.training import train
    tmp, _ = two_rank_runs
    monkeypatch.syspath_prepend(str(write_calvin_stub(tmp_path / "stub")))
    for name in [m for m in sys.modules if m == "calvin_env" or m.startswith("calvin_env.")]:
        monkeypatch.delitem(sys.modules, name)
    cfg = _train_cfg(tmp_path, "one", 2, enabled=True)
    cfg.trainer = dataclasses.replace(cfg.trainer, devices=None)
    train(cfg, device="cpu")
    for name in [m for m in sys.modules if m == "calvin_env" or m.startswith("calvin_env.")]:
        del sys.modules[name]
    pick = lambda rows: [{k: v for k, v in r.items() if k.startswith("eval_lh/")}
                         for r in rows if "eval_lh/avg_seq_len" in r]
    two, one = pick(_rows(tmp / "runs" / "straight")), pick(_rows(tmp_path / "runs" / "one"))
    assert two == one and len(one) == 2
    assert 0 < one[0]["eval_lh/avg_seq_len"] < 5


def test_devices_beyond_the_machine_or_an_unsplit_batch_raise(tmp_path):
    from mdt_policy_tpu_torch.training import train
    cfg = _train_cfg(tmp_path, "bad", 1)
    cfg.trainer = dataclasses.replace(cfg.trainer, batch_size=5)
    with pytest.raises(ValueError, match="not divisible"):
        train(cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train(_train_cfg(tmp_path, "nocard", 1))
    assert not (tmp_path / "runs").exists()


