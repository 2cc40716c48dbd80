"""Checkpoints and the run config of the PyTorch port, on the CPU at a tiny
config: `utils/checkpoint.py::Checkpointer` (a round trip bit-equal,
resuming equal to running on bit for bit, `keep` and `best.json`, the
atomic commit, the background save) and `training.py::load_config` on a
snapshot that the JAX `load_config` also reads.
"""

import dataclasses
import json
from pathlib import Path
from unittest import mock

import pytest
import torch
import yaml

from mdt_policy_tpu import training as jax_training
from mdt_policy_tpu_torch import training
from mdt_policy_tpu_torch.agents import (MDTAgentNet, MDTConfig, MDTVAgentNet, MDTVConfig,
                                         init_random_, init_train_state, train_step)
from mdt_policy_tpu_torch.agents.config import RETIRED_OVERRIDES, filter_retired_overrides
from mdt_policy_tpu_torch.utils import checkpoint
from mdt_policy_tpu_torch.utils.checkpoint import Checkpointer, latest_checkpoint
from test_torch_train_step import TINY, _batch

# the production dropout rates: a resumed step must draw the same masks
CFG = MDTVConfig(**{**TINY, "attn_pdrop": 0.3, "resid_pdrop": 0.1, "mlp_pdrop": 0.05})


def _state(seed=0, cfg=CFG):
    net = MDTVAgentNet(cfg, device="cpu")
    init_random_(net, torch.Generator().manual_seed(seed))
    return init_train_state(net)


def _step(state):
    """One train step whose draws depend only on the state's step, so a
    resumed run draws what an uninterrupted one does."""
    return train_step(state, _batch(seed=state.step),
                      generator=torch.Generator().manual_seed(100 + state.step))


def _tensors(state):
    """Every tensor of a state by name: the net's state_dict, the EMA, the
    optimizer's per-parameter state (step and moments)."""
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
        assert ta[k].dtype == tb[k].dtype and ta[k].device == tb[k].device, k
        assert torch.equal(ta[k], tb[k]), k
    assert a.step == b.step
    assert a.optimizer.state_dict()["param_groups"] == b.optimizer.state_dict()["param_groups"]


def test_round_trip_is_bit_equal(tmp_path):
    """Two steps, a save, a restore into a fresh state: every parameter (the
    frozen towers in bf16), EMA entry, Adam moment and step counter is
    bit-equal, and the lr of the param group came back."""
    state = _state()
    for _ in range(2):
        _step(state)
    ck = Checkpointer(tmp_path / "checkpoints")
    path = ck.save(state, wait=True)
    assert path == tmp_path / "checkpoints" / "2" and (path / checkpoint.STATE_FILE).is_file()
    fresh = ck.restore(_state(seed=1))
    assert fresh.net.visual_goal.conv1.weight.dtype == torch.bfloat16
    assert len(_tensors(fresh)) > len(dict(fresh.net.named_parameters()))
    _assert_bit_equal(state, fresh)
    for s in fresh.optimizer.state.values():
        assert s["step"].device.type == "cpu" and float(s["step"]) == 2.0


@pytest.mark.parametrize("family", ["mdtv", "mdt"])
def test_resuming_equals_running_on(tmp_path, family):
    """Four steps in one run against two steps, a save, a restore into a
    fresh net and two more steps: bit for bit on the CPU, dropout on."""
    cfg = CFG if family == "mdtv" else MDTConfig(**dataclasses.asdict(CFG))
    if family == "mdt":
        state = init_train_state(init_random_(MDTAgentNet(cfg, device="cpu"),
                                              torch.Generator().manual_seed(0)))
        fresh = init_train_state(MDTAgentNet(cfg, device="cpu"))
    else:
        state, fresh = _state(cfg=cfg), _state(seed=1, cfg=cfg)
    ck = Checkpointer(tmp_path / "checkpoints")
    for _ in range(2):
        _step(state)
    ck.save(state)  # in the background; restore waits for it
    for _ in range(2):
        _step(state)
    resumed = ck.restore(fresh)
    assert resumed.step == 2
    for _ in range(2):
        _step(resumed)
    _assert_bit_equal(state, resumed)


def test_keep_and_best_json(tmp_path):
    """save_top_k=1 on a maximised metric: best.json names the step of the
    largest metric (a tie goes to the newer step), and garbage collection
    keeps the newest `keep` steps and the best one."""
    state = _state()
    ck = Checkpointer(tmp_path, keep=2)
    assert ck.best_step() is None
    for step, metric in ((1, 0.5), (2, 2.0), (3, 1.0), (4, 0.2), (5, None), (6, 2.0)):
        state.step = step
        ck.save(state, metric=metric, metric_name="eval_lh/avg_seq_len")
        ck.wait()
        if step == 4:
            assert ck.best_step() == 2
            assert sorted(int(p.name) for p in tmp_path.iterdir() if p.name.isdigit()) == [2, 3, 4]
    assert json.loads((tmp_path / "best.json").read_text()) == {
        "step": 6, "metric": 2.0, "metric_name": "eval_lh/avg_seq_len"}
    assert sorted(int(p.name) for p in tmp_path.iterdir() if p.name.isdigit()) == [5, 6]
    assert latest_checkpoint(tmp_path).name == "6"


def test_commit_is_atomic(tmp_path):
    """A step directory appears only once its file is written: a leftover
    temporary directory (a save cut short) is ignored, and a save that fails
    raises from `wait` (or from a waiting save), leaves no step directory
    and no best.json naming it."""
    state = _state()
    ck = Checkpointer(tmp_path)
    state.step = 3
    ck.save(state, metric=1.0)
    leftover = tmp_path / ".7.cut"
    leftover.mkdir()
    (leftover / checkpoint.STATE_FILE).write_bytes(b"partial")
    assert latest_checkpoint(tmp_path).name == "3"
    state.step = 5
    with mock.patch.object(checkpoint.torch, "save", side_effect=OSError("disk full")):
        with pytest.raises(OSError, match="disk full"):
            ck.save(state, metric=9.0)
        ck.save(state)
        with pytest.raises(OSError, match="disk full"):
            ck.wait()
    assert not (tmp_path / "5").exists()
    assert ck.best_step() == 3
    assert ck.restore(_state(seed=1)).step == 3
    assert leftover.exists()  # ignored, not mistaken for a step


def test_saving_a_step_again_replaces_it_in_place(tmp_path):
    """A step saved a second time: its directory holds a complete file at
    every rename of the commit (best.json may name it throughout), the
    restore reads the second save, and no temporary directory is left."""
    first, second = _state(), _state(seed=1)
    _step(second)
    first.step = second.step = 4
    ck = Checkpointer(tmp_path)
    ck.save(first, metric=1.0)
    final = tmp_path / "4" / checkpoint.STATE_FILE
    renames = []
    real_replace = checkpoint.os.replace

    def replace(src, dst):
        assert final.is_file()
        real_replace(src, dst)
        assert final.is_file()
        renames.append(Path(dst))

    with mock.patch.object(checkpoint.os, "replace", side_effect=replace):
        ck.save(second, metric=1.0)
    assert final in renames and ck.best_step() == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["4", "best.json"]
    assert sorted(p.name for p in (tmp_path / "4").iterdir()) == [checkpoint.STATE_FILE]
    _assert_bit_equal(second, ck.restore(_state(seed=2)))


def test_save_copies_the_state_before_it_returns(tmp_path):
    """The background write holds a host copy: a step taken right after
    `save` returns does not leak into the saved step."""
    state = _state()
    _step(state)
    before = {k: v.clone() for k, v in _tensors(state).items()}
    ck = Checkpointer(tmp_path)
    ck.save(state)
    _step(state)
    restored = ck.restore(_state(seed=1))
    after = _tensors(restored)
    assert restored.step == 1
    for k, v in before.items():
        assert torch.equal(after[k], v), k


def test_restore_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "none").restore(_state())


# ---------------------------------------------------------------------------
# the run config
# ---------------------------------------------------------------------------

OVERRIDES = ["agent=mdt", "trainer.batch_size=32", "trainer.profile_steps=50:60",
             "trainer.devices=4", "trainer.aot_step_cache=auto",
             "distributed.enabled=true", "distributed.num_processes=2",
             "data.depth_keys=[depth_static]", "agent_overrides.latent_dim=512",
             "agent_overrides.mxu_tower_norm=true", "agent_overrides.num_sampling_steps=5"]


def _jax_snapshot(tmp_path) -> Path:
    """A config.yaml as the JAX `train()` writes it: the whole RunConfig
    after YAML and dotted overrides, TPU-only fields and a retired agent
    override among them."""
    base = tmp_path / "base.yaml"
    base.write_text(yaml.safe_dump({"log_dir": "runs", "rollout": {"enabled": True}}))
    cfg = jax_training.load_config(str(base), OVERRIDES)
    snap = tmp_path / "config.yaml"
    snap.write_text(yaml.safe_dump(dataclasses.asdict(cfg)))
    return snap


def test_load_config_reads_a_jax_snapshot(tmp_path):
    """Both packages read a JAX snapshot to the same RunConfig (the range
    string verbatim, the TPU-only fields as data), and the same YAML with
    overrides; `_make_agent` gives the same agent config, the retired key
    dropped."""
    snap = _jax_snapshot(tmp_path)
    port, ref = training.load_config(str(snap), []), jax_training.load_config(str(snap), [])
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.trainer.profile_steps == "50:60" and port.distributed.num_processes == 2
    assert port.task_rollout.env_target.startswith("mdt_policy_tpu.")
    base = tmp_path / "base.yaml"
    assert dataclasses.asdict(training.load_config(str(base), OVERRIDES)) == \
        dataclasses.asdict(jax_training.load_config(str(base), OVERRIDES))
    agent, ref_agent = training._make_agent(port), jax_training._make_agent(ref)
    assert isinstance(agent, MDTConfig)
    port_fields, ref_fields = dataclasses.asdict(agent), dataclasses.asdict(ref_agent)
    assert set(ref_fields) <= set(port_fields)
    assert {k: port_fields[k] for k in ref_fields} == ref_fields
    assert agent.latent_dim == 512 and agent.num_sampling_steps == 5
    assert "mxu_tower_norm" not in port_fields


def test_load_config_rejects_an_unknown_key(tmp_path):
    """As in JAX: an unknown key of a section raises; an unknown agent
    raises in `_make_agent`."""
    with pytest.raises(TypeError):
        training.load_config(None, ["trainer.no_such_field=1"])
    with pytest.raises(TypeError):
        jax_training.load_config(None, ["trainer.no_such_field=1"])
    with pytest.raises(ValueError, match="unknown agent"):
        training._make_agent(training.load_config(None, ["agent=resnet"]))


def test_filter_retired_overrides_is_the_jax_filter():
    from mdt_policy_tpu.agents import config as jax_config
    assert RETIRED_OVERRIDES == jax_config.RETIRED_OVERRIDES
    overrides = {"fuse_scope_towers": True, "perceiver_head_slice": 2, "latent_dim": 8}
    assert filter_retired_overrides(overrides) == jax_config.filter_retired_overrides(
        overrides) == {"latent_dim": 8}
