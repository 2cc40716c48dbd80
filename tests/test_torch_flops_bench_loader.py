"""The port's FLOP count of kernel B1 and its loader benchmark, on the CPU.

* `utils/flops.py`: a tally of 4 B T^2 C a call around B1's plain version,
  over one tiny MDT-V and one tiny MDT train step, equals
  `tower_custom_call_flops` / `mdt_tower_custom_call_flops`;
  `FlopCounterMode` over B1's plain version equals
  `attention_matmul_flops`; the formulas equal the JAX package's with its
  Pallas route switched on.
* `data/bench_loader.py`: `generate_dataset` and
  `fabricate_embedding_cache` array for array against the JAX package's
  (the zip bytes differ by timestamp); `bench`, `bench_embeddings`,
  `bench_prefetcher` and `scaling_bench` at 2 shards by their keys and
  counts; the CLI's JSON line."""

import json
from unittest import mock

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mdt_policy_tpu.data import bench_loader as jbench
from mdt_policy_tpu.data.extract import extract_by_key as jextract_by_key
from mdt_policy_tpu.utils import flops as jflops
from mdt_policy_tpu_torch.agents import (MDTAgentNet, MDTConfig, MDTVAgentNet, MDTVConfig,
                                         init_random_, init_train_state, train_step)
from mdt_policy_tpu_torch.data import bench_loader as bench
from mdt_policy_tpu_torch.data.extract import extract_by_key, extract_frames
from mdt_policy_tpu_torch.models import clip, voltron_vit
from mdt_policy_tpu_torch.ops.fused_qkv_attention import fused_qkv_attention
from mdt_policy_tpu_torch.utils import flops


@pytest.mark.parametrize("family", ["mdtv", "mdt"])
def test_b1_tally_of_a_train_step_equals_the_formula(family):
    from test_torch_mdt_train_step import TINY as MDT_TINY
    from test_torch_train_step import B, TINY, _batch

    cfg = MDTVConfig(**TINY) if family == "mdtv" else MDTConfig(**MDT_TINY)
    net = init_random_((MDTVAgentNet if family == "mdtv" else MDTAgentNet)(cfg, device="cpu"),
                       torch.Generator().manual_seed(0))
    tally = []

    def counted(qkv, n_heads, causal=False):
        Bq, T, C3 = qkv.shape
        tally.append(flops.attention_matmul_flops(Bq, T, C3 // 3))
        return fused_qkv_attention(qkv, n_heads, causal)

    with mock.patch.object(clip, "fused_qkv_attention", counted), \
            mock.patch.object(voltron_vit, "fused_qkv_attention", counted):
        train_step(init_train_state(net), _batch(), generator=torch.Generator().manual_seed(1))
    fn = flops.tower_custom_call_flops if family == "mdtv" else flops.mdt_tower_custom_call_flops
    assert sum(tally) == fn(cfg, B, device="cuda") > 0
    assert fn(cfg, B, device="cpu") == 0.0  # the counter sees the plain route there


def test_flop_counter_sees_b1_plain_version():
    qkv = torch.randn(3, 10, 3 * 32)
    with FlopCounterMode(display=False) as counter:
        fused_qkv_attention(qkv, 4, causal=True)
    assert counter.get_total_flops() == flops.attention_matmul_flops(3, 10, 32)


@pytest.mark.parametrize("cfg", [MDTVConfig(), MDTConfig(), MDTVConfig(
    clip_vision_family="resnet"), MDTVConfig(img_size=96, vit_depth=3, clip_text_layers=2)],
    ids=["mdtv", "mdt", "mdtv_rn50", "mdtv_small"])
def test_formulas_equal_the_jax_package(cfg):
    with mock.patch("mdt_policy_tpu.agents.mdtv_agent.resolve_fused_attention",
                    lambda c: True):
        assert flops.tower_custom_call_flops(cfg, 128) == jflops.tower_custom_call_flops(cfg, 128)
        assert flops.mdt_tower_custom_call_flops(cfg, 64) == \
            jflops.mdt_tower_custom_call_flops(cfg, 64)
    assert flops.attention_matmul_flops(2, 7, 48, 3) == jflops.attention_matmul_flops(2, 7, 48, 3)


def _npz_arrays(root):
    out = {}
    for path in sorted(root.glob("*.np[yz]")):
        data = np.load(path, allow_pickle=True)
        out[path.name] = dict(data) if path.suffix == ".npz" else data
    return out


def _assert_same_tree(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, np.ndarray) and a.dtype == object:
        _assert_same_tree(a.item(), b.item())
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_generated_split_and_fabricated_cache_equal_jax(tmp_path):
    kw = dict(static_hw=12, gripper_hw=8, episode_len=30, with_lang=True, seed=3)
    ours = bench.generate_dataset(tmp_path / "port", 70, **kw)
    ref = jbench.generate_dataset(tmp_path / "jax", 70, **kw)
    _assert_same_tree(_npz_arrays(ours), _npz_arrays(ref))
    extract_by_key(ours)
    jextract_by_key(ref)
    cache = dict(n_tokens=6, dim=4, emb_dim=5, aug_variants=2, lang_goals=True, seed=4)
    ex, jex = bench.fabricate_embedding_cache(ours, **cache), \
        jbench.fabricate_embedding_cache(ref, **cache)
    names = sorted(p.name for p in jex.glob("ep_*.npy"))
    assert names == sorted(p.name for p in ex.glob("ep_*.npy")) and len(names) == 6
    for name in names:
        np.testing.assert_array_equal(np.load(ex / name), np.load(jex / name))
    assert json.loads((ex / "embeddings_meta.json").read_text()) == \
        json.loads((jex / "embeddings_meta.json").read_text())


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = bench.generate_dataset(tmp_path_factory.mktemp("bench") / "training", 200,
                                  static_hw=32, gripper_hw=16)
    extract_by_key(root)
    extract_frames(root)
    return root


def test_bench_keys_and_counts(split):
    res = bench.bench(split, batch_size=8, steps=3, num_workers=2)
    jres = jbench.bench(split, batch_size=8, steps=3, num_workers=2)
    assert res.keys() == jres.keys()
    assert (res["batches"], res["batch_size"], res["num_workers"], res["extracted_frames"]) == \
        (3, 8, 2, True)
    assert res["chunks_per_sec"] > 0
    pf = bench.bench_prefetcher(split, device="cpu", batch_size=8, steps=2, num_workers=2)
    assert (pf["batches"], pf["device"]) == (2, "cpu") and pf["chunks_per_sec"] > 0
    scaled = bench.scaling_bench(split, 2, batch_size=8, steps=2)
    assert scaled["num_shards"] == 2 and scaled["chunks"] == 2 * 2 * 8
    assert set(scaled) == {"num_shards", "chunks", "agg_wall_chunks_per_sec",
                           "cpu_ms_per_chunk", "agg_at_cores"}


def test_bench_embeddings_keys_and_counts(tmp_path):
    root = bench.generate_dataset(tmp_path / "training", 120, static_hw=16, gripper_hw=16)
    extract_by_key(root)
    extract_frames(root)
    bench.fabricate_embedding_cache(root, n_tokens=16, dim=8)
    res = bench.bench_embeddings(root, batch_size=8, steps=3, num_workers=2)
    jres = jbench.bench_embeddings(root, batch_size=8, steps=3, num_workers=2)
    assert res.keys() == jres.keys()
    assert res["mb_per_chunk"] == jres["mb_per_chunk"]
    assert (res["batches"], res["batch_size"]) == (3, 8)


def test_cli_prints_one_json_line(tmp_path, capsys):
    bench.main(["--frames", "120", "--batch-size", "8", "--steps", "2", "--num-workers", "2",
                "--prefetcher", "--device", "cpu"])
    res = json.loads(capsys.readouterr().out)
    assert res["batches"] == 2 and res["prefetcher"]["device"] == "cpu"
