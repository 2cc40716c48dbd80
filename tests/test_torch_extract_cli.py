"""`train()` of the PyTorch port over on-disk CALVIN splits, on the CPU at a
tiny config: in full mode against a hand loop of `train_step` and
`validation_step` (on the EMA) over the same loader batches and
generators; and the extraction CLI and cache-mode training from what it
writes: `data.extract_embeddings.main` on a
run directory written by `train()` gives the same files, byte for byte, as
direct `extract_embeddings` and `extract_lang_goals` calls with the run's
EMA towers; `train()` with `data.use_extracted_embeddings` then trains from
those files (the cached tokens as bf16, no camera frames in its batches)
and equals a hand loop of the cache-mode `train_step` over the same
batches.
"""

import shutil

import numpy as np
import pytest
import torch

from mdt_policy_tpu_torch import training
from mdt_policy_tpu_torch.agents import (init_random_, init_train_state, make_agent_net,
                                         train_step, validation_step)
from mdt_policy_tpu_torch.data import extract_embeddings as pextract_embeddings
from mdt_policy_tpu_torch.data.extract import extract_frames
from mdt_policy_tpu_torch.data.loader import Preprocessor
from mdt_policy_tpu_torch.evaluate import load_run_agent
from mdt_policy_tpu_torch.training import DataConfig, ema_weights, stream_generator, train
from test_torch_data import write_split
from test_torch_training_cli import REAL, _assert_bit_equal, _cfg, _metrics


@pytest.fixture(scope="module")
def run_and_splits(tmp_path_factory):
    """A run directory of train() (2 synthetic steps) and training/ and
    validation/ splits with extracted frames."""
    base = tmp_path_factory.mktemp("extract_cli")
    train(_cfg(base, "run", overrides=REAL, max_epochs=1), device="cpu")
    for split, seed in (("training", 0), ("validation", 1)):
        extract_frames(write_split(base / "calvin" / split, seed=seed))
    return base / "run", base / "calvin"


def test_train_on_a_split_equals_the_hand_loop(tmp_path, run_and_splits):
    """train() over an on-disk split, one decode thread, bit-equal to a hand
    loop of train_step and validation_step (on the EMA) over the same
    loader batches, the same pipeline and the generators `stream_seed`
    names; its logged metrics are the hand loop's."""
    data = DataConfig(root_data_dir=str(run_and_splits[1]), min_window_size=21,
                      max_window_size=30, num_workers=1)
    cfg = _cfg(tmp_path, "real", data=data, overrides=REAL, seed=3, log_every=1,
               limit_val_batches=2)
    state = train(cfg, device="cpu")

    agent_cfg = training._make_agent(cfg)
    net = init_random_(make_agent_net(agent_cfg, device="cpu"),
                       stream_generator(3, "init", 0, "cpu"))
    hand = init_train_state(net)
    pp = Preprocessor(static_size=32, gripper_size=32, gen_size=32, device="cpu")
    loaders = [training._real_loaders(cfg, split, 8, 49408) for split in ("training",
                                                                           "validation")]
    logged = []
    try:
        it, vit = (iter(x) for x in loaders)

        def prep(raw, gen):
            return {s: pp.train_batch(raw[s], generator=gen) for s in sorted(raw)}
        for step in range(4):
            batch = prep(next(it), stream_generator(3, "aug", step, "cpu"))
            m = train_step(hand, batch, generator=stream_generator(3, "step", step, "cpu"))
            logged.append({k: float(v) for k, v in m.items()})
            if step % 2 == 1:
                val = {}
                with ema_weights(hand):
                    for vb in range(2):
                        gen = stream_generator(3, "val", step * 2 + vb, "cpu")
                        vm = validation_step(net, prep(next(vit), gen), generator=gen)
                        for k, v in vm.items():
                            val[k] = val.get(k, 0.0) + float(v)
                logged.append({k: v / 2 for k, v in val.items()})
    finally:
        for x in loaders:
            x.close()
    _assert_bit_equal(state, hand)
    rows = _metrics(tmp_path / "real")
    assert len(rows) == len(logged)
    for row, want in zip(rows, logged):
        for k, v in want.items():
            assert row[k] == v, k


def test_main_writes_what_the_functions_write(run_and_splits, tmp_path):
    run, calvin = run_and_splits
    split = calvin / "training"
    cli_out, direct_out = tmp_path / "cli", tmp_path / "direct"
    shutil.copy(split / "extracted" / "ep_npz_names.list", tmp_path / "names.list")
    for out in (cli_out, direct_out):
        out.mkdir()
        shutil.copy(tmp_path / "names.list", out / "ep_npz_names.list")
    pextract_embeddings.main(["-i", str(split), "--train-folder", str(run), "--device", "cpu",
                              "--batch-size", "32", "--aug-variants", "2", "--aug-seed", "5",
                              "--out-dir", str(cli_out)])
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    net, _, _ = load_run_agent(run, device="cpu")
    pextract_embeddings.extract_embeddings(split, net, batch_size=32, out_dir=direct_out,
                                           source=str(run), aug_variants=2, aug_seed=5)
    pextract_embeddings.extract_lang_goals(split, net, out_dir=direct_out,
                                           context_length=net.cfg.clip_context_length)
    names = sorted(p.name for p in direct_out.iterdir())
    assert names == sorted(p.name for p in cli_out.iterdir())
    assert {"ep_voltron_tokens.npy", "ep_clip_img_emb_aug.npy", "ep_lang_goal_emb.npy",
            "embeddings_meta.json"} <= set(names)
    for name in names:
        assert (cli_out / name).read_bytes() == (direct_out / name).read_bytes(), name
    # --no-ema: the raw weights, which differ from the EMA after two steps
    raw = tmp_path / "raw"
    raw.mkdir()
    shutil.copy(tmp_path / "names.list", raw / "ep_npz_names.list")
    pextract_embeddings.main(["-i", str(split), "--train-folder", str(run), "--device", "cpu",
                              "--no-ema", "--out-dir", str(raw)])
    assert (raw / "ep_voltron_tokens.npy").read_bytes() == \
        (cli_out / "ep_voltron_tokens.npy").read_bytes()  # frozen towers: EMA = raw


def test_cache_mode_train_equals_the_hand_loop(run_and_splits, tmp_path):
    run, calvin = run_and_splits
    root = tmp_path / "calvin"
    shutil.copytree(calvin, root)
    for split in ("training", "validation"):
        pextract_embeddings.main(["-i", str(root / split), "--train-folder", str(run),
                                  "--device", "cpu", "--aug-variants", "2"])
    data = DataConfig(root_data_dir=str(root), min_window_size=21, max_window_size=30,
                      num_workers=1, use_extracted_embeddings=True, embedding_aug_variants=2)
    cfg = _cfg(tmp_path, "cache", data=data, overrides=REAL, max_epochs=1, seed=4,
               log_recon_images=True)
    state = train(cfg, device="cpu")
    assert state.step == 2
    assert list((tmp_path / "cache" / "media").glob("*.png"))

    net = init_random_(make_agent_net(training._make_agent(cfg), device="cpu"),
                       stream_generator(4, "init", 0, "cpu"))
    hand = init_train_state(net)
    pp = Preprocessor(static_size=32, gripper_size=32, gen_size=32, device="cpu")
    loader = training._real_loaders(cfg, "training", 8, 49408)
    towers = []
    for name in ("visual_goal", "language_goal", "img_encoder"):
        towers.append(getattr(net, name).forward)
        setattr(getattr(net, name), "forward", None)  # a tower call would raise
    try:
        it = iter(loader)
        for step in range(2):
            raw = next(it)
            assert "rgb_static" not in raw["vis"] and raw["vis"]["voltron_tokens"].dtype == np.uint16
            batch = {s: pp.train_batch(raw[s], generator=stream_generator(4, "aug", step, "cpu"))
                     for s in sorted(raw)}
            assert batch["lang"]["voltron_tokens"].dtype == torch.bfloat16
            assert "lang_latent_goal" in batch["lang"]
            train_step(hand, batch, generator=stream_generator(4, "step", step, "cpu"))
    finally:
        loader.close()
        for name, fwd in zip(("visual_goal", "language_goal", "img_encoder"), towers):
            setattr(getattr(net, name), "forward", fwd)
    _assert_bit_equal(state, hand)
