"""The port's language annotator against the JAX package's, on the CPU:
`scan_dataset` over one synthetic split (windows, tasks and sentences
exactly, the same per-episode draws), and the CLI with `--scripted-oracle`
and the MiniLM embedder over one folder (its weights carried across, so the
embeddings agree at 1e-4); `st_embed_fn` over a stub
`sentence_transformers`; and one port-only chain: a tiny `train()`, the
MiniLM annotator writing `embeddings.npy`, then `evaluate.main
--use-embeddings --fake-env --device cpu` with those embeddings as goals."""

import json
import sys
import types

import numpy as np
import pytest
import torch

from mdt_policy_tpu.data import bench_loader as jbench
from mdt_policy_tpu.data import lang_annotator as jla
from mdt_policy_tpu_torch.data import lang_annotator as la
from mdt_policy_tpu_torch.evaluation.annotations import train_annotations
from mdt_policy_tpu_torch.utils import from_jax
from mdt_policy_tpu_torch.utils.safetensors_io import save_safetensors
from test_torch_minilm import _jax_params, _vocab

WINDOW = dict(window=20, stride=10)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("annotate") / "training"
    jbench.generate_dataset(root, 150, static_hw=16, gripper_hw=16, episode_len=50)
    return root


def _alternating():
    """An oracle that names one known task, nothing, two tasks or an
    unknown one, by the end frame's state, so that the calls' order across
    threads does not matter."""
    def detect(start, end):
        assert start["robot_obs"].shape == (15,) and end["scene_obs"].shape == (24,)
        pick = int(abs(end["robot_obs"][0]) * 1000) % 4
        return [["open_drawer"], [], ["lift_red_block_table", "close_drawer"],
                ["not_a_task"]][pick]
    return detect


def test_scan_dataset_matches_jax(split):
    table = train_annotations()
    ours = la.scan_dataset(split, _alternating(), table, num_workers=3, seed=5, **WINDOW)
    ref = jla.scan_dataset(split, _alternating(), table, num_workers=2, seed=5, **WINDOW)
    assert ours == ref
    indices, tasks, sentences = ours
    assert 0 < len(indices) < 3 * 3  # some windows kept, not all
    assert any(a >= 50 for a, _ in indices)  # the later episodes' offsets


def _minilm_folder(root, hidden=32, heads=2, seed=1):
    from test_torch_minilm import TINY
    tiny = {**TINY, "hidden_size": hidden, "num_heads": heads}
    sd = from_jax.minilm_from_jax(_jax_params(seed, **tiny))
    root.mkdir(parents=True)
    (root / "config.json").write_text(json.dumps(dict(
        vocab_size=tiny["vocab_size"], hidden_size=hidden, num_hidden_layers=tiny["num_layers"],
        num_attention_heads=heads, intermediate_size=tiny["intermediate_size"],
        max_position_embeddings=tiny["max_position_embeddings"], type_vocab_size=2)))
    _vocab(root / "vocab.txt", tiny["vocab_size"])
    save_safetensors({k: v.numpy() for k, v in sd.items()}, root / "model.safetensors")
    return root


def test_annotator_cli_matches_jax(split, tmp_path, monkeypatch):
    pytest.importorskip("transformers")  # the JAX embedder's tokenizer
    folder = _minilm_folder(tmp_path / "minilm")
    args = ["--root", str(split), "--embedder", f"minilm:{folder}",
            "--scripted-oracle", "open_drawer", "--window", "20", "--stride", "10",
            "--validation"]
    la.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["lang_annotator", *args, "--out", str(tmp_path / "jax")])
    jla.main()
    ours = np.load(tmp_path / "port" / "auto_lang_ann.npy", allow_pickle=True).item()
    ref = np.load(tmp_path / "jax" / "auto_lang_ann.npy", allow_pickle=True).item()
    assert ours["info"] == ref["info"]
    assert ours["language"]["ann"] == ref["language"]["ann"]
    assert ours["language"]["task"] == ref["language"]["task"] == \
        ["open_drawer"] * len(ref["info"]["indx"])
    assert ours["language"]["emb"].shape == (len(ref["info"]["indx"]), 1, 32)
    np.testing.assert_allclose(ours["language"]["emb"], ref["language"]["emb"],
                               rtol=1e-4, atol=1e-4)
    table = np.load(tmp_path / "port" / "embeddings.npy", allow_pickle=True).item()
    jtable = np.load(tmp_path / "jax" / "embeddings.npy", allow_pickle=True).item()
    assert table.keys() == jtable.keys() and len(table) == 34
    for task, row in table.items():
        assert row["ann"] == jtable[task]["ann"]
        np.testing.assert_allclose(row["emb"], jtable[task]["emb"], rtol=1e-4, atol=1e-4)
    if not torch.cuda.is_available():  # the card is the default
        with pytest.raises(RuntimeError, match="CUDA"):
            la.main(args + ["--out", str(tmp_path / "nocard")])


def test_st_embed_fn_over_a_stub_package(monkeypatch):
    class SentenceTransformer:
        def __init__(self, path):
            self.seed = len(path)

        def encode(self, sentences, convert_to_numpy, show_progress_bar):
            assert convert_to_numpy and not show_progress_bar
            return np.stack([np.random.default_rng(self.seed + len(s)).normal(size=12)
                             for s in sentences])

    monkeypatch.setitem(sys.modules, "sentence_transformers",
                        types.SimpleNamespace(SentenceTransformer=SentenceTransformer))
    embed, jembed = la.make_embed_fn("st:some/model"), jla.make_embed_fn("st:some/model")
    for s in ("open the drawer", "lift the red block"):
        e = embed(s)
        assert e.dtype == np.float32 and e.shape == (12,)
        np.testing.assert_array_equal(e, jembed(s))
    with pytest.raises(ValueError, match="unknown embedder"):
        la.make_embed_fn("bogus")


def test_train_then_minilm_annotation_then_evaluate_with_embeddings(tmp_path, capsys):
    from mdt_policy_tpu_torch import evaluate
    from mdt_policy_tpu_torch.evaluation.annotations import validation_annotations
    from mdt_policy_tpu_torch.training import train
    from test_torch_training_cli import REAL, _cfg

    cfg = _cfg(tmp_path, "minilmrun", overrides=REAL, max_epochs=1, steps_per_epoch=1)
    train(cfg, device="cpu")
    run = tmp_path / "minilmrun"
    goal_dim = REAL["goal_dim"]
    folder = _minilm_folder(tmp_path / "minilm", hidden=goal_dim, heads=2, seed=3)
    dataset = tmp_path / "dataset"
    la.write_embeddings(dataset / cfg.data.lang_folder, validation_annotations(),
                        la.make_embed_fn(f"minilm:{folder}", device="cpu"))
    table = np.load(dataset / cfg.data.lang_folder / "embeddings.npy", allow_pickle=True).item()
    assert next(iter(table.values()))["emb"].shape == (goal_dim,)
    evaluate.main(["--train-folder", str(run), "--fake-env", "--use-embeddings",
                   "--dataset-path", str(dataset), "--device", "cpu",
                   "--num-sequences", "1", "--ep-len", "2", "--steps", "2"])
    printed = json.loads(capsys.readouterr().out)
    results = json.loads((run / "evaluation" / "results.json").read_text())
    assert "avg_seq_len" in next(iter(results.values()))
    assert printed["avg_seq_len"] == next(iter(results.values()))["avg_seq_len"]
    # the clip embedder over the same run directory: its EMA text tower
    from mdt_policy_tpu_torch.utils.clip_tokenizer import tokenize
    net, agent_cfg, _ = evaluate.load_run_agent(run, device="cpu")
    sentence = "open the drawer"
    with torch.no_grad():
        want = net.encode_language_goal(torch.from_numpy(
            tokenize([sentence], agent_cfg.clip_context_length)))[0].numpy()
    np.testing.assert_array_equal(la.clip_embed_fn(str(run), device="cpu")(sentence), want)
