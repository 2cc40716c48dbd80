"""The port's MiniLM sentence encoder and the two pieces it keeps in place
of optional packages, on the CPU:

* `utils/bert_tokenizer.py` against `transformers.BertTokenizerFast`, ids
  and masks equal, on all 389 + 34 sentences of the two annotation tables
  and on accents, CJK, punctuation runs, control characters, a word over
  100 characters, unknown words and truncation;
* `utils/safetensors_io.py` against `safetensors.numpy` (F32, F16, BF16,
  I64), both ways;
* `MiniLMEncoder` against the JAX one (JAX parameters carried across by
  `from_jax.minilm_from_jax`) at atol 1e-5 with ragged padding masks, and
  `minilm_embed_fn` against JAX's on one folder, from `pytorch_model.bin`
  and from `model.safetensors`.

The comparisons with `transformers` or `safetensors` skip where the package
is absent."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdt_policy_tpu.models import minilm as jminilm
from mdt_policy_tpu_torch.models import minilm
from mdt_policy_tpu_torch.utils import from_jax
from mdt_policy_tpu_torch.utils.bert_tokenizer import BertTokenizer
from mdt_policy_tpu_torch.utils.safetensors_io import load_safetensors, save_safetensors
from test_torch_modules import jinit

TINY = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            max_position_embeddings=24, type_vocab_size=2)
EDGE_CASES = [
    "Caf\u00e9 na\u00efve \u00c9lan \u00c0\u00c9\u00ce\u00d5\u00dc \u00df \u03a3 \u03c2",
    "\u4e2d\u6587\u5b57\u7b26 mixed\u4e2d\u6587", "push!!!the...block???",
    "x" * 101, "x" * 100, "unknownwordzz qqq", " ".join(["open the drawer"] * 60),
    "tab\tnew\nline\r\x00nul\ufffd repl \u200b zw \u00a0nbsp",
    "\u0130stanbul \u01c5 \ufb01", "\u3000ideo\u2028line", "a\u0301b", "don't stop-now",
    "\U00020000 \U0002B820 \U0002B920", "", "   ",
    "\u00abquoted\u00bb \u2014 dash \u2026 ellipsis \u00bfqu\u00e9?"]


def _sentences():
    from mdt_policy_tpu_torch.evaluation.annotations import (train_annotations,
                                                             validation_annotations)
    return ([s for v in train_annotations().values() for s in v]
            + [s for v in validation_annotations().values() for s in v])


def _vocab(path, size=None):
    """Special tokens, half the tables' words, `##` pieces, letters, some
    punctuation and accented words (so that both whole words, pieces and
    [UNK] occur), filler up to `size`."""
    words = sorted({w for s in _sentences()
                    for w in s.lower().replace(",", " , ").replace(".", " . ").split()})
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words[::2]
             + [f"##{c}" for c in "abcdefghijklmnopqrstuvwxyz"] + ["##ed", "##ing", "##er"]
             + list("abcdefghijklmnopqrstuvwxyz") + [",", ".", "!", "-", "中", "café", "##é"])
    if size:
        vocab += [f"tok{i}" for i in range(size - len(vocab))]
    path.write_text("\n".join(vocab) + "\n")
    return path


@pytest.mark.parametrize("lower", [True, False])
def test_wordpiece_tokenizer_matches_bert_tokenizer_fast(tmp_path, lower):
    transformers = pytest.importorskip("transformers")
    vocab = _vocab(tmp_path / "vocab.txt")
    ref = transformers.BertTokenizerFast(str(vocab), do_lower_case=lower)
    mine = BertTokenizer(vocab, do_lower_case=lower)
    sentences = _sentences()
    assert len(sentences) == 389 + 34
    for max_length in (128, 12):
        texts = sentences + EDGE_CASES
        r = ref(texts, padding="max_length", truncation=True, max_length=max_length,
                return_tensors="np")
        m = mine(texts, max_length)
        np.testing.assert_array_equal(m["input_ids"], r["input_ids"])
        np.testing.assert_array_equal(m["attention_mask"], r["attention_mask"])
    # the cases do reach [UNK], `##` pieces and the cut
    ids = mine(EDGE_CASES, 12)["input_ids"]
    assert (ids == mine.unk_id).any() and (ids[:, -1] == mine.sep_id).any()


def test_safetensors_reader_and_writer(tmp_path):
    st_numpy = pytest.importorskip("safetensors.numpy")
    st_torch = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(0)
    arrays = {"w": rng.normal(size=(3, 5)).astype(np.float32),
              "h": rng.normal(size=(7,)).astype(np.float16),
              "ids": rng.integers(-5, 2 ** 40, size=(2, 3)).astype(np.int64),
              "scalar": np.asarray(1.5, np.float32)}
    st_numpy.save_file(arrays, str(tmp_path / "a.safetensors"))
    got = load_safetensors(tmp_path / "a.safetensors")
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v)
    bf = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32)).bfloat16()
    st_torch.save_file({"b": bf}, str(tmp_path / "b.safetensors"))
    got = load_safetensors(tmp_path / "b.safetensors")["b"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, bf.float().numpy())
    mine = {"w": arrays["w"], "ids": arrays["ids"]}
    save_safetensors(mine, tmp_path / "c.safetensors")
    back = st_numpy.load_file(str(tmp_path / "c.safetensors"))
    for k, v in mine.items():
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(ValueError, match="float32 or int64"):
        save_safetensors({"h": arrays["h"]}, tmp_path / "d.safetensors")


def _jax_params(seed=0, **config):
    ids = jnp.zeros((1, 8), jnp.int32)
    return jinit(jminilm.MiniLMEncoder(**(config or TINY)), ids, seed=seed)


def test_minilm_encoder_matches_jax_with_ragged_masks():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, TINY["vocab_size"], size=(3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[0, 8:] = 0
    mask[2, 3:] = 0
    p = _jax_params()
    ref = np.asarray(jminilm.MiniLMEncoder(**TINY).apply({"params": p}, ids, mask))
    enc = minilm.MiniLMEncoder(**TINY).eval()
    enc.load_state_dict(from_jax.minilm_from_jax(p), strict=True)
    with torch.no_grad():
        out = enc(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    # the padding is masked out: other ids under the padding change nothing
    ids2 = ids.copy()
    ids2[0, 8:] = 7
    with torch.no_grad():
        out2 = enc(torch.from_numpy(ids2).long(), torch.from_numpy(mask).long()).numpy()
    np.testing.assert_allclose(out2, out, rtol=1e-6, atol=1e-6)
    # HF key layouts, prefixed or bare, pooler dropped, load the same
    sd = enc.state_dict()
    for pfx in ("", "bert.", "0_Transformer."):
        extra = {f"{pfx}pooler.dense.weight": torch.zeros(2),
                 f"{pfx}embeddings.position_ids": torch.arange(24)}
        ported = minilm.port_minilm_weights({**{pfx + k: v for k, v in sd.items()}, **extra})
        assert set(ported) == set(sd)
        assert all(torch.equal(ported[k], sd[k]) for k in sd)
    assert minilm.MINILM_L3_CONFIG == jminilm.MINILM_L3_CONFIG


def test_minilm_embed_fn_matches_jax_from_both_weight_files(tmp_path):
    pytest.importorskip("transformers")
    pytest.importorskip("safetensors")
    p = _jax_params(seed=1)
    sd = from_jax.minilm_from_jax(p)
    config = dict(vocab_size=TINY["vocab_size"], hidden_size=TINY["hidden_size"],
                  num_hidden_layers=TINY["num_layers"], num_attention_heads=TINY["num_heads"],
                  intermediate_size=TINY["intermediate_size"],
                  max_position_embeddings=TINY["max_position_embeddings"],
                  type_vocab_size=TINY["type_vocab_size"], layer_norm_eps=1e-12)
    dirs = []
    for name in ("bin", "st"):
        d = tmp_path / name
        d.mkdir()
        (d / "config.json").write_text(json.dumps(config))
        _vocab(d / "vocab.txt", TINY["vocab_size"])
        if name == "bin":
            torch.save(sd, d / "pytorch_model.bin")
        else:
            save_safetensors({k: v.numpy() for k, v in sd.items()}, d / "model.safetensors")
        dirs.append(d)
    sentences = ["push the red block to the left", "Open the DRAWER!", "xyzzy"]
    for d in dirs:
        jembed = jminilm.minilm_embed_fn(d)
        embed = minilm.minilm_embed_fn(d, device="cpu")
        for s in sentences:
            e = embed(s)
            assert e.shape == (TINY["hidden_size"],) and e.dtype == np.float32
            np.testing.assert_allclose(e, jembed(s), rtol=1e-4, atol=1e-5)
    e_bin = minilm.minilm_embed_fn(dirs[0], device="cpu")(sentences[0])
    e_st = minilm.minilm_embed_fn(dirs[1], device="cpu")(sentences[0])
    np.testing.assert_array_equal(e_bin, e_st)


def test_minilm_embed_fn_wants_the_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        minilm.minilm_embed_fn(tmp_path)


def test_new_modules_import_no_optional_package():
    """The new modules import neither JAX nor the optional packages whose
    work they take over (`transformers`, `safetensors`,
    `sentence_transformers`)."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys\n"
            "for m in ('models.minilm', 'models.position_embeddings', 'models.encoders_misc', "
            "'data.lang_annotator', 'data.bench_loader', 'utils.flops', 'utils.bert_tokenizer', "
            "'utils.safetensors_io', 'utils.fnv', 'models', 'utils'):\n"
            "    __import__('mdt_policy_tpu_torch.' + m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'transformers', "
            "'safetensors', 'sentence_transformers', 'mdt_policy_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
