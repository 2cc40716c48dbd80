"""Frozen-tower embedding extraction and the cache-mode steps of the
PyTorch port against the JAX package, at a tiny config (`TINY_OVERRIDES` of
tests/test_training_cli.py, with CLIP's real vocabulary so that tokenized
annotations embed, and dropout off so that the steps compare draw for draw):
the camera transforms, the tokenizer, `extract_embeddings` and
`extract_lang_goals`, the cache layout read across the two packages, and
one cache-mode train and validation step.

The port's towers run through the half-block route (B4 + B5 plain versions
on the CPU), the JAX package's through its own modules.
"""

import functools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mdt_policy_tpu.agents import MDTVConfig as JaxConfig
from mdt_policy_tpu.agents import init_agent
from mdt_policy_tpu.agents import mdtv_agent as jagent
from mdt_policy_tpu.data.extract_embeddings import extract_embeddings as jax_extract
from mdt_policy_tpu.data.extract_embeddings import extract_lang_goals as jax_extract_lang
from mdt_policy_tpu.data.extract_embeddings import make_aug_fwd as jax_make_aug_fwd
from mdt_policy_tpu.data import transforms as jtransforms
from mdt_policy_tpu_torch.agents import (MDTVAgentNet, MDTVConfig, init_train_state,
                                         train_step, validation_step)
from mdt_policy_tpu_torch.data import extract_embeddings as pextract
from mdt_policy_tpu_torch.data import transforms as ptransforms
from mdt_policy_tpu_torch.utils.from_jax import from_jax
from test_torch_train_step import _assert_same_update, _patched_jax_random, _port_draws

# TINY_OVERRIDES of tests/test_training_cli.py; CLIP's vocabulary and a
# 16-token context as its extraction CLI test takes them; no dropout
TINY = dict(
    latent_dim=32, embed_dim=32, obs_dim=32, goal_dim=16, clip_embed_dim=16,
    n_enc_layers=1, n_dec_layers=1, n_heads=2,
    perceiver_dim=32, perceiver_depth=1, perceiver_heads=2, perceiver_dim_head=8,
    num_latents=3, img_size=32, vit_patch=16, vit_depth=1, vit_heads=2,
    clip_vision_width=32, clip_vision_layers=1, clip_vision_patch=16,
    clip_text_width=16, clip_text_layers=1, clip_text_heads=2,
    clip_context_length=16, clip_vocab_size=49408,
    gen_img_res=32, gen_patch_size=16, gen_decoder_depth=1, gen_decoder_dim=16,
    gen_decoder_heads=2, num_sampling_steps=2,
    attn_pdrop=0.0, resid_pdrop=0.0, mlp_pdrop=0.0)
F32_TOL = dict(rtol=1e-4, atol=5e-5)
BF16_ATOL = 5e-2  # the bf16 tower bound of tests/test_torch_slice.py
N_FRAMES, BATCH = 10, 4  # three batches, the last one padded
SENTENCES = ["open the drawer", "push the red block to the left",
             "turn on the led light", "lift the pink block from the sliding cabinet",
             "don't rotate it's handle!"]


@functools.cache
def _setup(dtype):
    """(JAX net, JAX train state, port net with the same weights)."""
    rng = np.random.default_rng(1)
    example = {
        "rgb_static": rng.uniform(size=(2, 2, 32, 32, 3)).astype(np.float32),
        "rgb_gripper": rng.uniform(size=(2, 2, 32, 32, 3)).astype(np.float32),
        "gen_static": rng.uniform(size=(2, 32, 32, 3)).astype(np.float32),
        "gen_gripper": rng.uniform(size=(2, 32, 32, 3)).astype(np.float32),
        "actions": rng.normal(size=(2, 10, 7)).astype(np.float32),
        "lang_tokens": rng.integers(1, 1000, size=(2, 16)).astype(np.int32),
    }
    dtypes = dict(compute_dtype=dtype, gen_compute_dtype=dtype)
    net, state = init_agent(JaxConfig(**TINY, **dtypes), jax.random.PRNGKey(0), example)
    port = MDTVAgentNet(MDTVConfig(**TINY, **dtypes), device="cpu")
    port.load_state_dict(from_jax(jax.device_get(state.params)), strict=True)
    return net, state, port


def _agents(dtype):
    """(JAX net, JAX params, port net with the same weights)."""
    net, state, port = _setup(dtype)
    return net, jax.device_get(state.params), port


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A split at CALVIN's frame sizes: extracted frame arrays (200 px static,
    84 px gripper), their row names, and annotation sentences."""
    root = tmp_path_factory.mktemp("split")
    rng = np.random.default_rng(2)
    ex = root / "extracted"
    ex.mkdir()
    np.save(ex / "ep_rgb_static.npy",
            rng.integers(0, 256, (N_FRAMES, 200, 200, 3), dtype=np.uint8))
    np.save(ex / "ep_rgb_gripper.npy",
            rng.integers(0, 256, (N_FRAMES, 84, 84, 3), dtype=np.uint8))
    (ex / "ep_npz_names.list").write_text("".join(f"{100 + i}\n" for i in range(N_FRAMES)))
    lang = root / "lang_clip_resnet50"
    lang.mkdir()
    np.save(lang / "auto_lang_ann.npy", {"language": {"ann": SENTENCES}}, allow_pickle=True)
    return root


def _floats(bits: np.ndarray) -> np.ndarray:
    """Cached bf16 token rows (uint16 bits) as float32."""
    return bits.view(ml_dtypes.bfloat16).astype(np.float32)


# ---------------------------------------------------------------------------
# transforms and tokenizer
# ---------------------------------------------------------------------------

def _frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("hw,size", [(200, 224), (200, 32), (84, 32), (84, 224), (32, 32)])
def test_resize_matches_jax(hw, size):
    """Up and down, uint8 frames: f32 rounding of sums of up to ~10 weighted
    terms of size 255 (atol 5e-4, 16 ulps of 255)."""
    x = _frames((3, hw, hw, 3))
    ref = np.asarray(jtransforms.resize_batch(jnp.asarray(x), size))
    out = ptransforms.resize_batch(torch.from_numpy(x), size)
    assert out.dtype == torch.float32 and out.shape == (3, size, size, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=5e-4)


def test_scale_and_normalize_and_eval_pipeline_match_jax():
    x = _frames((2, 3, 84, 84, 3), seed=1)  # (B, T, H, W, C)
    np.testing.assert_allclose(
        ptransforms.scale_and_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jtransforms.scale_and_normalize(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    ref = np.asarray(jtransforms.preprocess_rgb_eval(jnp.asarray(x), size=32))
    out = ptransforms.preprocess_rgb_eval(torch.from_numpy(x), size=32)
    assert out.shape == (2, 3, 32, 32, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_random_shift_matches_jax_with_its_offsets():
    """The crop at JAX's own integer offsets is the same gather, bit for bit;
    the train pipeline then agrees up to a bf16 flip of a resize rounding."""
    x = np.random.default_rng(3).normal(size=(5, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    offsets = torch.from_numpy(np.array(jax.random.randint(key, (5, 2), 0, 21)))
    np.testing.assert_array_equal(
        ptransforms.random_shift_aug(torch.from_numpy(x), 10, offsets=offsets).numpy(),
        np.asarray(jtransforms.random_shift_aug(key, jnp.asarray(x), 10)))

    u8 = _frames((5, 84, 84, 3), seed=5)
    ref = np.asarray(jtransforms.preprocess_rgb_train(key, jnp.asarray(u8), size=32,
                                                      shift_pad=10), np.float32)
    out = ptransforms.preprocess_rgb_train(torch.from_numpy(u8), size=32, shift_pad=10,
                                           offsets=offsets)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=8e-3, atol=1e-6)


def test_random_shift_from_a_generator_is_a_reproducible_crop():
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(4, 16, 16, 3)).astype(np.float32))
    a = ptransforms.random_shift_aug(x, 4, generator=torch.Generator().manual_seed(1))
    b = ptransforms.random_shift_aug(x, 4, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    padded = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (4,) * 4, mode="replicate")
    padded = padded.permute(0, 2, 3, 1)
    for i in range(4):  # every sample is the padded image at one offset
        assert any(torch.equal(a[i], padded[i, r:r + 16, c:c + 16])
                   for r in range(9) for c in range(9))
    with pytest.raises(ValueError, match="generator"):
        ptransforms.random_shift_aug(x, 4)


def test_tokenizer_gives_the_jax_ids():
    from mdt_policy_tpu.utils.clip_tokenizer import tokenize as jax_tokenize
    from mdt_policy_tpu_torch.utils.clip_tokenizer import tokenize
    texts = SENTENCES + ["  Push   the  BLUE block&amp;slide", "x² and ½ cup, café 3rd_time?!'s"]
    np.testing.assert_array_equal(tokenize(texts, 77), jax_tokenize(texts, 77))
    np.testing.assert_array_equal(tokenize(texts, 8), jax_tokenize(texts, 8))


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------

@functools.cache
def _extracted(dtype, root):
    """Both packages' caches of the split, written side by side. The JAX
    package caches bf16 towers only (it stores any token dtype's bytes in a
    bf16-shaped file), so at f32 it writes the text goals alone."""
    from pathlib import Path
    net, params, port = _agents(dtype)
    root = Path(root)
    jdir = root / f"jax_{dtype}"
    if dtype == "bfloat16":
        jax_extract(root, net, params, batch_size=BATCH, out_dir=jdir, aug_variants=1)
    jax_extract_lang(root, net, params, out_dir=jdir, context_length=16)
    pdir = pextract.extract_embeddings(root, port, batch_size=BATCH,
                                       out_dir=root / f"port_{dtype}", aug_variants=1)
    pextract.extract_lang_goals(root, port, out_dir=pdir, context_length=16)
    return jdir, pdir


def test_extraction_matches_jax_bf16(split):
    """The same files, dtypes, shapes and meta as the JAX package's cache;
    the clean rows and the text goals within the bf16 tower bound."""
    jdir, pdir = _extracted("bfloat16", str(split))
    for name in (*pextract.EMBEDDING_FILES, *pextract.AUG_EMBEDDING_FILES,
                 "ep_lang_goal_emb.npy"):
        j, p = np.load(jdir / name), np.load(pdir / name)
        assert (p.dtype, p.shape) == (j.dtype, j.shape), name
    assert json.loads((pdir / "embeddings_meta.json").read_text()) == \
        json.loads((jdir / "embeddings_meta.json").read_text())
    pairs = [(_floats(np.load(pdir / "ep_voltron_tokens.npy")),
              _floats(np.load(jdir / "ep_voltron_tokens.npy")))]
    pairs += [(np.load(pdir / n), np.load(jdir / n))
              for n in ("ep_clip_img_emb.npy", "ep_lang_goal_emb.npy")]
    for out, ref in pairs:
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, rtol=0, atol=BF16_ATOL)
    assert (pdir / "ep_npz_names.list").read_text() == \
        (split / "extracted" / "ep_npz_names.list").read_text()


def test_extraction_matches_jax_f32(split):
    """At f32 towers: the extraction forward (eval pipeline, towers) and the
    text goals against the JAX package's at the module bound; the cache holds
    the forward's tokens rounded to bf16 and its embeddings as they are."""
    jdir, pdir = _extracted("float32", str(split))
    net, params, port = _agents("float32")
    static = np.load(split / "extracted" / "ep_rgb_static.npy")
    gripper = np.load(split / "extracted" / "ep_rgb_gripper.npy")
    s = jtransforms.preprocess_rgb_eval(jnp.asarray(static), size=32)
    g = jtransforms.preprocess_rgb_eval(jnp.asarray(gripper), size=32)
    apply = functools.partial(net.apply, {"params": params})
    jtok = np.asarray(apply(s, g, method="voltron_camera_tokens"))
    jemb = np.asarray(apply(s, method="encode_visual_goal"))
    ptok, pemb = pextract.make_fwd(port, static_size=32, gripper_size=32)(static, gripper)
    np.testing.assert_allclose(ptok.numpy(), jtok, **F32_TOL)
    np.testing.assert_allclose(pemb.numpy(), jemb, **F32_TOL)
    np.testing.assert_allclose(np.load(pdir / "ep_lang_goal_emb.npy"),
                               np.load(jdir / "ep_lang_goal_emb.npy"), **F32_TOL)
    np.testing.assert_array_equal(_floats(np.load(pdir / "ep_voltron_tokens.npy")),
                                  ptok.bfloat16().float().numpy())
    np.testing.assert_array_equal(np.load(pdir / "ep_clip_img_emb.npy"), pemb.numpy())


def test_aug_variant_matches_jax_at_the_same_shifts(split):
    """One augmented batch: the port's train-pipeline forward at the JAX
    key's own offsets against the JAX `make_aug_fwd` (f32 towers; the frames
    are bf16 on both sides, so a resize rounding may flip a bf16 value)."""
    net, params, port = _agents("float32")
    static = np.load(split / "extracted" / "ep_rgb_static.npy")[:BATCH]
    gripper = np.load(split / "extracted" / "ep_rgb_gripper.npy")[:BATCH]
    key = jax.random.PRNGKey(7)
    jtok, jemb = jax_make_aug_fwd(net, params, static_size=32, gripper_size=32)(
        static, gripper, key)
    k1, k2 = jax.random.split(key)
    offsets = tuple(torch.from_numpy(np.array(jax.random.randint(k, (BATCH, 2), 0, 2 * p + 1)))
                    for k, p in ((k1, 10), (k2, 4)))
    ptok, pemb = pextract.make_aug_fwd(port, static_size=32, gripper_size=32)(
        static, gripper, offsets=offsets)
    np.testing.assert_allclose(ptok.numpy(), np.asarray(jtok), rtol=0, atol=2e-2)
    np.testing.assert_allclose(pemb.numpy(), np.asarray(jemb), rtol=0, atol=2e-2)


def test_extraction_self_check_and_aug_generators(split, tmp_path):
    """A second extraction writes the same bits (the self-check recomputes
    rows and holds them bit for bit); each (variant, batch) block has its
    own generator, and a corrupted cache row fails the self-check."""
    _, pdir = _extracted("bfloat16", str(split))
    _, _, port = _agents("bfloat16")
    again = pextract.extract_embeddings(split, port, batch_size=BATCH, out_dir=tmp_path,
                                        aug_variants=1)
    for name in (*pextract.EMBEDDING_FILES, *pextract.AUG_EMBEDDING_FILES):
        np.testing.assert_array_equal(np.load(again / name), np.load(pdir / name))
    aug = np.load(pdir / "ep_voltron_tokens_aug.npy")[:, 0]
    assert not np.array_equal(aug, np.load(pdir / "ep_voltron_tokens.npy"))
    draw = lambda *a: torch.randint(0, 1000, (8,), generator=pextract.aug_generator(*a, "cpu"))
    assert torch.equal(draw(0, 0, 4), draw(0, 0, 4))
    assert not torch.equal(draw(0, 0, 4), draw(0, 1, 4))
    assert not torch.equal(draw(0, 0, 4), draw(0, 0, 8))

    real_fwd = port.voltron_camera_tokens
    port.voltron_camera_tokens = lambda *a, **kw: real_fwd(*a, **kw) + (
        torch.rand(()) * 1e-2).to(real_fwd(*a, **kw).dtype)
    try:
        with pytest.raises(AssertionError):
            pextract.extract_embeddings(split, port, batch_size=BATCH, out_dir=tmp_path / "x")
    finally:
        del port.voltron_camera_tokens


def test_caches_load_across_packages(tmp_path):
    """A cache written by the port loads through the JAX CalvinDataset with
    the same rows; a cache written by the JAX package loads through the
    port's `load_embeddings` with the same rows; the meta keys agree."""
    from mdt_policy_tpu.data import CalvinDataset
    from mdt_policy_tpu.data.loader import collate
    from test_train_real_data import _write_split
    net, params, port = _agents("bfloat16")
    split = tmp_path / "calvin" / "validation"
    _write_split(split, 40, np.random.default_rng(3))

    pdir = pextract.extract_embeddings(split, port, batch_size=8)
    pextract.extract_lang_goals(split, port, context_length=16)
    kw = dict(min_window_size=21, max_window_size=30, use_extracted_frames=False,
              use_extracted_embeddings=True)
    s = collate([CalvinDataset(split, key="vis", **kw)[i] for i in (0, 1)])
    tok = np.load(pdir / "ep_voltron_tokens.npy")
    np.testing.assert_array_equal(s["voltron_tokens"].view(np.uint16), tok[[0, 1]])
    lang = CalvinDataset(split, key="lang", **kw)
    np.testing.assert_array_equal(lang[0]["lang_latent_goal"],
                                  np.load(pdir / "ep_lang_goal_emb.npy")[lang.lang_lookup[0]])
    port_meta = json.loads((pdir / "embeddings_meta.json").read_text())

    jdir = jax_extract(split, net, params, batch_size=8,
                                       out_dir=tmp_path / "jax")
    jax_extract_lang(split, net, params, out_dir=jdir, context_length=16)
    tensors, meta = pextract.load_embeddings(jdir, rows=np.array([3, 7]))
    assert sorted(meta) == sorted(port_meta)
    np.testing.assert_array_equal(
        tensors["voltron_tokens"].view(torch.int16).numpy().view(np.uint16),
        np.load(jdir / "ep_voltron_tokens.npy")[[3, 7]])
    np.testing.assert_array_equal(tensors["image_latent_goal"].numpy(),
                                  np.load(jdir / "ep_clip_img_emb.npy")[[3, 7]])
    np.testing.assert_array_equal(tensors["lang_latent_goal"].numpy(),
                                  np.load(jdir / "ep_lang_goal_emb.npy"))


# ---------------------------------------------------------------------------
# cache-mode steps
# ---------------------------------------------------------------------------

B = 4
N_PATCHES = 4


def _cache_batch(seed=0):
    """Both packages' dual-scope cache batches with the same values: bf16
    Voltron token rows and f32 goal embeddings."""
    rng = np.random.default_rng(seed)

    def scope():
        return {
            "voltron_tokens": rng.normal(size=(B, 8, 32)).astype(ml_dtypes.bfloat16),
            "image_latent_goal": rng.normal(size=(B, 16)).astype(np.float32),
            "lang_latent_goal": rng.normal(size=(B, 16)).astype(np.float32),
            "gen_static": rng.normal(size=(B, 32, 32, 3)).astype(np.float32),
            "gen_gripper": rng.normal(size=(B, 32, 32, 3)).astype(np.float32),
            "actions": rng.normal(size=(B, 10, 7)).astype(np.float32),
        }
    jbatch = {"vis": scope(), "lang": scope()}
    pbatch = {s: {k: (torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
                      if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v))
                  for k, v in b.items()} for s, b in jbatch.items()}
    return jbatch, pbatch


def _draws(seed=1):
    rng = np.random.default_rng(seed)
    return {s: {"sigma": rng.uniform(size=(B,)).astype(np.float32),
                "noise": rng.normal(size=(B, 10, 7)).astype(np.float32),
                "mask": rng.uniform(size=(B, N_PATCHES)).astype(np.float32)}
            for s in ("lang", "vis")}


@functools.cache
def _cache_steps():
    """(JAX, port) after one cache-mode train step from the same state, cache
    batch and draws (metrics, gradients, parameters, EMA); no tower may run
    on the port's side. The port net is restored afterwards."""
    net, state0, port = _setup("float32")
    jbatch, pbatch = _cache_batch()
    draws = _draws()
    patches, queues = _patched_jax_random(draws, ("sigma", "noise", "mask"))
    with patches[0], patches[1]:
        state1, jm = jax.jit(functools.partial(jagent.train_step, net))(
            state0, jbatch, jax.random.PRNGKey(3))
    assert not any(queues.values())  # every draw was taken
    jm = {k: float(v) for k, v in jax.device_get(jm).items()}
    b1 = net.cfg.optimizer.betas[0]
    mu = next(s.mu for s in state1.opt_state if hasattr(s, "mu"))
    jgrads = from_jax(jax.device_get(jax.tree.map(lambda m: m / (1 - b1), mu)))
    jparams = from_jax(jax.device_get(state1.params))
    jema = from_jax(jax.device_get(state1.ema_params))

    before = {k: v.clone() for k, v in port.state_dict().items()}
    state = init_train_state(port)
    with _no_tower(port):
        pm = train_step(state, pbatch, draws=_port_draws(draws))
    pm = {k: float(v) for k, v in pm.items()}
    pgrads = {n: p.grad.clone() for n, p in port.trainable_parameters()}
    pparams = {k: v.float().clone() for k, v in port.state_dict().items()}
    pema = {k: v.clone() for k, v in state.ema.items()}
    port.load_state_dict(before)
    for _, p in port.trainable_parameters():
        p.grad = None
    return from_jax(jax.device_get(state0.params)), (jm, jgrads, jparams, jema), \
        (pm, pgrads, pparams, pema)


class _no_tower:
    """Fails on any call of a frozen tower of `net` inside the block."""

    def __init__(self, net):
        self.towers = [net.img_encoder, net.visual_goal, net.language_goal]

    def __enter__(self):
        def refuse(module, args):
            raise AssertionError(f"a cache batch ran {type(module).__name__}")
        self.hooks = [t.register_forward_pre_hook(refuse) for t in self.towers]

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()


LOSSES = [f"{s}/{k}" for s in ("lang", "vis")
          for k in ("action_loss", "img_gen_loss", "cont_loss", "total_loss")] \
    + ["train/total_loss"]


def test_cache_mode_train_step_losses_and_gradients_match_jax():
    """Losses rtol 1e-4; f32 gradients of every trainable leaf rtol 1e-3,
    atol 1e-6 (the standards of tests/test_torch_train_step.py)."""
    _, (jm, jgrads, _, _), (pm, pgrads, _, _) = _cache_steps()
    assert pm["vis/cont_loss"] == 0.0 and pm["lang/cont_loss"] > 0.0
    for k in LOSSES:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=k)
    assert sorted(jgrads) == sorted(pgrads)
    for k in jgrads:
        np.testing.assert_allclose(pgrads[k].numpy(), jgrads[k].numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=k)


def test_cache_mode_train_step_update_and_ema_match_jax():
    """The AdamW update and the EMA of every trainable element match JAX's
    (`_assert_same_update` of tests/test_torch_train_step.py); the frozen
    towers do not move; the norms and the lr agree."""
    before, (jm, jgrads, jparams, jema), (pm, _, pparams, pema) = _cache_steps()
    checked = 0
    for k in jparams:
        if k.startswith(("visual_goal", "language_goal", "img_encoder")):
            torch.testing.assert_close(pparams[k], before[k], rtol=0, atol=0)
            continue
        checked += _assert_same_update(k, pparams[k], jparams[k], before[k], jgrads[k], 1e-5)
        _assert_same_update(k, pema[k], jema[k], before[k], jgrads[k], 1e-5)
    assert checked > 0.5 * sum(v.numel() for v in jgrads.values())
    for k in ("train/grad_norm", "train/param_norm"):
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(pm["train/lr"], jm["train/lr"], rtol=1e-6)


def test_cache_mode_validation_step_matches_jax():
    """The sampler from the cached goal embeddings, the action MSE and the
    foresight loss per scope, with no tower run: the bounds of
    tests/test_torch_train_step.py."""
    net, state0, port = _setup("float32")
    jbatch, pbatch = _cache_batch(seed=4)
    draws = _draws(seed=5)
    patches, queues = _patched_jax_random(draws, ("noise", "mask"))
    with patches[0], patches[1]:
        jm = jax.jit(functools.partial(jagent.validation_step, net))(
            state0.params, jbatch, jax.random.PRNGKey(6))
    assert not any(queues.values())
    jm = {k: float(v) for k, v in jax.device_get(jm).items()}
    with _no_tower(port):
        pm = {k: float(v) for k, v in
              validation_step(port, pbatch, draws=_port_draws(draws)).items()}
    assert sorted(pm) == sorted(jm)
    for k in jm:
        rtol = 1e-3 if "act_loss" in k or k == "val_act/action_loss" else 1e-4
        np.testing.assert_allclose(pm[k], jm[k], rtol=rtol, err_msg=k)


def test_cache_mode_losses_match_full_mode_on_the_same_frames(split):
    """The port's losses from its own cache rows against its full-mode
    losses on the frames the cache came from (eval-preprocessed, the
    pipeline extraction runs), same draws: 5e-3, the bound of the JAX
    package's own check (tests/test_extract_embeddings.py:85-88). The cache
    ran the towers through B4 + B5, the full mode through B1 + B3."""
    _, pdir = _extracted("bfloat16", str(split))
    _, _, port = _agents("bfloat16")
    static = torch.from_numpy(np.load(split / "extracted" / "ep_rgb_static.npy"))
    gripper = torch.from_numpy(np.load(split / "extracted" / "ep_rgb_gripper.npy"))
    obs, goal = np.arange(B), np.arange(B) + 5  # frame rows: observation, goal
    rng = np.random.default_rng(8)
    common = {"gen_static": torch.from_numpy(rng.normal(size=(B, 32, 32, 3)).astype(np.float32)),
              "gen_gripper": torch.from_numpy(rng.normal(size=(B, 32, 32, 3)).astype(np.float32)),
              "actions": torch.from_numpy(rng.normal(size=(B, 10, 7)).astype(np.float32))}
    full = dict(common,
                rgb_static=ptransforms.preprocess_rgb_eval(
                    torch.stack([static[obs], static[goal]], 1), size=32),
                rgb_gripper=ptransforms.preprocess_rgb_eval(
                    torch.stack([gripper[obs], gripper[goal]], 1), size=32))
    tensors, _ = pextract.load_embeddings(pdir)
    cache = dict(common, voltron_tokens=tensors["voltron_tokens"][obs],
                 image_latent_goal=tensors["image_latent_goal"][goal])
    draws = _port_draws(_draws(seed=9))["vis"]
    with torch.no_grad():
        out_full = port(full, "vis", train=False, draws=draws)
        with _no_tower(port):
            out_cache = port(cache, "vis", train=False, draws=draws)
    for k in out_full:
        np.testing.assert_allclose(out_cache[k].item(), out_full[k].item(),
                                   rtol=5e-3, atol=5e-3, err_msg=k)
