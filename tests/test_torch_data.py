"""The data pipeline of the PyTorch port against the JAX package's, on the
CPU, over synthetic on-disk CALVIN splits (built as tests/test_data.py
builds them): the window functions, proprio, `CalvinDataset` (vis and lang,
training and validation, with and without extracted frames and relative
actions, the embedding cache with and without augmented variants, depth and
scene keys), `CachedCalvinDataset`, `extract_by_key` and `extract_frames`,
`BatchLoader` and `DualStreamLoader` batches, the train-time transforms and
`Preprocessor.train_batch`, all from the same seeds. Every comparison but
the preprocessor's is exact, key by key and dtype by dtype; the one
difference by design is that the port's cached Voltron tokens are the
cache's uint16 bits where JAX views them as ml_dtypes bfloat16.

Also, port only: `DevicePrefetcher` on the CPU, and the `start_batch`
fast-forward replaying the skipped batches' window draws.
"""

import shutil
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import yaml

from mdt_policy_tpu.data import dataset as jdataset
from mdt_policy_tpu.data import extract as jextract
from mdt_policy_tpu.data import loader as jloader
from mdt_policy_tpu.data import memory_cache as jcache
from mdt_policy_tpu.data import proprio as jproprio
from mdt_policy_tpu.data import transforms as jtransforms
from mdt_policy_tpu.data import windows as jwindows
from mdt_policy_tpu_torch.data import dataset as pdataset
from mdt_policy_tpu_torch.data import extract as pextract
from mdt_policy_tpu_torch.data import loader as ploader
from mdt_policy_tpu_torch.data import memory_cache as pcache
from mdt_policy_tpu_torch.data import proprio as pproprio
from mdt_policy_tpu_torch.data import transforms as ptransforms
from mdt_policy_tpu_torch.data import windows as pwindows

H = 16  # tiny frames
N_FRAMES = 140
BOUNDS = ((0, 79), (80, 139))
TEXTS = ("open the drawer", "push the red block right")


def write_split(root, *, hw=H, gripper_hw=H, seed=0, depth=False):
    """A CALVIN split: two episodes of per-frame npz files (frames [0, 80)
    and [80, 140)), ep_start_end_ids.npy, annotations under
    lang_clip_resnet50/, statistics.yaml, and extracted rel_actions."""
    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    np.save(root / "ep_start_end_ids.npy", np.array(BOUNDS))
    for i in range(N_FRAMES):
        extra = {}
        if depth:
            extra = {"depth_static": rng.uniform(0.5, 2.0, (hw, hw)).astype(np.float32),
                     "depth_gripper": rng.uniform(0.1, 1.0, (gripper_hw, gripper_hw)
                                                  ).astype(np.float32)}
        np.savez(root / f"episode_{i:07d}.npz",
                 rgb_static=rng.integers(0, 255, (hw, hw, 3), dtype=np.uint8),
                 rgb_gripper=rng.integers(0, 255, (gripper_hw, gripper_hw, 3), dtype=np.uint8),
                 robot_obs=rng.normal(size=15).astype(np.float32) + i,
                 scene_obs=rng.normal(size=24).astype(np.float32),
                 rel_actions=rng.uniform(-1, 1, 7).astype(np.float32), **extra)
    lang = {"info": {"indx": list(BOUNDS)},
            "language": {"emb": rng.normal(size=(2, 1, 384)).astype(np.float32),
                         "ann": list(TEXTS)}}
    (root / "lang_clip_resnet50").mkdir()
    np.save(root / "lang_clip_resnet50" / "auto_lang_ann.npy", lang, allow_pickle=True)
    stats = {"robot_obs": [{"_target_": "mdt.utils.transforms.NormalizeVector",
                            "mean": rng.normal(size=15).tolist(),
                            "std": np.abs(rng.normal(size=15)).tolist()}],
             "act_max_bound": 1.0}
    (root / "statistics.yaml").write_text(yaml.safe_dump(stats))
    jextract.extract_by_key(root, "rel_actions")
    return root


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """{name: split dir}: training and validation without extracted frames;
    the same with extracted frames; a training split with depth frames."""
    base = tmp_path_factory.mktemp("calvin")
    out = {"training": write_split(base / "plain" / "training"),
           "validation": write_split(base / "plain" / "validation", seed=1),
           "depth": write_split(base / "depth" / "training", seed=2, depth=True)}
    for split in ("training", "validation"):
        frames = base / "frames" / split
        shutil.copytree(out[split], frames)
        jextract.extract_frames(frames)
        out[f"{split}_frames"] = frames
    return out


def _assert_same(mine, theirs, path=""):
    """Exact equality of a sample or batch, key by key and dtype by dtype;
    voltron_tokens: the port's uint16 bits against JAX's bf16 bits."""
    if isinstance(theirs, dict):
        assert sorted(mine) == sorted(theirs), path
        for k in theirs:
            _assert_same(mine[k], theirs[k], f"{path}/{k}")
        return
    if isinstance(theirs, (list, str)):
        assert mine == theirs, path
        return
    theirs = np.asarray(theirs)
    mine = np.asarray(mine)
    if theirs.dtype == ml_dtypes.bfloat16:
        assert mine.dtype == np.uint16, path
        theirs = theirs.view(np.uint16)
    assert mine.dtype == theirs.dtype and mine.shape == theirs.shape, \
        (path, mine.dtype, theirs.dtype, mine.shape, theirs.shape)
    np.testing.assert_array_equal(mine, theirs, err_msg=path)


# ---------------------------------------------------------------------------
# windows and proprio
# ---------------------------------------------------------------------------

def test_window_functions_match_jax():
    lookup = np.concatenate([np.arange(0, 59), np.arange(80, 119)])
    for idx in (0, 7, 40, 58, 70, 96, 12345 % len(lookup)):
        for lo, hi in ((21, 50), (21, 30), (10, 10)):
            assert pwindows.get_validation_window_size(idx, lo, hi) == \
                jwindows.get_validation_window_size(idx, lo, hi)
            assert pwindows.max_window_for_index(lookup, idx, lo, hi) == \
                jwindows.max_window_for_index(lookup, idx, lo, hi)
    for strategy in ("geometric", "random"):
        for validation in (False, True):
            ra, rb = np.random.default_rng(3), np.random.default_rng(3)
            got = [pwindows.sample_window_size(lookup, i, 21, 50, validation=validation,
                                               strategy=strategy, rng=ra) for i in range(97)]
            want = [jwindows.sample_window_size(lookup, i, 21, 50, validation=validation,
                                                strategy=strategy, rng=rb) for i in range(97)]
            assert got == want
            assert ra.bit_generator.state == rb.bit_generator.state


@pytest.mark.parametrize("normalize,orientation", [(True, True), (True, False), (False, True)])
def test_proprio_matches_jax(splits, normalize, orientation):
    stats_p = pproprio.load_statistics(splits["training"])
    stats_j = jproprio.load_statistics(splits["training"])
    _assert_same(stats_p, stats_j)
    assert pproprio.load_statistics(splits["training"] / "nowhere") == {}
    obs = np.random.default_rng(0).normal(size=(4, 2, 15)).astype(np.float32)
    pc = pproprio.ProprioConfig(normalize=normalize, normalize_robot_orientation=orientation)
    jc = jproprio.ProprioConfig(normalize=normalize, normalize_robot_orientation=orientation)
    _assert_same(pproprio.process_state(obs, stats_p, pc), jproprio.process_state(obs, stats_j, jc))
    episode = {"robot_obs": obs[0], "scene_obs": obs[1]}
    _assert_same(pproprio.get_state_info_dict(episode), jproprio.get_state_info_dict(episode))


# ---------------------------------------------------------------------------
# CalvinDataset
# ---------------------------------------------------------------------------

def _pair(root, key, **kw):
    kw = {"min_window_size": 21, "max_window_size": 30, "seed": 5, **kw}
    return pdataset.CalvinDataset(root, key=key, **kw), jdataset.CalvinDataset(root, key=key, **kw)


def test_indices_match_jax(splits):
    root = splits["training"]
    _assert_same(pdataset.build_vision_indices(root, 21), jdataset.build_vision_indices(root, 21))
    got = pdataset.build_lang_indices(root, "lang_clip_resnet50", 21, skip_frames=3)
    want = jdataset.build_lang_indices(root, "lang_clip_resnet50", 21, skip_frames=3)
    for a, b in zip(got, want):
        _assert_same(a, b)
    assert pdataset.lookup_naming_pattern(root) == jdataset.lookup_naming_pattern(root)


@pytest.mark.parametrize("split", ["training", "validation", "training_frames",
                                   "validation_frames"])
@pytest.mark.parametrize("key", ["vis", "lang"])
@pytest.mark.parametrize("extracted_actions", [True, False])
def test_dataset_samples_and_batches_match_jax(splits, split, key, extracted_actions):
    """Samples in one order, then batches: the same windows (the training
    split draws them from the dataset's rng), frames, actions, goals."""
    kw = dict(use_extracted_rel_actions=extracted_actions, proprio=True,
              include_scene_obs=True, img_gen_frame_diff=-1 if key == "lang" else 3)
    mine, theirs = _pair(splits[split], key, **kw)
    assert len(mine) == len(theirs)
    for idx in (0, 3, 17, 40, len(theirs) - 1, 3):
        _assert_same(mine[idx], theirs[idx], f"{split}/{key}/{idx}")
    idxs = np.array([5, 1, 57, len(theirs) - 2])
    got, want = mine.get_batch(idxs), theirs.get_batch(idxs)
    if want is None:
        assert got is None and not mine.can_gather()
    else:
        _assert_same(got, want)
    assert mine.rng.bit_generator.state == theirs.rng.bit_generator.state


@pytest.mark.parametrize("aug_variants", [0, 2])
@pytest.mark.parametrize("key", ["vis", "lang"])
def test_embedding_cache_samples_match_jax(splits, tmp_path, aug_variants, key):
    """The cache layout of extract_embeddings (bf16 tokens as uint16 bits,
    f32 image and text goals, K shift variants): samples and batches draw
    the same variants."""
    root = tmp_path / "training"
    shutil.copytree(splits["training_frames"], root)
    ex = root / "extracted"
    rng = np.random.default_rng(7)
    n = N_FRAMES
    np.save(ex / "ep_voltron_tokens.npy", rng.integers(0, 2 ** 16, (n, 8, 16), dtype=np.uint16))
    np.save(ex / "ep_clip_img_emb.npy", rng.normal(size=(n, 4)).astype(np.float32))
    np.save(ex / "ep_voltron_tokens_aug.npy",
            rng.integers(0, 2 ** 16, (n, 3, 8, 16), dtype=np.uint16))
    np.save(ex / "ep_clip_img_emb_aug.npy", rng.normal(size=(n, 3, 4)).astype(np.float32))
    np.save(ex / "ep_lang_goal_emb.npy", rng.normal(size=(2, 4)).astype(np.float32))
    mine, theirs = _pair(root, key, use_extracted_embeddings=True,
                         embedding_aug_variants=aug_variants)
    assert mine.aug_variants == theirs.aug_variants == aug_variants
    for idx in (0, 9, 33, 9):
        _assert_same(mine[idx], theirs[idx])
    idxs = np.array([2, 40, 11])
    _assert_same(mine.get_batch(idxs), theirs.get_batch(idxs))


def test_depth_keys_match_jax(splits):
    mine, theirs = _pair(splits["depth"], "vis", depth_keys=("depth_static", "depth_gripper"))
    for idx in (0, 50, 2):
        _assert_same(mine[idx], theirs[idx])
    assert mine.get_batch(np.array([0, 1])) is None  # depth keys read npz files


def test_cached_dataset_matches_jax(splits):
    kw = {"min_window_size": 21, "max_window_size": 30, "seed": 1}
    mine = pcache.CachedCalvinDataset(
        pdataset.CalvinDataset(splits["training"], key="lang", **kw), max_bytes=40_000)
    theirs = jcache.CachedCalvinDataset(
        jdataset.CalvinDataset(splits["training"], key="lang", **kw), max_bytes=40_000)
    mine.preload(limit=30)
    theirs.preload(limit=30)
    assert mine._bytes == theirs._bytes and list(mine._cache) == list(theirs._cache)
    assert len(mine) == len(theirs)
    for idx in (0, 4, 70, 4):
        _assert_same(mine[idx], theirs[idx])
    assert list(mine._cache) == list(theirs._cache)


def test_extraction_matches_jax(splits, tmp_path):
    """extract_by_key and extract_frames write the same files, byte for
    byte; the port's CLI writes what its functions do."""
    src = splits["depth"]
    mine, theirs = tmp_path / "mine", tmp_path / "theirs"
    pextract.extract_by_key(src, "rel_actions", out_dir=mine)
    jextract.extract_by_key(src, "rel_actions", out_dir=theirs)
    keys = ("rgb_static", "robot_obs", "depth_static")
    pextract.extract_frames(src, keys, out_dir=mine)
    jextract.extract_frames(src, keys, out_dir=theirs)
    names = sorted(p.name for p in theirs.iterdir())
    assert names == sorted(p.name for p in mine.iterdir())
    for name in names:
        assert (mine / name).read_bytes() == (theirs / name).read_bytes(), name
    cli = tmp_path / "cli" / "training"
    shutil.copytree(src, cli)
    shutil.rmtree(cli / "extracted")
    pextract.main(["-i", str(cli), "--frames"])
    jextract.extract_frames(src, out_dir=theirs)
    for name in ("ep_rel_actions.npy", "ep_rgb_gripper.npy", "ep_scene_obs.npy",
                 "ep_npz_names.list"):
        assert (cli / "extracted" / name).read_bytes() == (theirs / name).read_bytes(), name


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

def _tok(texts, n):
    return np.array([[len(t) % 97 + 1] * n for t in texts], np.int32)


def _loaders(pkg_loader, pkg_dataset, root, seed, start_batch=0, key=None):
    kw = {"min_window_size": 21, "max_window_size": 30, "seed": seed}
    common = dict(num_workers=1, prefetch=1, start_batch=start_batch)
    vis = pkg_loader.BatchLoader(pkg_dataset.CalvinDataset(root, key="vis", **kw), 8,
                                 seed=seed, **common)
    lang = pkg_loader.BatchLoader(pkg_dataset.CalvinDataset(root, key="lang", **kw), 8,
                                  seed=seed + 1, tokenizer=_tok, context_length=6, **common)
    return pkg_loader.DualStreamLoader(vis, lang)


@pytest.mark.parametrize("split,start_batch", [
    ("training", 0), ("training_frames", 0), ("validation", 3), ("validation_frames", 3),
    ("validation_frames", 13)])
def test_dual_stream_batches_match_jax(splits, split, start_batch):
    """The same per-epoch permutations, windows and tokens, across an epoch
    boundary (12 batches an epoch here), from the same seed and start_batch;
    one decode thread, as the two packages' draws then do not depend on
    which thread decodes which slice. A fast-forward is compared on the
    validation splits, whose windows are hashed: on a training split the
    port replays the skipped batches' window draws and JAX does not (see
    test_start_batch_replays_the_skipped_draws)."""
    mine = _loaders(ploader, pdataset, splits[split], 11, start_batch)
    theirs = _loaders(jloader, jdataset, splits[split], 11, start_batch)
    try:
        a, b = iter(mine), iter(theirs)
        for _ in range(14 - start_batch):
            _assert_same(next(a), next(b))
    finally:
        mine.close()
        theirs.close()


@pytest.mark.parametrize("split", ["training", "training_frames"])
def test_start_batch_replays_the_skipped_draws(splits, split):
    """Port only: a stream started at batch k (one decode thread) equals the
    tail of the uninterrupted stream, windows included, across an epoch
    boundary, for the batched and the per-sample path."""
    full = _loaders(ploader, pdataset, splits[split], 4)
    try:
        it = iter(full)
        reference = [next(it) for _ in range(15)]
    finally:
        full.close()
    for start in (2, 13):
        resumed = _loaders(ploader, pdataset, splits[split], 4, start_batch=start)
        try:
            it = iter(resumed)
            for want in reference[start:]:
                _assert_same(next(it), want)
        finally:
            resumed.close()


def test_collate_matches_jax(splits):
    mine, theirs = _pair(splits["training"], "lang")
    samples = [theirs[i] for i in (0, 1, 2)]
    _assert_same(ploader.collate(samples), jloader.collate(samples))


# ---------------------------------------------------------------------------
# transforms and the train pipeline
# ---------------------------------------------------------------------------

def test_noise_and_action_transforms_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    noise = rng.normal(size=x.shape).astype(np.float32)
    with mock.patch.object(jax.random, "normal", lambda k, s, d=jnp.float32: jnp.asarray(noise)):
        want = jtransforms.add_gaussian_noise(jax.random.PRNGKey(0), jnp.asarray(x), std=0.05,
                                              mean=0.1)
    got = ptransforms.add_gaussian_noise(torch.from_numpy(x), std=0.05, mean=0.1,
                                         noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    mean, std = rng.normal(size=4).astype(np.float32), np.abs(rng.normal(size=4)).astype(np.float32)
    std[1] = 0.0
    np.testing.assert_array_equal(
        ptransforms.normalize_vector(torch.from_numpy(x), torch.from_numpy(mean),
                                     torch.from_numpy(std)).numpy(),
        np.asarray(jtransforms.normalize_vector(jnp.asarray(x), mean, std)))

    gamma = rng.gamma(1000.0, size=(3,)).astype(np.float32)
    with mock.patch.object(jax.random, "gamma", lambda k, a, s: jnp.asarray(gamma)):
        want = jtransforms.add_depth_noise(jax.random.PRNGKey(0), jnp.asarray(x), sample_shape=(3,))
    got = ptransforms.add_depth_noise(torch.from_numpy(x), sample_shape=(3,),
                                      gamma=torch.from_numpy(gamma))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    actions = rng.uniform(-4, 4, (6, 10, 7)).astype(np.float32)
    robot = rng.uniform(-4, 4, (6, 10, 15)).astype(np.float32)
    np.testing.assert_allclose(
        ptransforms.relative_actions(torch.from_numpy(actions), torch.from_numpy(robot),
                                     0.02, 0.05).numpy(),
        np.asarray(jtransforms.relative_actions(jnp.asarray(actions), jnp.asarray(robot),
                                                0.02, 0.05)), rtol=1e-6, atol=1e-6)


def test_train_batch_matches_jax_with_its_draws(splits):
    """`Preprocessor.train_batch` against JAX's `_train_impl` over a depth
    batch, the shift offsets and the depth noise given to both sides as
    numpy draws: bf16 cameras within one bf16 rounding (rtol 8e-3, the
    train pipeline's bound in tests/test_torch_extract.py), f32 keys within
    the eval pipeline's atol 1e-5, the rest exact."""
    ds = jdataset.CalvinDataset(splits["depth"], key="lang", min_window_size=21,
                                max_window_size=30, depth_keys=("depth_static", "depth_gripper"))
    raw = jloader.collate([ds[i] for i in (0, 5, 9)])
    raw["lang_tokens"] = _tok(raw.pop("lang_text"), 6)
    sizes = dict(static_size=32, gripper_size=24, gen_size=16, static_pad=2, gripper_pad=1)
    rng = np.random.default_rng(3)
    B = 3
    draws = {"rgb_static": rng.integers(0, 5, (2 * B, 2)),
             "rgb_gripper": rng.integers(0, 3, (2 * B, 2)),
             "depth_gripper": {"noise": rng.normal(size=raw["depth_gripper"].shape
                                                   ).astype(np.float32)},
             "depth_static": {"gamma": rng.gamma(1000.0, size=(B,)).astype(np.float32),
                              "noise": rng.normal(size=raw["depth_static"].shape
                                                  ).astype(np.float32)}}
    shifts = iter([draws["rgb_static"], draws["rgb_gripper"]])
    normals = iter([draws["depth_gripper"]["noise"], draws["depth_static"]["noise"]])
    with mock.patch.object(jax.random, "randint", lambda *a, **k: jnp.asarray(next(shifts))), \
            mock.patch.object(jax.random, "gamma",
                              lambda *a: jnp.asarray(draws["depth_static"]["gamma"])), \
            mock.patch.object(jax.random, "normal", lambda *a: jnp.asarray(next(normals))):
        want = jloader.Preprocessor(**sizes)._train_impl(jax.random.PRNGKey(0), {
            k: v for k, v in raw.items() if not isinstance(v, list)})
    pp = ploader.Preprocessor(**sizes, device="cpu")
    tdraws = {k: torch.from_numpy(v) if isinstance(v, np.ndarray)
              else {kk: torch.from_numpy(vv) for kk, vv in v.items()} for k, v in draws.items()}
    got = pp.train_batch(raw, draws=tdraws)
    assert sorted(got) == sorted(want)
    for k in want:
        ref = np.asarray(want[k])
        out = got[k]
        if k in ("rgb_static", "rgb_gripper"):
            assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
            np.testing.assert_allclose(out.float().numpy(), ref.astype(np.float32),
                                       rtol=8e-3, atol=1e-6, err_msg=k)
        elif out.dtype == torch.float32:
            assert ref.dtype == np.float32, k
            np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(out.numpy(), ref, err_msg=k)
    # drawn from a generator: the same draws twice, every key of train_draws
    a = pp.train_batch(raw, generator=torch.Generator().manual_seed(1))
    b = pp.train_batch(raw, generator=torch.Generator().manual_seed(1))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert sorted(pp.train_draws(raw, torch.Generator())) == sorted(draws)
    with pytest.raises(ValueError, match="generator"):
        pp.train_batch(raw)


def test_train_batch_views_cache_bits_as_bf16():
    bits = np.random.default_rng(0).integers(0, 2 ** 16, (2, 4, 8), dtype=np.uint16)
    raw = {"voltron_tokens": bits, "gen_static": np.zeros((2, 8, 8, 3), np.uint8),
           "gen_gripper": np.zeros((2, 8, 8, 3), np.uint8),
           "actions": np.zeros((2, 10, 7), np.float64), "lang_text": ["a", "b"]}
    out = ploader.Preprocessor(gen_size=8, device="cpu").train_batch(
        raw, generator=torch.Generator())
    assert out["voltron_tokens"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["voltron_tokens"].view(torch.int16).numpy().view(np.uint16),
                                  bits)
    assert "lang_text" not in out and out["actions"].dtype == torch.float32


# ---------------------------------------------------------------------------
# DevicePrefetcher (CPU: the same thread, no stream)
# ---------------------------------------------------------------------------

def test_prefetcher_order_preloaded_and_start_index():
    raws = [{"s": {"v": np.asarray([i])}} for i in range(5)]
    seen = []

    def fn(i, batch):
        seen.append(i)
        assert torch.is_tensor(batch["s"]["v"])
        return {"s": {"v": batch["s"]["v"] + 100 * i}}

    pre = {"s": {"v": torch.tensor([-1])}}
    pf = ploader.DevicePrefetcher(iter(raws), fn, device="cpu", depth=2, start_index=7,
                                  preloaded=(pre,))
    out = [int(next(pf)["s"]["v"]) for _ in range(6)]
    pf.close()
    assert out == [-1] + [i + 100 * (7 + i) for i in range(5)]
    assert seen == [7, 8, 9, 10, 11]


def test_prefetcher_raises_the_threads_error_and_closes():
    def boom(i, batch):
        raise RuntimeError("decode failed")

    pf = ploader.DevicePrefetcher(iter([{"s": {"v": np.zeros(1)}}]), boom, device="cpu")
    with pytest.raises(RuntimeError, match="decode failed"):
        next(pf)
    pf.close()

    # close() releases a thread blocked on a full queue
    pf = ploader.DevicePrefetcher(iter({"s": {"v": np.zeros(1)}} for _ in range(100)),
                                  lambda i, b: b, device="cpu", depth=1)
    next(pf)
    pf.close()
    pf._thread.join(timeout=10)
    assert not pf._thread.is_alive()
    assert threading.active_count() < 50
