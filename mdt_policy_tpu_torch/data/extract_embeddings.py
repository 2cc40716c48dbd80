"""Frozen-tower embedding extraction (port of
`mdt_policy_tpu/data/extract_embeddings.py`): the frozen Voltron and CLIP
vision towers run once over every frame of a CALVIN split, and the CLIP text
tower once over every annotation sentence, and their outputs are cached
beside the dataset. A train step fed from the cache runs no tower at all
(`MDTVAgentNet.forward` on a batch with `voltron_tokens`,
`image_latent_goal` and `lang_latent_goal`).

The layout is the JAX package's, so a cache written by either package loads
in the other. Under `extracted/`, row-aligned with `ep_npz_names.list`:

  ep_voltron_tokens.npy      (N, 2*tokens, D) bfloat16 stored as uint16 bits
                             (an f32 tower's tokens rounded to bf16)
  ep_clip_img_emb.npy        (N, E) float32
  ep_voltron_tokens_aug.npy  (N, K, 2*tokens, D) and ep_clip_img_emb_aug.npy
                             (N, K, E), for `aug_variants` K > 0: each frame
                             through resize -> random shift -> normalize
  embeddings_meta.json       shapes, dtypes, aug settings, source
  ep_lang_goal_emb.npy       (A, E) float32, one row per annotation sentence

The towers run through the half-block kernels B4 + B5 (`halfblocks=True`,
the default) or through B1 + B3 (`halfblocks=False`). Each variant's random
shifts come from a `torch.Generator` seeded from (aug_seed, variant, first
row), so a recomputed batch is bit-identical; the self-check recomputes
random batches and compares them bit for bit.

The command line loads a run directory's weights (the port's
`evaluate.load_run_agent`, EMA unless `--no-ema`) on `--device` (default
`cuda`) and runs both over a split:

    python -m mdt_policy_tpu_torch.data.extract_embeddings -i /data/task_D_D/training \
        --train-folder runs/<name> [--aug-variants 2] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.clip_tokenizer import tokenize
from .extract import _episode_files
from .transforms import preprocess_rgb_eval, preprocess_rgb_train

logger = logging.getLogger(__name__)

__all__ = ["extract_embeddings", "extract_lang_goals", "make_fwd", "make_aug_fwd",
           "aug_generator", "load_embeddings", "main", "EMBEDDING_FILES",
           "AUG_EMBEDDING_FILES"]

EMBEDDING_FILES = ("ep_voltron_tokens.npy", "ep_clip_img_emb.npy")
AUG_EMBEDDING_FILES = ("ep_voltron_tokens_aug.npy", "ep_clip_img_emb_aug.npy")


class _FrameReader:
    """Raw uint8 camera frames by extraction row: contiguous mmap gathers
    when the extracted frame arrays exist, per-npz loads otherwise."""

    def __init__(self, dataset_dir: Path):
        dataset_dir = Path(dataset_dir)
        ex = dataset_dir / "extracted"
        if (ex / "ep_rgb_static.npy").exists() and \
                (ex / "ep_rgb_gripper.npy").exists():
            self.static = np.load(ex / "ep_rgb_static.npy", mmap_mode="r")
            self.gripper = np.load(ex / "ep_rgb_gripper.npy", mmap_mode="r")
            self.files = None
            with open(ex / "ep_npz_names.list") as f:
                self.names = [int(x.strip()) for x in f]
        else:
            self.files, self.names = _episode_files(dataset_dir)
            self.static = self.gripper = None

    def __len__(self) -> int:
        return len(self.names)

    def read(self, rows: np.ndarray):
        if self.files is None:
            return np.asarray(self.static[rows]), np.asarray(self.gripper[rows])
        s, g = [], []
        for r in rows:
            with np.load(self.files[int(r)]) as ep:
                s.append(np.asarray(ep["rgb_static"]))
                g.append(np.asarray(ep["rgb_gripper"]))
        return np.stack(s), np.stack(g)


def _bits(t: torch.Tensor) -> np.ndarray:
    """Tokens on the host as the cache stores them: bf16, as uint16 bits
    (tokens of an f32 tower are rounded to bf16 first)."""
    return t.detach().to(torch.bfloat16).cpu().view(torch.int16).numpy().view(np.uint16)


def _frames(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)  # a copy: mmap rows are read-only


def aug_generator(aug_seed: int, variant: int, lo: int, device) -> torch.Generator:
    """The random-shift generator of one (variant, batch) block, seeded from
    (aug_seed, variant, first row of the batch)."""
    seed = int(np.random.SeedSequence([aug_seed, variant, lo]).generate_state(1)[0])
    return torch.Generator(device).manual_seed(seed)


def make_fwd(net, *, static_size: int, gripper_size: int, halfblocks: bool = True):
    """The eval-pipeline tower forward that extraction caches: resize ->
    CLIP-normalize -> frozen towers, the frames the towers see at rollout.
    Returns fwd(static_u8, gripper_u8) -> (tokens, goal embedding)."""

    @torch.no_grad()
    def fwd(static_u8, gripper_u8):
        dev = net.device
        s = preprocess_rgb_eval(_frames(static_u8, dev), size=static_size)
        g = preprocess_rgb_eval(_frames(gripper_u8, dev), size=gripper_size)
        return (net.voltron_camera_tokens(s, g, halfblocks=halfblocks),
                net.encode_visual_goal(s, halfblocks=halfblocks))

    return fwd


def make_aug_fwd(net, *, static_size: int, gripper_size: int, static_pad: int = 10,
                 gripper_pad: int = 4, halfblocks: bool = True):
    """The train-pipeline tower forward (the JAX `make_aug_fwd`): resize ->
    random shift -> CLIP-normalize -> frozen towers, the sequence the
    full-mode step applies. Returns fwd(static_u8, gripper_u8, *,
    generator=None, offsets=None) -> (tokens, goal embedding): the static
    shifts are drawn from `generator` before the gripper shifts, or
    `offsets` gives both as a (static, gripper) pair of (B, 2) tensors."""

    @torch.no_grad()
    def fwd(static_u8, gripper_u8, *, generator=None, offsets=(None, None)):
        dev = net.device
        s = preprocess_rgb_train(_frames(static_u8, dev), size=static_size,
                                 shift_pad=static_pad, generator=generator,
                                 offsets=offsets[0])
        g = preprocess_rgb_train(_frames(gripper_u8, dev), size=gripper_size,
                                 shift_pad=gripper_pad, generator=generator,
                                 offsets=offsets[1])
        tokens = net.voltron_camera_tokens(s, g, halfblocks=halfblocks)
        # the goal tower sees the augmented static frame too, as the goal
        # frame rides the same rgb_static train pipeline in full mode
        return tokens, net.encode_visual_goal(s, halfblocks=halfblocks)

    return fwd


@contextlib.contextmanager
def _deterministic():
    """cuDNN without autotuning and with deterministic algorithms for the
    patch convolutions, so that a recomputed batch is bit-identical."""
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.deterministic = saved


def extract_embeddings(dataset_dir, net, *, batch_size: int = 64, out_dir=None,
                       self_check: int = 2, source: str = "", aug_variants: int = 0,
                       aug_seed: int = 0, static_pad: int = 10, gripper_pad: int = 4,
                       halfblocks: bool = True) -> Path:
    """Run the frozen towers over every frame of a split and cache their
    outputs under `extracted/` (or `out_dir`). `net` is an `MDTVAgentNet`;
    its `voltron_camera_tokens` and `encode_visual_goal` are the frozen
    boundary the cache replaces. Raises if the self-check's recomputed rows
    differ in any bit."""
    dataset_dir = Path(dataset_dir)
    out_dir = Path(out_dir) if out_dir else dataset_dir / "extracted"
    out_dir.mkdir(parents=True, exist_ok=True)

    static_size = net.cfg.img_size
    gripper_size = min(84, static_size)
    dev = net.device
    fwd = make_fwd(net, static_size=static_size, gripper_size=gripper_size,
                   halfblocks=halfblocks)
    fwd_aug = make_aug_fwd(net, static_size=static_size, gripper_size=gripper_size,
                           static_pad=static_pad, gripper_pad=gripper_pad,
                           halfblocks=halfblocks) if aug_variants else None

    reader = _FrameReader(dataset_dir)
    n = len(reader)
    B = min(batch_size, n)

    def run(lo: int, k: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Rows lo..lo+B (the tail padded to B, then cut), clean or variant k."""
        rows = np.arange(lo, min(lo + B, n))
        if len(rows) < B:
            rows = np.concatenate([rows, np.full(B - len(rows), rows[-1])])
        with _deterministic():
            if k is None:
                tok, emb = fwd(*reader.read(rows))
            else:
                tok, emb = fwd_aug(*reader.read(rows),
                                   generator=aug_generator(aug_seed, k, lo, dev))
        kk = min(B, n - lo)
        return _bits(tok)[:kk], emb.float().cpu().numpy()[:kk]

    tok0, emb0 = run(0)
    tokens_mm = np.lib.format.open_memmap(
        out_dir / "ep_voltron_tokens.npy", mode="w+", dtype=np.uint16,
        shape=(n,) + tok0.shape[1:])
    emb_mm = np.lib.format.open_memmap(
        out_dir / "ep_clip_img_emb.npy", mode="w+", dtype=np.float32,
        shape=(n,) + emb0.shape[1:])
    tokens_mm[:len(tok0)] = tok0
    emb_mm[:len(emb0)] = emb0
    aug_tok_mm = aug_emb_mm = None
    if aug_variants:
        aug_tok_mm = np.lib.format.open_memmap(
            out_dir / "ep_voltron_tokens_aug.npy", mode="w+", dtype=np.uint16,
            shape=(n, aug_variants) + tok0.shape[1:])
        aug_emb_mm = np.lib.format.open_memmap(
            out_dir / "ep_clip_img_emb_aug.npy", mode="w+", dtype=np.float32,
            shape=(n, aug_variants) + emb0.shape[1:])
    for lo in range(B, n, B):
        tok, emb = run(lo)
        tokens_mm[lo:lo + len(tok)] = tok
        emb_mm[lo:lo + len(emb)] = emb
    for k in range(aug_variants):
        for lo in range(0, n, B):
            tok, emb = run(lo, k)
            aug_tok_mm[lo:lo + len(tok), k] = tok
            aug_emb_mm[lo:lo + len(emb), k] = emb
        logger.info("extracted aug variant %d/%d", k + 1, aug_variants)
    for mm in (tokens_mm, emb_mm, aug_tok_mm, aug_emb_mm):
        if mm is not None:
            mm.flush()

    names_file = out_dir / "ep_npz_names.list"
    if not names_file.exists():
        names_file.write_text("\n".join(str(x) for x in reader.names) + "\n")
    else:
        with open(names_file) as f:
            existing = [int(x.strip()) for x in f]
        if existing != list(reader.names):
            raise RuntimeError(f"{names_file} row order disagrees with the "
                               "frame sweep: extracted/ is inconsistent")

    (out_dir / "embeddings_meta.json").write_text(json.dumps({
        "voltron_tokens": {"dtype": "bfloat16 (uint16 bits)",
                           "shape": list(tokens_mm.shape)},
        "clip_img_emb": {"dtype": "float32", "shape": list(emb_mm.shape)},
        "img_size": static_size,
        "aug_variants": aug_variants,
        "aug_seed": aug_seed,
        "aug_pads": {"static": static_pad, "gripper": gripper_pad},
        "source": source,
    }, indent=2))

    # self-check: recompute random batch-aligned chunks, compare bit for bit
    rng = np.random.default_rng(0)
    n_chunks = max(1, (n + B - 1) // B)
    for lo in rng.integers(0, n_chunks, min(self_check, n_chunks)) * B:
        tok, emb = run(int(lo))
        np.testing.assert_array_equal(tokens_mm[lo:lo + len(tok)], tok)
        np.testing.assert_array_equal(emb_mm[lo:lo + len(emb)], emb)
        if aug_variants:
            k = int(rng.integers(0, aug_variants))
            atok, aemb = run(int(lo), k)
            np.testing.assert_array_equal(aug_tok_mm[lo:lo + len(atok), k], atok)
            np.testing.assert_array_equal(aug_emb_mm[lo:lo + len(aemb), k], aemb)
    logger.info("extracted embeddings for %d frames -> %s (voltron %s, clip %s)",
                n, out_dir, tokens_mm.shape, emb_mm.shape)
    return out_dir


def extract_lang_goals(dataset_dir, net, *, out_dir=None,
                       lang_folder: str = "lang_clip_resnet50",
                       context_length: int = 77,
                       halfblocks: bool = True) -> Optional[Path]:
    """Cache the frozen CLIP text embedding of every annotation sentence in
    `extracted/ep_lang_goal_emb.npy`, row-aligned with the auto_lang_ann
    order, all sentences in one tower call. Returns None (with a log) when
    the split carries no annotations."""
    dataset_dir = Path(dataset_dir)
    out_dir = Path(out_dir) if out_dir else dataset_dir / "extracted"
    for cand in (dataset_dir / lang_folder / "auto_lang_ann.npy",
                 dataset_dir / "auto_lang_ann.npy"):
        if cand.exists():
            lang_data = np.load(cand, allow_pickle=True).item()
            break
    else:
        logger.info("no auto_lang_ann.npy under %s: lang goal cache skipped", dataset_dir)
        return None
    texts = list(lang_data["language"]["ann"])
    ids = torch.from_numpy(tokenize(texts, context_length)).long().to(net.device)
    emb = net.encode_language_goal(ids, halfblocks=halfblocks)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "ep_lang_goal_emb.npy"
    np.save(out, emb.cpu().numpy().astype(np.float32))
    logger.info("cached %d annotation goal embeddings -> %s", len(texts), out)
    return out


def load_embeddings(out_dir, rows=None) -> Tuple[Dict[str, torch.Tensor], dict]:
    """A cache written by either package, as the batch keys the train step
    reads: voltron_tokens (bf16), image_latent_goal (f32) and, when cached,
    lang_latent_goal (f32, every annotation row); `rows` selects frame rows.
    Returns (tensors, embeddings_meta.json)."""
    out_dir = Path(out_dir)
    sel = slice(None) if rows is None else rows
    bits = np.load(out_dir / "ep_voltron_tokens.npy", mmap_mode="r")[sel]
    tensors = {
        "voltron_tokens": torch.from_numpy(np.array(bits).view(np.int16)).view(torch.bfloat16),
        "image_latent_goal": torch.from_numpy(np.array(
            np.load(out_dir / "ep_clip_img_emb.npy", mmap_mode="r")[sel])),
    }
    lang = out_dir / "ep_lang_goal_emb.npy"
    if lang.exists():
        tensors["lang_latent_goal"] = torch.from_numpy(np.load(lang))
    return tensors, json.loads((out_dir / "embeddings_meta.json").read_text())


def main(argv=None):
    """The extraction CLI (JAX `main`, extract_embeddings.py:320-350): the
    run directory's towers over a split, the frame cache and the
    annotation cache, in full float32 (`utils.misc.full_f32`)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-i", "--data-dir", required=True,
                    help="dataset split dir (training/ or validation/)")
    ap.add_argument("--train-folder", required=True,
                    help="training run dir whose (frozen) tower weights "
                         "compute the embeddings")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--aug-variants", type=int, default=0,
                    help="also cache K DrQ-shift-augmented embedding variants "
                         "per frame (restores the reference's RandomShiftsAug "
                         "to cache-mode training; K=2-4 typical)")
    ap.add_argument("--aug-seed", type=int, default=0)
    ap.add_argument("--no-ema", action="store_true",
                    help="use raw instead of EMA weights (frozen towers are "
                         "identical under both; this only matters for "
                         "sanity experiments)")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--lang-folder", default="lang_clip_resnet50",
                    help="annotation folder whose sentences get text-goal "
                         "embeddings cached (skipped when absent)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the towers (default cuda; raises "
                         "without one unless the CPU is named)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..evaluate import load_run_agent
    from ..utils.misc import full_f32
    full_f32()
    net, _, _ = load_run_agent(args.train_folder, use_ema=not args.no_ema,
                               device=args.device)
    extract_embeddings(args.data_dir, net, batch_size=args.batch_size,
                       out_dir=args.out_dir, source=str(args.train_folder),
                       aug_variants=args.aug_variants, aug_seed=args.aug_seed)
    extract_lang_goals(args.data_dir, net, out_dir=args.out_dir,
                       lang_folder=args.lang_folder,
                       context_length=net.cfg.clip_context_length)


if __name__ == "__main__":
    main()
