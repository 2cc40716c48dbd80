"""Offline key extraction — the `preprocess/extract_by_key.py` equivalent (a
copy of `mdt_policy_tpu/data/extract.py`):

    python -m mdt_policy_tpu_torch.data.extract -i /data/task_D_D/training --frames

Sweeps every `episode_*.npz` under a CALVIN dataset split and stacks one key
(default `rel_actions`) into `extracted/ep_{key}.npy` + `ep_npz_names.list`,
turning the training action reads from ~10 npz opens per sample into one
mmap'd row gather (the reference's documented ~2 GB/iteration fix,
README.md:79-80; ref preprocess/extract_by_key.py:43-153).

`extract_frames` goes beyond the reference: it extracts the IMAGE keys too,
into per-key contiguous mmap-able arrays. The reference only ever extracted
rel_actions and kept paying per-sample npz zip parsing for camera frames —
its documented input-pipeline bottleneck. A contiguous uint8 row gather is a
pure memcpy, where an npz frame costs a zip parse and a decompress.

Includes the reference's self-check: N random rows re-read from source npz
files must match the extracted matrix (ref :104-121).
"""

from __future__ import annotations

import argparse
import logging
import re
from pathlib import Path
from typing import Sequence

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["extract_by_key", "extract_frames", "FRAME_KEYS"]

FRAME_KEYS = ("rgb_static", "rgb_gripper", "robot_obs", "scene_obs")


def _episode_files(dataset_dir: Path):
    frame_re = re.compile(r"episode_(\d+)\.npz$")
    files = sorted(
        (p for p in dataset_dir.glob("episode_*.npz")),
        key=lambda p: int(frame_re.search(p.name).group(1)))
    if not files:
        raise FileNotFoundError(f"no episode_*.npz under {dataset_dir}")
    names = [int(frame_re.search(p.name).group(1)) for p in files]
    return files, names


def extract_by_key(dataset_dir, key: str = "rel_actions", *,
                   out_dir=None, self_check: int = 13) -> Path:
    dataset_dir = Path(dataset_dir)
    out_dir = Path(out_dir) if out_dir else dataset_dir / "extracted"
    out_dir.mkdir(parents=True, exist_ok=True)

    files, names = _episode_files(dataset_dir)
    rows = []
    for p in files:
        with np.load(p) as ep:
            rows.append(np.asarray(ep[key]))
    values = np.stack(rows)

    out_npy = out_dir / f"ep_{key}.npy"
    np.save(out_npy, values)
    with open(out_dir / "ep_npz_names.list", "w") as f:
        f.write("\n".join(str(n) for n in names) + "\n")

    # self-check random rows against source files (ref extract_by_key.py:104-121)
    rng = np.random.default_rng(0)
    for i in rng.integers(0, len(files), min(self_check, len(files))):
        with np.load(files[i]) as ep:
            np.testing.assert_array_equal(values[i], ep[key])
    logger.info("extracted %s: %s rows -> %s", key, len(values), out_npy)
    return out_npy


def extract_frames(dataset_dir, keys: Sequence[str] = FRAME_KEYS, *,
                   out_dir=None, self_check: int = 13) -> Path:
    """Extract per-frame keys (camera images, robot_obs) into contiguous
    mmap-able `extracted/ep_{key}.npy` arrays, one pass over the npz files.
    Incremental memmap writes keep host RSS flat regardless of dataset size."""
    dataset_dir = Path(dataset_dir)
    out_dir = Path(out_dir) if out_dir else dataset_dir / "extracted"
    out_dir.mkdir(parents=True, exist_ok=True)

    files, names = _episode_files(dataset_dir)
    with np.load(files[0]) as ep0:
        mms = {
            k: np.lib.format.open_memmap(
                out_dir / f"ep_{k}.npy", mode="w+", dtype=ep0[k].dtype,
                shape=(len(files),) + ep0[k].shape)
            for k in keys
        }
    for i, p in enumerate(files):
        with np.load(p) as ep:
            for k in keys:
                mms[k][i] = ep[k]
    for k in keys:
        mms[k].flush()
    with open(out_dir / "ep_npz_names.list", "w") as f:
        f.write("\n".join(str(n) for n in names) + "\n")

    rng = np.random.default_rng(0)
    for i in rng.integers(0, len(files), min(self_check, len(files))):
        with np.load(files[i]) as ep:
            for k in keys:
                np.testing.assert_array_equal(mms[k][i], ep[k])
    logger.info("extracted frames %s: %d rows -> %s", keys, len(files), out_dir)
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-i", "--input", required=True, help="dataset split dir")
    ap.add_argument("-k", "--key", default="rel_actions")
    ap.add_argument("--frames", action="store_true",
                    help="also extract camera frames + robot_obs into "
                         "contiguous mmap arrays (fast image path)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    extract_by_key(args.input, args.key)
    if args.frames:
        extract_frames(args.input)


if __name__ == "__main__":
    main()
