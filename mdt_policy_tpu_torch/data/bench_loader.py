"""Input-pipeline benchmark (port of `mdt_policy_tpu/data/bench_loader.py`):
sustained loader throughput, action chunks/s (= samples/s), from an
on-disk CALVIN-format split through the host path: a shuffled epoch
permutation, threaded sample decode, collation.

    python -m mdt_policy_tpu_torch.data.bench_loader --frames 2000 \\
        --batch-size 128 --steps 50 [--root <CALVIN split>] \\
        [--no-extracted-frames] [--shards 1 2 4] [--embeddings] \\
        [--prefetcher [--device cuda]]

With no --root, a synthetic split (episode npz files and the extracted
arrays) is written to a temporary directory. Prints one JSON line, with
the JAX CLI's keys. `--embeddings` times the embedding-cache input path
(a production-shape token cache is fabricated when absent); `--shards`
adds the multi-process shard scaling, each shard a `python -m` process
with `CUDA_VISIBLE_DEVICES=""` (a loader worker never touches the card);
`--prefetcher` adds `DevicePrefetcher` over the same loader (pinned
copies and `Preprocessor.train_batch` on a side stream, on `--device`).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

__all__ = ["generate_dataset", "bench", "fabricate_embedding_cache", "bench_embeddings",
           "scaling_bench", "bench_prefetcher", "main"]

_REPO = Path(__file__).resolve().parents[2]


def generate_dataset(root: Path, n_frames: int, *, static_hw: int = 200,
                     gripper_hw: int = 84, episode_len: int = 64,
                     with_lang: bool = False, seed: int = 0) -> Path:
    """Synthetic CALVIN-format split: episode_*.npz, ep_start_end_ids.npy
    (and auto_lang_ann.npy with `with_lang`), drawn from `seed` in the JAX
    package's order."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_frames):
        np.savez(root / f"episode_{i:07d}.npz",
                 rgb_static=rng.integers(0, 255, (static_hw, static_hw, 3), dtype=np.uint8),
                 rgb_gripper=rng.integers(0, 255, (gripper_hw, gripper_hw, 3), dtype=np.uint8),
                 robot_obs=rng.normal(size=15).astype(np.float32),
                 scene_obs=rng.normal(size=24).astype(np.float32),
                 rel_actions=rng.normal(size=7).astype(np.float32))
    bounds = [[s, min(s + episode_len, n_frames) - 1] for s in range(0, n_frames, episode_len)]
    np.save(root / "ep_start_end_ids.npy", np.asarray(bounds, np.int64))
    if with_lang:
        n_ann = max(1, n_frames // episode_len)
        ann = {"language": {"ann": ["push the sliding door to the left side"] * n_ann,
                            "emb": rng.normal(size=(n_ann, 1, 384)).astype(np.float32)},
               "info": {"indx": [(b[0], b[1]) for b in bounds[:n_ann]]}}
        np.save(root / "auto_lang_ann.npy", ann, allow_pickle=True)
    return root


def _loader(root, batch_size, num_workers, *, embeddings=False, extracted_frames=True,
            min_window=21, max_window=50, **loader_kw):
    from .dataset import CalvinDataset
    from .loader import BatchLoader

    ds = CalvinDataset(root, key="vis", min_window_size=min_window, max_window_size=max_window,
                       use_extracted_rel_actions=True, use_extracted_frames=extracted_frames,
                       use_extracted_embeddings=embeddings)
    return ds, BatchLoader(ds, batch_size, seed=0, num_workers=num_workers, **loader_kw)


def _timed(it, steps: int):
    """(chunks, seconds) of `steps` batches of `it`."""
    t0, n = time.perf_counter(), 0
    for _ in range(steps):
        n += len(next(it)["actions"])
    return n, time.perf_counter() - t0


def bench(root: Path, *, batch_size: int = 128, steps: int = 50, num_workers=None,
          use_extracted_frames: bool = True, min_window: int = 21,
          max_window: int = 50) -> dict:
    """Frames-path chunks/s after one warm-up batch (thread pool, first
    permutation)."""
    ds, loader = _loader(root, batch_size, num_workers, extracted_frames=use_extracted_frames,
                         min_window=min_window, max_window=max_window, prefetch=4)
    it = iter(loader)
    next(it)
    n, dt = _timed(it, steps)
    loader.close()
    return {"chunks_per_sec": n / dt, "batches": steps, "batch_size": batch_size,
            "num_workers": loader.num_workers, "extracted_frames": ds.ex_frames is not None,
            "seconds": dt}


def fabricate_embedding_cache(root: Path, *, n_tokens: int = 784, dim: int = 384,
                              emb_dim: int = 512, seed: int = 1, aug_variants: int = 0,
                              lang_goals: bool = False) -> Path:
    """Production-shape extracted embedding arrays of random bits, in
    `data/extract_embeddings.py`'s layout: the loader's cost is memory
    movement whatever the values, so the cache path is timed without the
    towers. Needs extracted/ep_npz_names.list (`extract.extract_by_key`).
    `aug_variants` > 0 adds the K-variant arrays; `lang_goals` the
    ep_lang_goal_emb.npy rows of the split's annotations."""
    root = Path(root)
    ex = root / "extracted"
    with open(ex / "ep_npz_names.list") as f:
        n = sum(1 for _ in f)
    rng = np.random.default_rng(seed)

    def fill_u16(path, shape):
        mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint16, shape=shape)
        flat = mm.reshape(-1)
        # bf16 bit patterns below inf/nan, drawn in chunks
        step = 10 ** 8
        for lo in range(0, flat.size, step):
            hi = min(flat.size, lo + step)
            flat[lo:hi] = rng.integers(0, 0x3f80, hi - lo, dtype=np.uint16)
        mm.flush()
        return mm

    fill_u16(ex / "ep_voltron_tokens.npy", (n, n_tokens, dim))
    np.save(ex / "ep_clip_img_emb.npy", rng.normal(size=(n, emb_dim)).astype(np.float32))
    if aug_variants:
        fill_u16(ex / "ep_voltron_tokens_aug.npy", (n, aug_variants, n_tokens, dim))
        np.save(ex / "ep_clip_img_emb_aug.npy",
                rng.normal(size=(n, aug_variants, emb_dim)).astype(np.float32))
    if lang_goals:
        ann_path = root / "auto_lang_ann.npy"
        if ann_path.exists():
            n_ann = len(np.load(ann_path, allow_pickle=True).item()["language"]["ann"])
            np.save(ex / "ep_lang_goal_emb.npy",
                    rng.normal(size=(n_ann, emb_dim)).astype(np.float32))
    (ex / "embeddings_meta.json").write_text(json.dumps({
        "voltron_tokens": {"dtype": "bfloat16 (uint16 bits)", "shape": [n, n_tokens, dim]},
        "clip_img_emb": {"dtype": "float32", "shape": [n, emb_dim]},
        "aug_variants": aug_variants,
        "source": "bench_loader.fabricate_embedding_cache",
    }))
    return ex


def bench_embeddings(root: Path, *, batch_size: int = 128, steps: int = 30, num_workers=None,
                     min_window: int = 21, max_window: int = 50) -> dict:
    """Embedding-cache chunks/s (`use_extracted_embeddings`): each sample
    gathers ~600 KB of Voltron tokens in place of camera frames."""
    _, loader = _loader(root, batch_size, num_workers, embeddings=True,
                        min_window=min_window, max_window=max_window, prefetch=4)
    it = iter(loader)
    b = next(it)
    if "voltron_tokens" not in b:
        raise RuntimeError("the embedding-cache batch path is not active")
    bytes_per_chunk = sum(np.asarray(v).nbytes for v in b.values()) / len(b["actions"])
    n, dt = _timed(it, steps)
    loader.close()
    cps = n / dt
    return {"chunks_per_sec": cps, "num_workers": loader.num_workers,
            "mb_per_chunk": bytes_per_chunk / 1e6,
            "gbytes_per_sec": cps * bytes_per_chunk / 1e9, "batches": steps,
            "batch_size": batch_size}


def bench_prefetcher(root: Path, *, device="cuda", batch_size: int = 128, steps: int = 20,
                     num_workers=None) -> dict:
    """Chunks/s of `DevicePrefetcher` over the frames-path loader: pinned
    copies to `device` and `Preprocessor.train_batch` (resize, shift,
    normalize) on its side stream, each batch's last tensor read on the
    consumer's stream, after one warm-up batch."""
    import torch

    from .loader import DevicePrefetcher, Preprocessor

    device = torch.device(device)
    _, loader = _loader(root, batch_size, num_workers, prefetch=4)
    pre = Preprocessor(device=device)
    gen = torch.Generator(device).manual_seed(0)
    pf = DevicePrefetcher(({"vis": b} for b in loader),
                          lambda i, raw: pre.train_batch(raw["vis"], generator=gen),
                          device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    next(pf)
    sync()
    t0, n = time.perf_counter(), 0
    for _ in range(steps):
        batch = next(pf)
        n += len(batch["actions"])
    sync()
    dt = time.perf_counter() - t0
    pf.close()
    loader.close()
    return {"chunks_per_sec": n / dt, "batches": steps, "batch_size": batch_size,
            "device": str(device), "seconds": dt}


# Multi-process scaling: the loader shards the epoch permutation
# (BatchLoader(shard_index=i, num_shards=N)); shards share no state. Each
# shard process reports its timed loop's wall clock and its user + system
# CPU seconds (getrusage covers the decode threads), so that the aggregate
# at k dedicated cores is k / (CPU seconds a chunk).

_WORKER_FLAG = "_MDT_LOADER_SCALING_WORKER"


def _scaling_worker_main():
    """A shard process: `steps` batches of its shard, wall and CPU seconds."""
    import resource

    spec = json.loads(os.environ[_WORKER_FLAG])
    _, loader = _loader(spec["root"], spec["batch_size"], 1, prefetch=2,
                        shard_index=spec["shard"], num_shards=spec["num_shards"])
    it = iter(loader)
    next(it)
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    n, wall = _timed(it, spec["steps"])
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    loader.close()
    cpu = (ru1.ru_utime - ru0.ru_utime) + (ru1.ru_stime - ru0.ru_stime)
    print(json.dumps({"chunks": n, "wall_s": wall, "cpu_s": cpu}))


def scaling_bench(root: Path, num_shards: int, *, batch_size: int = 128,
                  steps: int = 20) -> dict:
    """`num_shards` concurrent shard processes, their stats aggregated."""
    import subprocess
    import sys

    procs = []
    for i in range(num_shards):
        env = dict(os.environ)
        env[_WORKER_FLAG] = json.dumps(dict(root=str(root), shard=i, num_shards=num_shards,
                                            batch_size=batch_size, steps=steps))
        env["CUDA_VISIBLE_DEVICES"] = ""
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(_REPO), env.get("PYTHONPATH")) if p)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mdt_policy_tpu_torch.data.bench_loader"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True))
    outs = [p.communicate()[0] for p in procs]
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"scaling worker exited {p.returncode}: {out[-2000:]}")
    outs = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    chunks = sum(o["chunks"] for o in outs)
    cpu_s_per_chunk = sum(o["cpu_s"] for o in outs) / chunks
    return {
        "num_shards": num_shards,
        "chunks": chunks,
        # the slowest worker's timed loop bounds the aggregate
        "agg_wall_chunks_per_sec": chunks / max(o["wall_s"] for o in outs),
        "cpu_ms_per_chunk": 1e3 * cpu_s_per_chunk,
        "agg_at_cores": {k: round(k / cpu_s_per_chunk) for k in (1, 2, 4, 8)},
    }


def main(argv=None):
    if _WORKER_FLAG in os.environ:
        _scaling_worker_main()
        return
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=None, help="existing CALVIN split dir")
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--num-workers", type=int, default=None)
    ap.add_argument("--no-extracted-frames", action="store_true")
    ap.add_argument("--shards", type=int, nargs="+", default=None,
                    help="also run the multi-process scaling bench at these shard counts")
    ap.add_argument("--embeddings", action="store_true",
                    help="bench the embedding-cache input path (a production-shape "
                         "token cache is fabricated when absent)")
    ap.add_argument("--prefetcher", action="store_true",
                    help="also time DevicePrefetcher (pinned copies + train_batch)")
    ap.add_argument("--device", default="cuda", help="the prefetcher's device")
    args = ap.parse_args(argv)

    tmp = None
    if args.root:
        root = Path(args.root)
    else:
        from .extract import extract_by_key, extract_frames
        tmp = tempfile.mkdtemp(prefix="mdt_loader_bench_")
        root = generate_dataset(Path(tmp), args.frames)
        extract_by_key(root)
        extract_frames(root)
    try:
        if args.embeddings:
            if not (root / "extracted" / "ep_voltron_tokens.npy").exists():
                fabricate_embedding_cache(root)
            print(json.dumps(bench_embeddings(root, batch_size=args.batch_size,
                                              steps=args.steps,
                                              num_workers=args.num_workers)))
            return
        res = bench(root, batch_size=args.batch_size, steps=args.steps,
                    num_workers=args.num_workers,
                    use_extracted_frames=not args.no_extracted_frames)
        if args.shards:
            res["scaling"] = [scaling_bench(root, n, batch_size=args.batch_size,
                                            steps=args.steps) for n in args.shards]
        if args.prefetcher:
            res["prefetcher"] = bench_prefetcher(root, device=args.device,
                                                 batch_size=args.batch_size,
                                                 steps=args.steps,
                                                 num_workers=args.num_workers)
        print(json.dumps(res))
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
