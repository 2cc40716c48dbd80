"""Host batching and device feeding (port of `mdt_policy_tpu/data/loader.py`).

* `BatchLoader` and `DualStreamLoader`, copied: per-epoch shuffled index
  permutations, a thread pool decoding samples, the `start_batch`
  fast-forward of a resumed run, and paired {'vis', 'lang'} streams. The
  fast-forward also replays the skipped batches' random calls
  (`CalvinDataset.replay_draws`), so that with one decode thread a resumed
  stream draws the windows of an uninterrupted one; with more threads the
  draws depend on which thread decodes which slice, in both packages.
* `Preprocessor`: the production camera pipelines (data/transforms.py) of a
  raw uint8 batch on the device, train (`train_batch`: resize, the DrQ
  shift, CLIP normalization, the foresight frames through the eval
  pipeline, depth noise) and eval (`eval_batch`).
* `DevicePrefetcher`: a thread that copies raw host batches to the card from
  pinned memory on a side CUDA stream and preprocesses them there, and a
  CUDA event that the consumer's stream waits on before it uses a batch.

Language text is tokenized host-side with the CLIP BPE tokenizer.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..agents.mdtv_agent import default_device
from ..utils.profiling import span
from .transforms import add_depth_noise, add_gaussian_noise, preprocess_rgb_eval, \
    preprocess_rgb_train

__all__ = ["collate", "BatchLoader", "DualStreamLoader", "Preprocessor",
           "DevicePrefetcher", "host_tensors"]


def collate(samples) -> Dict[str, np.ndarray]:
    """Stack a list of dataset samples into a batch dict (numpy)."""
    out: Dict[str, np.ndarray] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], (str, bytes)):
            out[k] = list(vals)  # type: ignore[assignment]
        else:
            out[k] = np.stack(vals)
    return out


class BatchLoader:
    """Epoch-shuffled batch iterator: parallel sample decode + prefetch.

    Each epoch is a fresh seeded permutation of the dataset (sampling WITHOUT
    replacement — the reference DataLoader(shuffle=True) semantics); batches
    are cut from the permutation and partial tails dropped. `num_workers`
    threads decode samples concurrently; `prefetch` finished batches are
    buffered ahead of the training loop.
    """

    def __init__(self, dataset, batch_size: int, *, seed: int = 0,
                 prefetch: int = 2, num_workers: Optional[int] = None,
                 tokenizer=None, context_length: int = 77,
                 shard_index: int = 0, num_shards: int = 1,
                 start_batch: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.prefetch = prefetch
        self.start_batch = start_batch
        self.num_workers = (num_workers if num_workers is not None
                            else min(8, os.cpu_count() or 1))
        self.tokenizer = tokenizer
        self.context_length = context_length
        self.shard_index, self.num_shards = shard_index, num_shards
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._stop = threading.Event()
        self.epoch = 0

    def _index_batches(self) -> Iterator[tuple]:
        """Infinite stream of (index batch, skipped) over per-epoch
        permutations.

        `start_batch` fast-forwards the stream by whole batches, flagged
        `skipped` (nothing is decoded for them, their random calls are
        replayed) so a preempted run resumes with exactly the batch it
        would have seen next."""
        n = len(self.dataset)
        skip = self.start_batch
        while True:
            perm = np.random.default_rng(self.seed + self.epoch).permutation(n)
            shard = perm[self.shard_index::self.num_shards]
            for i in range(0, len(shard) - self.batch_size + 1, self.batch_size):
                yield shard[i:i + self.batch_size], skip > 0
                skip = max(0, skip - 1)
            self.epoch += 1

    def _slices(self, idxs: np.ndarray):
        n_slices = max(1, min(self.num_workers, len(idxs) // 16))
        return np.array_split(np.asarray(idxs), n_slices)

    def _replay(self, idxs: np.ndarray) -> None:
        """The random calls `_make_batch(idxs)` would make, on the threads
        that would make them."""
        replay = getattr(self.dataset, "replay_draws", None)
        if replay is None:
            return
        if getattr(self.dataset, "get_batch", None) is not None and self.dataset.can_gather():
            slices = self._slices(idxs)
            if len(slices) == 1:
                replay(idxs, batched=True)
            else:
                list(self._pool.map(lambda s: replay(s, batched=True), slices))
        else:
            list(self._pool.map(lambda i: replay([i], batched=False),
                                [int(i) for i in idxs]))

    def _make_batch(self, idxs: np.ndarray) -> Dict[str, np.ndarray]:
        batch = self._gather_batch(idxs)
        if batch is None:  # per-sample fallback (no extracted frame arrays)
            samples = list(self._pool.map(self.dataset.__getitem__,
                                          [int(i) for i in idxs]))
            batch = collate(samples)
        if "lang_text" in batch and self.tokenizer is not None:
            batch["lang_tokens"] = self.tokenizer(
                batch.pop("lang_text"), self.context_length)
        return batch

    def _gather_batch(self, idxs: np.ndarray) -> Optional[Dict[str, np.ndarray]]:
        """Vectorized fast path: dataset.get_batch gathers the whole batch
        with one fancy-index per key; slices go to the worker pool so the
        memcpy parallelizes across cores."""
        get_batch = getattr(self.dataset, "get_batch", None)
        if get_batch is None:
            return None
        slices = self._slices(idxs)
        if len(slices) == 1:
            return get_batch(idxs)
        parts = list(self._pool.map(get_batch, slices))
        if any(p is None for p in parts):
            return None
        out: Dict[str, np.ndarray] = {}
        for k in parts[0]:
            if isinstance(parts[0][k], list):
                out[k] = [x for p in parts for x in p[k]]
            else:
                out[k] = np.concatenate([p[k] for p in parts])
        return out

    def _worker(self):
        try:
            for idxs, skipped in self._index_batches():
                if self._stop.is_set():
                    return
                if skipped:
                    self._replay(idxs)
                    continue
                batch = self._make_batch(idxs)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=1.0)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # propagate to the consumer, don't hang it
            while not self._stop.is_set():  # bounded: close() releases us
                try:
                    self._q.put(e, timeout=1.0)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self._thread is None:
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers,
                                            thread_name_prefix="mdt-decode")
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        while True:
            item = self._q.get()
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self):
        self._stop.set()
        if self._pool is not None:
            self._pool.shutdown(wait=False)


class DualStreamLoader:
    """Pairs a vision and a language loader into {'vis': ..., 'lang': ...}
    batches (the reference's dict-of-dataloaders, hulc_data_module.py:136-147)."""

    def __init__(self, vis_loader: BatchLoader, lang_loader: BatchLoader):
        self.vis = vis_loader
        self.lang = lang_loader

    def __iter__(self):
        for vis_b, lang_b in zip(self.vis, self.lang):
            yield {"vis": vis_b, "lang": lang_b}

    def close(self):
        self.vis.close()
        self.lang.close()


def host_tensors(raw: Dict[str, np.ndarray], *, pin: bool = False) -> Dict[str, torch.Tensor]:
    """The array keys of a raw host batch as CPU tensors (lists and object
    arrays, such as annotation text, are dropped), in pinned memory with
    `pin`. uint16 arrays are the cache's bf16 bits and become bfloat16."""
    out = {}
    for k, v in raw.items():
        if isinstance(v, list) or getattr(v, "dtype", None) == object:
            continue
        if torch.is_tensor(v):
            t = v
        else:
            a = np.asarray(v)
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
                if a.dtype == np.uint16 else torch.from_numpy(a)
        out[k] = t.pin_memory() if pin else t
    return out


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


class DevicePrefetcher:
    """Keep `depth` device-resident batches ahead of the training loop.

    A background thread pulls raw host batches ({scope: {key: array}}),
    copies their array keys to the card from pinned host memory with
    `non_blocking` copies on a side CUDA stream, runs the caller's
    `device_fn(index, batch)` (the preprocessing) on that same stream, and
    records a CUDA event behind it. The consumer's stream waits on that event
    before it uses the batch, and each of the batch's tensors is marked as
    used on the consumer's stream (`record_stream`), so the caching
    allocator does not hand its memory to the side stream again while the
    consumer still reads it. Each batch gets pinned buffers of its own;
    PyTorch's pinned-memory allocator does not reuse a buffer before the
    copy recorded on it has completed. On the CPU the same thread runs with
    no stream.

    `index` counts the batches from `start_index`, so a caller that derives
    a batch's random draws from it draws the same ones at any depth.
    `preloaded` batches, already on the device, are yielded first. An error
    in the thread is raised to the consumer at its next batch.

    Under a profile (`utils/profiling.py`) the consumer's wait is the span
    `data.next`, and the thread's work a batch `data.copy` (the pinned
    copies) and `data.preprocess` (`device_fn`), each with the batch's
    index as its rid.
    """

    def __init__(self, raw_iter, device_fn, *, device, depth: int = 2,
                 start_index: int = 0, preloaded=()):
        self._iter = raw_iter
        self._fn = device_fn
        self.device = torch.device(device)
        self._start = start_index
        self._preloaded = tuple(preloaded)
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, len(preloaded)))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="mdt-device-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=1.0)
                return True
            except queue.Full:
                continue
        return False

    def _to_device(self, raw, pin: bool):
        return {scope: {k: t.to(self.device, non_blocking=pin)
                        for k, t in host_tensors(b, pin=pin).items()}
                for scope, b in raw.items()}

    def _worker(self):
        try:
            cuda = self.device.type == "cuda"
            with ExitStack() as stack:
                stream = None
                if cuda:
                    stack.enter_context(torch.cuda.device(self.device))
                    stream = torch.cuda.Stream(self.device)
                    stack.enter_context(torch.cuda.stream(stream))
                for pre in self._preloaded:
                    if not self._put((pre, None)):
                        return
                i = self._start
                for raw in self._iter:
                    if self._stop.is_set():
                        return
                    with span("data.copy", i):
                        moved = self._to_device(raw, pin=cuda)
                    with span("data.preprocess", i):
                        out = self._fn(i, moved)
                    event = None
                    if cuda:
                        event = torch.cuda.Event()
                        event.record(stream)
                    i += 1
                    if not self._put((out, event)):
                        return
        except BaseException as e:  # propagate to the consumer, don't hang it
            self._put(e)  # bounded: gives up once close() is called

    def __iter__(self):
        return self

    def __next__(self):
        with span("data.next"):
            item = self._q.get()
            if isinstance(item, BaseException):
                raise item
            out, event = item
            if event is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(event)
                for t in _tensors(out):
                    t.record_stream(consumer)
            return out

    def close(self):
        self._stop.set()


class Preprocessor:
    """Raw uint8 frames -> the agent's input batch on `device` (default:
    CUDA), the production pipelines (calvin_transforms.yaml): the static
    camera resized to `static_size`, the gripper to `gripper_size`, the
    foresight frames to `gen_size`, then /255 and CLIP-normalized; at train
    time the cameras also take the DrQ shift (pads `static_pad`,
    `gripper_pad`) and come out in bf16, and depth frames take their
    noise."""

    CAMERAS = ("rgb_static", "rgb_gripper")

    def __init__(self, *, static_size: int = 224, gripper_size: int = 84,
                 gen_size: int = 112, static_pad: int = 10, gripper_pad: int = 4,
                 device=None):
        self.sizes = {"rgb_static": static_size, "rgb_gripper": gripper_size,
                      "gen_static": gen_size, "gen_gripper": gen_size}
        self.pads = {"rgb_static": static_pad, "rgb_gripper": gripper_pad}
        self.device = default_device(device)

    def _tensors(self, raw) -> Dict[str, torch.Tensor]:
        return {k: t.to(self.device) for k, t in host_tensors(raw).items()}

    def train_draws(self, raw, generator: torch.Generator) -> Dict:
        """The random numbers of `train_batch(raw)`, from `generator` on its
        device, in this order: the static camera's shift offsets (frames,
        2), the gripper's, then for each depth key in sorted order the gamma
        draw (B,) of a static depth key and the N(0, 1) noise of its
        shape."""
        dev = generator.device
        draws: Dict = {}
        for key in self.CAMERAS:
            if key in raw:
                frames = int(np.prod(raw[key].shape[:-3]))
                draws[key] = torch.randint(0, 2 * self.pads[key] + 1, (frames, 2),
                                           generator=generator, device=dev)
        for key in sorted(k for k in raw if k.startswith("depth")):
            shape = tuple(raw[key].shape)
            draws[key] = {}
            if "static" in key:
                draws[key]["gamma"] = torch._standard_gamma(
                    torch.full(shape[:1], 1000.0, device=dev), generator=generator)
            draws[key]["noise"] = torch.randn(shape, generator=generator, device=dev)
        return draws

    def train_batch(self, raw, *, generator: Optional[torch.Generator] = None,
                    draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """The train pipelines (the JAX `_train_impl`, loader.py:282-311):
        cameras resized, shifted, normalized, bf16; foresight frames through
        the eval pipeline; `actions` float32; each depth key as float32 with
        one gamma draw a sample (static depth) and N(0, 0.01) noise; other
        array keys as they are. The random numbers come from `draws`
        (`train_draws`' layout) or are drawn from `generator`. A cache batch
        carries no camera frames: its `voltron_tokens` bits become bf16."""
        x = self._tensors(raw)
        if draws is None:
            if generator is None:
                raise ValueError("train_batch needs a generator or the draws")
            draws = self.train_draws(x, generator)
        out = dict(x)
        for key in self.CAMERAS:
            if key in x:
                out[key] = preprocess_rgb_train(x[key], size=self.sizes[key],
                                                shift_pad=self.pads[key],
                                                offsets=draws[key])
        for key in ("gen_static", "gen_gripper"):
            out[key] = preprocess_rgb_eval(x[key], size=self.sizes[key])
        out["actions"] = x["actions"].float()
        for key in sorted(k for k in x if k.startswith("depth")):
            d = x[key].float()
            if "static" in key:
                d = add_depth_noise(d, sample_shape=d.shape[:1], gamma=draws[key]["gamma"])
            out[key] = add_gaussian_noise(d, std=0.01, noise=draws[key]["noise"])
        return out

    def eval_batch(self, raw: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Camera keys through the eval pipeline, `actions` as float32; other
        array keys pass through as tensors, lists and object arrays are
        dropped (as in JAX). A goal-image call carries only `rgb_static`."""
        out = self._tensors(raw)
        for key, x in out.items():
            if key in self.sizes:
                out[key] = preprocess_rgb_eval(x, size=self.sizes[key])
            elif key == "actions":
                out[key] = x.float()
        return out
