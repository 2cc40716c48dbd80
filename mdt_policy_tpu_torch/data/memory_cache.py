"""In-RAM episode cache — the SharedMemoryLoader / ShmDataset equivalent (a
copy of `mdt_policy_tpu/data/memory_cache.py`).

The reference preloads the dataset into POSIX shared memory so its 12
DataLoader *processes* can read zero-copy (`mdt/datasets/utils/
shared_memory_utils.py:61-336`, `shm_dataset.py:12-163`). This framework's
loader is thread-based (data/loader.py), so plain process-local RAM gives the
same zero-copy reads without segment naming, offset lookup tables, or SIGTERM
unlink handlers — that machinery existed purely to cross the fork boundary.

`CachedCalvinDataset` wraps any CalvinDataset and caches decoded frame dicts
up to a byte budget (LRU); `preload` warms the cache like `prepare_data`
(hulc_data_module.py:77-85).
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["CachedCalvinDataset"]


class CachedCalvinDataset:
    """LRU frame cache in front of a CalvinDataset's file reads."""

    def __init__(self, dataset, max_bytes: int = 8 << 30):
        self.dataset = dataset
        self.max_bytes = max_bytes
        self._cache: "OrderedDict[int, Dict[str, np.ndarray]]" = OrderedDict()
        self._bytes = 0
        # intercept the wrapped dataset's frame loader
        self._load_frame_orig = dataset._load_frame
        dataset._load_frame = self._load_frame  # type: ignore[assignment]

    def _load_frame(self, file_idx: int) -> Dict[str, np.ndarray]:
        hit = self._cache.get(file_idx)
        if hit is not None:
            self._cache.move_to_end(file_idx)
            return hit
        with self._load_frame_orig(file_idx) as npz:
            frame = {k: np.asarray(npz[k]) for k in npz.files}
        size = sum(v.nbytes for v in frame.values())
        while self._bytes + size > self.max_bytes and self._cache:
            _, old = self._cache.popitem(last=False)
            self._bytes -= sum(v.nbytes for v in old.values())
        self._cache[file_idx] = frame
        self._bytes += size
        return frame

    def preload(self, limit: Optional[int] = None):
        """Warm the cache over the episode range (ref prepare_data /
        SharedMemoryLoader.load_data_in_shared_memory)."""
        lookup = self.dataset.episode_lookup
        lo, hi = int(lookup.min()), int(lookup.max())
        n = 0
        for idx in range(lo, hi + 1):
            if limit is not None and n >= limit:
                break
            if self._bytes >= self.max_bytes:
                logger.info("cache budget reached at %d frames", n)
                break
            self._load_frame(idx)
            n += 1
        logger.info("preloaded %d frames (%.1f GB)", n, self._bytes / 1e9)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[idx]

    def __getattr__(self, name):
        return getattr(self.dataset, name)
