"""Miscellaneous runtime utilities (port of `mdt_policy_tpu/utils/misc.py`;
ref `mdt/utils/utils.py:17-195`). The JAX compile cache
(`enable_compile_cache`) has no counterpart here."""

from __future__ import annotations

import functools
import logging
import platform
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["timeit", "get_git_commit_hash", "print_system_env_info",
           "initialize_pretrained_weights", "get_portion_of_batch_ids", "full_f32"]


def timeit(fn):
    """Wall-clock decorator (ref utils.py:17-29)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        logger.info("%s took %.3fs", fn.__name__, time.perf_counter() - t0)
        return out
    return wrapper


def get_git_commit_hash(repo_path: Optional[Path] = None) -> str:
    """(ref utils.py:44-62)"""
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"],
            cwd=repo_path or Path(__file__).resolve().parents[2],
            text=True, stderr=subprocess.DEVNULL).strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def full_f32() -> None:
    """Run float32 matmuls and cuDNN convolutions in full float32, not TF32:
    the computation the parity tests hold against the JAX package. The
    command-line entry points and `train()` call this; library functions
    leave the flags to their caller."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def print_system_env_info() -> Dict[str, Any]:
    """(ref utils.py:91-137): the software, the CUDA devices, the TF32 flags
    and cuDNN's determinism flag, logged and returned."""
    cuda = torch.cuda.is_available()
    info = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": np.__version__,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        if cuda else [],
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_deterministic": torch.backends.cudnn.deterministic,
        "git_commit": get_git_commit_hash(),
    }
    for k, v in info.items():
        logger.info("%s: %s", k, v)
    return info


def initialize_pretrained_weights(params: Mapping[str, torch.Tensor],
                                  pretrained: Mapping[str, torch.Tensor],
                                  skip_prefixes: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """Partial checkpoint initialization over `state_dict`s: a copy of
    `params` in which every entry of `pretrained` with a matching name and
    shape, outside `skip_prefixes`, replaces the entry of `params` (ref
    initialize_pretrained_weights, utils.py:32-42). Load the result with
    `load_state_dict`."""
    out = dict(params)
    copied = 0
    for name, value in pretrained.items():
        if any(name.split(".", 1)[0] == p for p in skip_prefixes):
            continue
        if name in params and tuple(params[name].shape) == tuple(value.shape):
            out[name] = value
            copied += 1
    logger.info("initialized %d/%d tensors from pretrained weights", copied, len(params))
    return out


def get_portion_of_batch_ids(percentage: float, batch_size: int) -> np.ndarray:
    """Deterministically spread indices over a batch (ref utils.py:139-158)."""
    num = int(batch_size * percentage)
    if num == 0:
        return np.array([], dtype=int)
    indices = np.linspace(0, batch_size - 1, num)
    return np.unique(np.round(indices).astype(int))
