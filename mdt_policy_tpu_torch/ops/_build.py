"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each `csrc/<name>.cu` compiles, at its first use in a process, into a shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The output lands in `build/kernels/` beside the package (ignored by git),
keyed by a hash of the source, every shared header `csrc/*.cuh` and the
flags, so an edited source or header rebuilds and an unchanged one is
reused. Nothing here runs at import time. `current_stream` gives a launch
its stream; `count_launch`, `recording_launches` and `count_replay` keep
each wrapper's `.launches`, the kernel launches that actually ran, true
across CUDA graphs.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def digest(name: str, csrc: Path = CSRC) -> str:
    """Hash of `<csrc>/<name>.cu`, every `<csrc>/*.cuh` it may include, and
    the flags: the key of the built library."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


@functools.cache
def load_library(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """Build `<csrc>/<name>.cu` if its library is missing, then load it.
    Raises on a failed build, with the compiler's output."""
    out = BUILD_DIR / f"{name}-{digest(name, csrc)}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(csrc / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu "
                                   f"(rc={proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(out))


def current_stream(t: torch.Tensor) -> int:
    """The raw `cudaStream_t` of the current stream (under graph capture,
    the capturing one) for a launch on CUDA tensor `t`. Raises unless `t`
    lies on the current device: the kernels launch there."""
    dev = t.get_device()
    if dev != torch.cuda.current_device():
        raise ValueError(f"a tensor on cuda:{dev} while cuda:{torch.cuda.current_device()} "
                         f"is the current device; launch under torch.cuda.device({dev})")
    return torch._C._cuda_getCurrentRawStream(dev)


# While a graph is captured under `recording_launches`: wrapper -> launches
# recorded into it (a capture runs no kernel)
_recording = None


def count_launch(wrapper) -> None:
    """One launch of `wrapper`'s kernel, counted in `wrapper.launches`; while
    a CUDA graph is captured under `recording_launches`, recorded for the
    graph's replays instead."""
    if _recording is None:
        wrapper.launches += 1
    else:
        _recording[wrapper] += 1


@contextlib.contextmanager
def recording_launches():
    """Around a graph's capture: yields a Counter {wrapper: launches in the
    graph}, for `count_replay` after each replay of that graph."""
    global _recording
    outer, _recording = _recording, collections.Counter()
    try:
        yield _recording
    finally:
        _recording = outer


def count_replay(recorded) -> None:
    """Counts the launches of one replay of a graph whose capture
    `recording_launches` recorded as `recorded`."""
    for wrapper, n in recorded.items():
        wrapper.launches += n
