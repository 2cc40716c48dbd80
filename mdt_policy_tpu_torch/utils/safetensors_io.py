"""The `model.safetensors` format with numpy: the port's reader and writer,
in place of the `safetensors` package that the JAX package's MiniLM loader
imports (`mdt_policy_tpu/models/minilm.py:165-176`) and that the card's
machine does not have.

The format: 8 bytes of little-endian header length N, N bytes of JSON
({name: {"dtype", "shape", "data_offsets": [begin, end]}}, with an optional
"__metadata__"), then the tensors' raw little-endian bytes, the offsets
counted from the end of the header. Read: F32, F16, BF16 (widened to f32
through its uint16 bits) and I64. Written: float32 and int64 arrays.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Mapping

import numpy as np

__all__ = ["load_safetensors", "save_safetensors"]

_READ = {"F32": np.dtype("<f4"), "F16": np.dtype("<f2"), "BF16": np.dtype("<u2"),
         "I64": np.dtype("<i8")}
_WRITE = {np.dtype("float32"): "F32", np.dtype("int64"): "I64"}


def load_safetensors(path) -> Dict[str, np.ndarray]:
    """name -> array (BF16 as float32)."""
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    header.pop("__metadata__", None)
    body = memoryview(data)[8 + n:]
    out = {}
    for name, meta in header.items():
        if meta["dtype"] not in _READ:
            raise ValueError(f"{path}: tensor {name!r} has dtype {meta['dtype']}, "
                             f"not one of {sorted(_READ)}")
        begin, end = meta["data_offsets"]
        arr = np.frombuffer(body[begin:end], dtype=_READ[meta["dtype"]])
        if meta["dtype"] == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr.reshape(meta["shape"]).copy()
    return out


def save_safetensors(tensors: Mapping[str, np.ndarray], path) -> None:
    """Writes float32 and int64 arrays, in the order given; the header is
    padded with spaces to a multiple of 8 bytes, as the package pads it."""
    header, chunks, offset = {}, [], 0
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype not in _WRITE:
            raise ValueError(f"tensor {name!r}: dtype {arr.dtype} is not float32 or int64")
        raw = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        header[name] = {"dtype": _WRITE[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    Path(path).write_bytes(struct.pack("<Q", len(blob)) + blob + b"".join(chunks))
