"""FNV-1 32-bit hashing with pyhash's semantics (the pure-Python path of
`mdt_policy_tpu/utils/fnv.py`).

The reference hashes a str's UTF-16-LE bytes, BOM stripped
(pyhash-0.9.3/src/Hash.h:219-268), to seed the evaluation's initial states
(`mdt/evaluation/utils.py:17,304-306`); `evaluation/initial_states.py` is
the one caller. The JAX package prefers a native C extension; the port
keeps only the bit-exact Python loop, which hashes a few dozen characters
per chain.
"""

from __future__ import annotations

__all__ = ["fnv1_32"]

_FNV1_32_INIT = 0x811C9DC5
_FNV_32_PRIME = 0x01000193


def _marshal(data) -> bytes:
    if isinstance(data, bytes):
        return data
    if isinstance(data, str):
        return data.encode("utf-16-le")
    raise TypeError("expected str or bytes")


def fnv1_32(data, seed: int = _FNV1_32_INIT) -> int:
    h = seed & 0xFFFFFFFF
    for b in _marshal(data):
        h = (h * _FNV_32_PRIME) & 0xFFFFFFFF
        h ^= b
    return h
