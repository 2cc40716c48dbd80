"""FNV-1 and FNV-1a hashing, 32 and 64 bits, with pyhash's semantics (the
pure-Python path of `mdt_policy_tpu/utils/fnv.py`).

The reference hashes a str's UTF-16-LE bytes, BOM stripped
(pyhash-0.9.3/src/Hash.h:219-268); `fnv1_32` seeds the evaluation's
initial states (`mdt/evaluation/utils.py:17,304-306`,
`evaluation/initial_states.py` here). The JAX package prefers a native C
extension and keeps these loops as its fallback; the port keeps only the
bit-exact Python loops (its callers hash a few dozen characters at a time)
and does not port the C extension.
"""

from __future__ import annotations

__all__ = ["fnv1_32", "fnv1a_32", "fnv1_64", "fnv1a_64"]

_FNV1_32_INIT = 0x811C9DC5
_FNV_32_PRIME = 0x01000193
_FNV1_64_INIT = 0xCBF29CE484222325
_FNV_64_PRIME = 0x100000001B3
_MASK_32 = 0xFFFFFFFF
_MASK_64 = 0xFFFFFFFFFFFFFFFF


def _marshal(data) -> bytes:
    if isinstance(data, bytes):
        return data
    if isinstance(data, str):
        return data.encode("utf-16-le")
    raise TypeError("expected str or bytes")


def _fnv1(data, seed: int, prime: int, mask: int) -> int:
    h = seed & mask
    for b in _marshal(data):
        h = (h * prime) & mask
        h ^= b
    return h


def _fnv1a(data, seed: int, prime: int, mask: int) -> int:
    h = seed & mask
    for b in _marshal(data):
        h ^= b
        h = (h * prime) & mask
    return h


def fnv1_32(data, seed: int = _FNV1_32_INIT) -> int:
    return _fnv1(data, seed, _FNV_32_PRIME, _MASK_32)


def fnv1a_32(data, seed: int = _FNV1_32_INIT) -> int:
    return _fnv1a(data, seed, _FNV_32_PRIME, _MASK_32)


def fnv1_64(data, seed: int = _FNV1_64_INIT) -> int:
    return _fnv1(data, seed, _FNV_64_PRIME, _MASK_64)


def fnv1a_64(data, seed: int = _FNV1_64_INIT) -> int:
    return _fnv1a(data, seed, _FNV_64_PRIME, _MASK_64)
