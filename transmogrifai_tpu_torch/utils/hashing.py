"""MurmurHash3 (x86_32) and hashing-TF helpers.

Host copy of ``transmogrifai_tpu/utils/hashing.py``.  Counterpart of the reference's hashing stack (reference: core/.../impl/
feature/OPCollectionHashingVectorizer.scala:42,76-86 using
mllib.feature.HashingTF with murmur3, seed 42).  Pure-python murmur3 here
for correctness; the batch path vectorizes over tokens and is replaced by a
C++ kernel for bulk ingest (native/ directory) when available.
"""
from __future__ import annotations

import numpy as np

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_MASK = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def murmur3_32(data: bytes, seed: int = 42) -> int:
    """murmur3_x86_32 over bytes; returns unsigned 32-bit int."""
    h = seed & _MASK
    n = len(data)
    n4 = n & ~0x3
    for i in range(0, n4, 4):
        k = int.from_bytes(data[i : i + 4], "little")
        k = (k * _C1) & _MASK
        k = _rotl32(k, 15)
        k = (k * _C2) & _MASK
        h ^= k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & _MASK
    k = 0
    tail = data[n4:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * _C1) & _MASK
        k = _rotl32(k, 15)
        k = (k * _C2) & _MASK
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK
    h ^= h >> 16
    return h


def hash_token(token: str, num_features: int, seed: int = 42) -> int:
    return murmur3_32(token.encode("utf-8"), seed) % num_features


def hashing_tf(
    token_lists: list[list[str]],
    num_features: int,
    seed: int = 42,
    binary: bool = False,
) -> np.ndarray:
    """Term-frequency hashing of tokenized rows -> dense [n, num_features]."""
    out = np.zeros((len(token_lists), num_features), dtype=np.float32)
    cache: dict[str, int] = {}
    for i, toks in enumerate(token_lists):
        for t in toks:
            j = cache.get(t)
            if j is None:
                j = hash_token(t, num_features, seed)
                cache[t] = j
            if binary:
                out[i, j] = 1.0
            else:
                out[i, j] += 1.0
    return out
