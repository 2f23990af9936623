"""The part of JAX's threefry2x32 generator that the JAX package's forests
draw from, in numpy uint32.

Counterpart of ``jax.random.PRNGKey``, ``jax.random.fold_in`` and
``jax.random.bernoulli`` under JAX's default key implementation with
``jax_threefry_partitionable`` on (``jax/_src/prng.py``: the seed split,
the Threefry-2x32 hash of 20 rounds, ``iota_2x32_shape``,
``_threefry_fold_in`` and ``_threefry_random_bits_partitionable``;
``jax/_src/random.py``: ``_uniform`` and ``_bernoulli``).  Every function
gives the same bits as its JAX counterpart.

A key is a pair of uint32 words; the functions take keys as arrays whose
last axis holds the pair and broadcast over the rest.  The arithmetic is
numpy uint32, whose additions and shifts wrap as the hash needs; the
forests' masks depend only on the keys and the tree level, never on the
data, so the host computes them once and the device reads them.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of the counter pairs (x0, x1) under the key
    (k0, k1); all four broadcast together.  Returns the two output
    words."""
    k0, k1, x0, x1 = np.broadcast_arrays(
        *(np.asarray(a, dtype=np.uint32) for a in (k0, k1, x0, x1)))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):  # uint32 wraparound is the hash
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed) -> np.ndarray:
    """``jax.random.PRNGKey`` of non-negative int32 seeds (an array of them
    is the key of each, as ``jax.vmap(jax.random.PRNGKey)`` gives): the key
    ``(0, seed)``.  Returns uint32 [..., 2]."""
    seed = np.asarray(seed, dtype=np.int64)
    if (seed < 0).any() or (seed > np.iinfo(np.int32).max).any():
        raise ValueError("prng_key takes int32 seeds in [0, 2**31 - 1]")
    return np.stack([np.zeros_like(seed), seed], axis=-1).astype(np.uint32)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the counter pair ``(0, data)``
    under ``key``.  Returns uint32 [..., 2]."""
    key = np.asarray(key, dtype=np.uint32)
    out0, out1 = threefry2x32(key[..., 0], key[..., 1], 0,
                              np.asarray(data, dtype=np.uint32))
    return np.stack([out0, out1], axis=-1)


def random_bits(key, shape) -> np.ndarray:
    """32 random bits for each element of ``shape`` under each key
    (uint32 [*key batch, *shape]): the counter of an element is its
    row-major flat index as the pair (high word, low word), and its bits
    are the xor of the hash's two words."""
    key = np.asarray(key, dtype=np.uint32)
    size = int(np.prod(shape, dtype=np.int64))
    flat = np.arange(size, dtype=np.uint64)
    hi = (flat >> np.uint64(32)).astype(np.uint32)
    lo = (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    batch = key.shape[:-1]
    k0 = key[..., 0].reshape(batch + (1,))
    k1 = key[..., 1].reshape(batch + (1,))
    out0, out1 = threefry2x32(k0, k1, hi, lo)
    return (out0 ^ out1).reshape(batch + tuple(shape))


def uniform(key, shape) -> np.ndarray:
    """float32 uniforms in [0, 1): the top 23 bits of each element's bits
    as the mantissa of a float in [1, 2), less one."""
    bits = random_bits(key, shape)
    one = np.uint32(np.float32(1.0).view(np.uint32))
    return ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)


def bernoulli(key, p, shape) -> np.ndarray:
    """``jax.random.bernoulli(key, float32(p), shape)``: bool
    [*key batch, *shape], each element true where its uniform is below
    ``float32(p)``."""
    return uniform(key, shape) < np.float32(p)
