"""The part of JAX's threefry2x32 generator that the JAX package draws
from, in numpy.

Counterpart of ``jax.random.PRNGKey``, ``fold_in``, ``bernoulli`` (the
forests' per-node feature subsets), ``split`` and ``normal`` (the MLP's
initial weights) and ``dirichlet`` (LDA's initial topics) under JAX's
default key implementation with ``jax_threefry_partitionable`` on
(``jax/_src/prng.py``: the seed split, the Threefry-2x32 hash of 20
rounds, ``iota_2x32_shape``, ``_threefry_fold_in``,
``_threefry_split_foldlike`` and ``_threefry_random_bits_partitionable``;
``jax/_src/random.py``: ``_uniform``, ``_bernoulli``, ``_normal_real``,
``_gamma_one`` and ``_dirichlet``).  Every function but ``dirichlet``
gives the same bits as its JAX counterpart; ``dirichlet`` draws the same
gamma variates key for key and agrees within float32 rounding of its
softmax.

A key is a pair of uint32 words; the functions take keys as arrays whose
last axis holds the pair and broadcast over the rest.  The arithmetic is
numpy uint32, whose additions and shifts wrap as the hash needs; the
draws depend only on the keys, never on the data, so the host computes
them once and the device reads them.
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


# -- split, normal and dirichlet ---------------------------------------------
# ``jax.random.split``, ``jax.random.normal`` and ``jax.random.dirichlet``
# as XLA:CPU computes them for the JAX package (``jax/_src/random.py``
# ``_split``, ``_normal_real``, ``_dirichlet``, ``_gamma_one``;
# ``jax/_src/prng.py`` ``_threefry_split_foldlike``).  The transcendental
# functions are XLA:CPU's float32 approximations, not the C library's:
# ``erf_inv`` is XLA's degree-8 polynomial (``ErfInv32``), ``log1p`` its
# Cephes rational form below sqrt(2) - 1 and ``log(1 + x)`` above, and
# ``log`` the Cephes/Eigen range-reduced polynomial, with the
# multiply-adds XLA:CPU contracts into fused multiply-adds done as one
# rounding (float64 products of float32 values are exact).

_F32 = np.float32


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


_LOG_P = tuple(_F32(p) for p in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))


def xla_log(v) -> np.ndarray:
    """XLA:CPU's float32 ``log``: the mantissa reduced to [sqrt(1/2),
    sqrt(2)) - 1, a degree-8 polynomial in three fused chains, and the
    exponent added back in two parts."""
    v = np.asarray(v, _F32)
    x = np.maximum(v, np.uint32(0x00800000).view(_F32))
    bits = x.view(np.uint32)
    e = ((bits >> np.uint32(23)).astype(np.int32) - 0x7F).astype(_F32) + _F32(1)
    x = ((bits & np.uint32(0x807FFFFF)) | _F32(0.5).view(np.uint32)).view(_F32)
    small = x < _F32(0.707106781186547524)
    tmp = np.where(small, x, _F32(0))
    x = x - _F32(1)
    e = e - np.where(small, _F32(1), _F32(0))
    x = x + tmp
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma(p[0], x, p[1])
    y1 = _fma(p[3], x, p[4])
    y2 = _fma(p[6], x, p[7])
    y = _fma(y, x, p[2])
    y1 = _fma(y1, x, p[5])
    y2 = _fma(y2, x, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _F32(-2.12194440e-4))
    x = x - x2 * _F32(0.5)
    x = x + y
    x = x + e * _F32(0.693359375)
    with np.errstate(invalid="ignore"):
        out = np.where(v < 0, _F32(np.nan), x)
    out = np.where(v == 0, _F32(-np.inf), out)
    return np.where(v == np.inf, _F32(np.inf), out).astype(_F32)


_LOG1P_NUM = (4.5270000862445199635e-5, 4.9854102823193375972e-1,
              6.5787325942061044846e0, 2.9911919328553073277e1,
              6.0949667980987787057e1, 5.7112963590585538103e1,
              2.0039553499201281259e1)
_LOG1P_DEN = (1.0, 1.5062909083469192598e1, 8.3047565967967209469e1,
              2.2176239823732856465e2, 3.0909872225312059774e2,
              2.1642788614495947685e2, 6.0118660497603843919e1)


def _horner(coeffs, x) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _F32(c))
    return p


def xla_log1p(x) -> np.ndarray:
    """XLA's float32 ``log1p``: a Cephes rational approximation where
    |x| < sqrt(2) - 1, ``log(1 + x)`` elsewhere."""
    x = np.asarray(x, _F32)
    xs = x * x
    small = _horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)
    small = x + _fma(_F32(-0.5), xs, (x * xs) * small)
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small,
                    xla_log(x + _F32(1))).astype(_F32)


_ERFINV_LT5 = np.array((2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                        -4.39150654e-06, 0.00021858087, -0.00125372503,
                        -0.00417768164, 0.246640727, 1.50140941), _F32)
_ERFINV_GE5 = np.array((-0.000200214257, 0.000100950558, 0.00134934322,
                        -0.00367342844, 0.00573950773, -0.0076224613,
                        0.00943887047, 1.00167406, 2.83297682), _F32)


def erf_inv(x) -> np.ndarray:
    """XLA's float32 inverse error function (``ErfInv32``): with
    w = -log1p(-x^2), a degree-8 polynomial in w - 2.5 (w < 5) or
    sqrt(w) - 3, times x; +-1 map to +-inf."""
    x = np.asarray(x, _F32)
    w = -xla_log1p(-(x * x))
    lt = w < _F32(5.0)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3.0)).astype(_F32)
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(_F32)
    for i in range(1, 9):
        p = _fma(p, w, np.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i]))
    with np.errstate(invalid="ignore", over="ignore"):
        return np.where(np.abs(x) == 1, x * _F32(np.inf), p * x).astype(_F32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` of one key: the hash of the counter
    pairs (high word, low word) of 0..num-1, both words kept.  Returns
    uint32 [num, 2]."""
    key = np.asarray(key, dtype=np.uint32)
    flat = np.arange(int(num), dtype=np.uint64)
    hi = (flat >> np.uint64(32)).astype(np.uint32)
    lo = (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out0, out1 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([out0, out1], axis=-1)


def _uniform_range(key, shape, lo, hi) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, lo, hi)``:
    max(lo, u * (hi - lo) + lo)."""
    lo, hi = _F32(lo), _F32(hi)
    return np.maximum(lo, uniform(key, shape) * (hi - lo) + lo).astype(_F32)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32: sqrt(2) times the
    inverse error function of a uniform on (-1, 1)."""
    lo = np.nextafter(_F32(-1.0), _F32(0.0), dtype=_F32)
    u = _uniform_range(key, shape, lo, _F32(1.0))
    return (_F32(np.sqrt(2)) * erf_inv(u)).astype(_F32)


def _split_each(keys: np.ndarray, num: int) -> np.ndarray:
    """``split(k, num)`` of each key of ``keys`` [m, 2] -> [m, num, 2]."""
    flat = np.arange(int(num), dtype=np.uint64)
    hi = (flat >> np.uint64(32)).astype(np.uint32)[None, :]
    lo = (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32)[None, :]
    out0, out1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], hi, lo)
    return np.stack([out0, out1], axis=-1)


def _loggamma(keys: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """Log-space Marsaglia-Tsang draws of log Gamma(alpha) for alpha >= 1
    (``_gamma_one`` with ``log_space``), one per key of ``keys`` [m, 2]:
    the same key splits, rejection loops and float32 arithmetic as the
    vmapped JAX sampler, where an element stops changing once its loop
    condition is false, so the elements still looping are advanced
    together."""
    one = _F32(1)
    alpha = np.asarray(alpha, _F32)
    if not (alpha >= one).all():
        raise ValueError("loggamma here takes alpha >= 1 (no boost)")
    d = alpha - _F32(1.0 / 3.0)
    c = _F32(1.0 / 3.0) / np.sqrt(d)
    key = _split_each(keys, 2)[:, 0]
    m = len(alpha)
    X = np.zeros(m, _F32)
    V = np.ones(m, _F32)
    U = np.full(m, 2, _F32)

    def rejected(i):
        return (U[i] >= one - _F32(0.0331) * (X[i] * X[i])) & (
            xla_log(U[i]) >= X[i] * _F32(0.5)
            + d[i] * ((one - V[i]) + xla_log(V[i])))

    todo = np.arange(m)
    while len(todo):
        k3 = _split_each(key[todo], 3)
        key[todo] = k3[:, 0]
        x_key, u_key = k3[:, 1], k3[:, 2]
        x = np.zeros(len(todo), _F32)
        v = np.full(len(todo), -1, _F32)
        again = np.arange(len(todo))
        while len(again):
            k2 = _split_each(x_key[again], 2)
            x_key[again] = k2[:, 0]
            x[again] = normal(k2[:, 1], ())
            v[again] = one + x[again] * c[todo[again]]
            again = again[v[again] <= 0]
        X[todo] = x * x
        V[todo] = (v * v) * v
        U[todo] = uniform(u_key, ())
        todo = todo[rejected(todo)]
    return (xla_log(d) + xla_log(V)).astype(_F32)


def dirichlet(key, alpha, shape) -> np.ndarray:
    """``jax.random.dirichlet(key, alpha, shape)`` in float32 for a
    concentration vector ``alpha`` of entries >= 1: one log-gamma draw per
    element under ``split(key, size)``'s keys in row-major order, then a
    softmax over the last axis (max subtracted, ``exp``, divided by the
    sum).  Returns float32 [*shape, len(alpha)]."""
    alpha = np.asarray(alpha, _F32)
    full = tuple(shape) + alpha.shape[-1:]
    a = np.broadcast_to(alpha, full).ravel()
    logg = _loggamma(split(key, a.size), a).reshape(full)
    z = logg - logg.max(axis=-1, keepdims=True)
    e = np.exp(z).astype(_F32)
    return (e / e.sum(axis=-1, keepdims=True, dtype=_F32)).astype(_F32)
