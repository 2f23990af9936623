"""utils/threefry.py of the torch package against jax.random.

Bit-equal: ``prng_key`` to ``jax.random.PRNGKey`` of int32 seeds (and to
``jax.vmap(jax.random.PRNGKey)`` of a seed array, as the JAX package's
forests build their keys), ``fold_in`` at tree levels 0-12, and
``bernoulli`` to ``jax.random.bernoulli(key, float32(p), (2^l, d))``, the
per-node feature-subset masks of the JAX package's ``fit_tree``.  The
reference runs JAX's default key implementation with
``jax_threefry_partitionable`` on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import PORT, mod

SEEDS = [0, 1, 12345, 2**31 - 2]


def _tf():
    return mod(PORT, "utils.threefry")


def test_reference_uses_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_bit_equal(seed):
    np.testing.assert_array_equal(_tf().prng_key(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


def test_prng_key_of_seed_array_bit_equal():
    """The JAX package's forests: ``vmap(PRNGKey)`` over the seed_ints that
    ``RandomState.randint(0, 2**31 - 1, size=T)`` draws."""
    seed_ints = np.random.RandomState(42).randint(0, 2**31 - 1, size=50)
    want = np.asarray(jax.vmap(jax.random.PRNGKey)(jnp.asarray(seed_ints)))
    got = _tf().prng_key(seed_ints)
    assert got.dtype == np.uint32 and got.shape == (50, 2)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        _tf().prng_key(-1)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bit_equal(seed):
    key = jax.random.PRNGKey(seed)
    got = _tf().fold_in(_tf().prng_key(seed), np.arange(13))
    for level in range(13):
        np.testing.assert_array_equal(
            got[level], np.asarray(jax.random.fold_in(key, level)))


@pytest.mark.parametrize("d", [4, 9, 39])
@pytest.mark.parametrize("p", ["sqrt", "onethird"])
def test_bernoulli_masks_bit_equal(d, p):
    """Every level's (2^l, d) mask of every seed, as ``fit_tree`` draws it."""
    pf = np.float32(np.sqrt(d) / d if p == "sqrt" else 1.0 / 3.0)
    tf = _tf()
    max_level = 12 if d < 39 else 9
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        keys = tf.fold_in(tf.prng_key(seed), np.arange(max_level + 1))
        for level in range(max_level + 1):
            shape = (2**level, d)
            want = np.asarray(jax.random.bernoulli(
                jax.random.fold_in(key, level), jnp.float32(pf), shape))
            got = tf.bernoulli(keys[level], pf, shape)
            assert got.dtype == bool and got.shape == shape
            np.testing.assert_array_equal(got, want)


def test_bernoulli_broadcasts_over_keys():
    """A batch of keys gives each key's own mask: [T, L, d]."""
    tf = _tf()
    seed_ints = np.array([3, 99, 2**31 - 2])
    keys = tf.fold_in(tf.prng_key(seed_ints), 5)
    got = tf.bernoulli(keys, np.float32(1 / 3), (32, 9))
    assert got.shape == (3, 32, 9)
    for t, s in enumerate(seed_ints):
        want = np.asarray(jax.random.bernoulli(
            jax.random.fold_in(jax.random.PRNGKey(int(s)), 5),
            jnp.float32(1 / 3), (32, 9)))
        np.testing.assert_array_equal(got[t], want)


def test_uniform_bit_equal():
    key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    want = np.asarray(jax.random.uniform(key, (5, 11), jnp.float32))
    got = _tf().uniform(np.asarray(key), (5, 11))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
