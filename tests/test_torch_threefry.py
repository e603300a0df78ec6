"""Port parity: the port's copy of JAX's default PRNG (threefry2x32,
partitionable) against ``jax.random`` on the CPU.

Keys, folds, splits, ``bits`` and ``uniform`` must be bit-equal; ``normal``
evaluates XLA's float32 ``erf_inv`` one rounded operation at a time and
must land within 4 ulp of JAX's draw (XLA contracts some multiply-adds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graphmine_tpu_torch.ops import _threefry as tf
from _torch_threads import one_torch_thread  # noqa: F401

SEEDS = [0, 1, 42, -1, 2**31 - 1, 123456789]
SHAPES = [(1,), (7,), (1000,), (65537,), (33, 9)]
NORMAL_MAX_ULP = 4


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _ulp(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_folds_and_splits_are_bit_equal(seed):
    key = tf.PRNGKey(seed)
    assert key.dtype == np.uint32
    assert np.array_equal(np.asarray(_jkey(seed)), key)
    for data in (0, 3, 7, 2**31, 2**32 - 1):
        assert np.array_equal(np.asarray(jax.random.fold_in(_jkey(seed), data)),
                              tf.fold_in(key, data))
    for num in (2, 3, 5, 8):
        assert np.array_equal(np.asarray(jax.random.split(_jkey(seed), num)),
                              tf.split(key, num))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_are_bit_equal(seed, shape):
    key = tf.PRNGKey(seed)
    jb = np.asarray(jax.random.bits(_jkey(seed), shape, jnp.uint32)).astype(np.int64)
    got = tf.bits(key, shape)
    assert tuple(got.shape) == shape
    assert np.array_equal(jb, got.numpy())
    ju = np.asarray(jax.random.uniform(_jkey(seed), shape, jnp.float32))
    assert np.array_equal(ju.view(np.int32), tf.uniform(key, shape).numpy().view(np.int32))
    ju = np.asarray(jax.random.uniform(_jkey(seed), shape, jnp.float32, -2.5, 3.0))
    assert np.array_equal(ju.view(np.int32),
                          tf.uniform(key, shape, minval=-2.5, maxval=3.0).numpy().view(np.int32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_four_ulp(seed, shape):
    jn = np.asarray(jax.random.normal(_jkey(seed), shape, jnp.float32))
    pn = tf.normal(tf.PRNGKey(seed), shape).numpy()
    assert pn.shape == shape and pn.dtype == np.float32
    assert _ulp(jn, pn).max() <= NORMAL_MAX_ULP


def test_folded_and_split_keys_draw_like_jax():
    # the chains MIS, colouring and SVD++ use: fold_in(fold_in(key, c), it)
    # and split(key, 3)
    jk = jax.random.fold_in(jax.random.fold_in(_jkey(0), 5), 11)
    k = tf.fold_in(tf.fold_in(tf.PRNGKey(0), 5), 11)
    assert np.array_equal(np.asarray(jax.random.bits(jk, (70_001,), jnp.uint32)),
                          tf.bits(k, (70_001,)).numpy())
    for jsub, sub in zip(jax.random.split(_jkey(3), 3), tf.split(tf.PRNGKey(3), 3)):
        jn = np.asarray(jax.random.normal(jsub, (50, 10), jnp.float32))
        assert _ulp(jn, tf.normal(sub, (50, 10)).numpy()).max() <= NORMAL_MAX_ULP


def test_bad_key_shape_raises():
    with pytest.raises(TypeError, match="shape"):
        tf.bits(np.zeros(3, np.uint32), (4,))
