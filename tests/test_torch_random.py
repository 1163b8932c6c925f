"""The port's threefry2x32 keys against jax.random, bit for bit.

jax 0.9 with ``jax_threefry_partitionable=True``: ``PRNGKey``, ``split`` and
float32 ``uniform`` must give the same words, so the port's RANSAC draws the
same hypotheses as the JAX package from the same key.  Tolerance: none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import asnp, t
from rgbd_visualodometry_tpu_torch import random as vo_random


def test_partitionable_threefry_is_the_reference_mode():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 7, 123456789, 2**31 - 1])
def test_prng_key_matches(seed):
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))).astype(np.int64)
    np.testing.assert_array_equal(asnp(vo_random.PRNGKey(seed)), want)


@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_matches_chain(num):
    jkey = jax.random.PRNGKey(3)
    tkey = vo_random.PRNGKey(3)
    for _ in range(4):  # a chain of splits, as the tracking step threads its key
        jks = jax.random.split(jkey, num)
        tks = vo_random.split(tkey, num)
        np.testing.assert_array_equal(asnp(tks), np.asarray(jax.random.key_data(jks)).astype(np.int64))
        jkey, tkey = jks[0], tks[0]


@pytest.mark.parametrize("shape", [(48, 512), (16, 512), (7,), (3, 5, 4)])
def test_uniform_matches_bit_for_bit(shape):
    rng = np.random.default_rng(sum(shape))
    words = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    jkey = jax.random.wrap_key_data(jnp.asarray(words))
    want = np.asarray(jax.random.uniform(jkey, shape, dtype=jnp.float32))
    got = asnp(vo_random.uniform(t(words.astype(np.int64)), shape))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0


def test_threefry_words_stay_32_bit():
    key = vo_random.PRNGKey(2**31 - 1)
    for _ in range(3):
        key = vo_random.split(key, 2)[1]
        bits = vo_random.random_bits32(key, (1000,))
        assert int(bits.min()) >= 0 and int(bits.max()) <= 0xFFFFFFFF
