"""The port's threefry draws (utils/prng.py) against ``jax.random``:
keys, fold-in, split, bits, uniform, bernoulli and permutation, bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from go_crdt_playground_tpu_torch.utils import prng

# 0, small, the largest int32, the largest uint32 and two seeds past
# 2^32 (the gossip verbs take any int; 32-bit JAX keeps the low word)
SEEDS = (0, 3, 17, 2**31 - 1, 2**32 - 1, 2**32 + 5, 2**40 + 7)
SIZES = (1, 3, 64, 1000)


def _data(k):
    return np.asarray(jax.random.key_data(k), np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches(seed):
    assert np.array_equal(prng.key(seed), _data(jax.random.key(seed)))


@pytest.mark.parametrize("data", [0, 1, 2, 41, 2**31 - 1, 2**31, 2**32 - 1])
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_fold_in_matches(seed, data):
    want = jax.random.fold_in(jax.random.key(seed), np.uint32(data))
    assert np.array_equal(prng.fold_in(prng.key(seed), data), _data(want))


@pytest.mark.parametrize("num", [1, 2, 3, 7])
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_split_matches(seed, num):
    want = jax.random.split(jax.random.key(seed), num)
    assert np.array_equal(prng.split(prng.key(seed), num), _data(want))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform_match(seed, n):
    k = jax.random.fold_in(jax.random.key(seed), 9)
    pk = prng.fold_in(prng.key(seed), 9)
    want = np.asarray(jax.random.bits(k, (n,), jnp.uint32))
    assert np.array_equal(prng.random_bits(pk, n), want)
    want = np.asarray(jax.random.uniform(k, (n,)))
    got = prng.uniform(pk, n)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("rate", [0.0, 0.2, 0.3, 0.4, 1.0])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bernoulli_matches(seed, n, rate):
    """As the gossip loop draws its drop masks: p as float32."""
    k = jax.random.fold_in(jax.random.key(seed), 2 * 5 + 1)
    want = np.asarray(jax.random.bernoulli(k, jnp.float32(rate), (n,)))
    got = prng.bernoulli(prng.fold_in(prng.key(seed), 2 * 5 + 1), rate, n)
    assert got.dtype == np.bool_
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", SIZES + (2, 4097))
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_permutation_matches(seed, n):
    k = jax.random.fold_in(jax.random.key(seed), 2 * 3)
    want = np.asarray(jax.random.permutation(k, n))
    got = prng.permutation(prng.fold_in(prng.key(seed), 2 * 3), n)
    assert np.array_equal(got, want)
    assert np.array_equal(np.sort(got), np.arange(n))


def test_permutation_at_2_20_takes_two_sort_rounds():
    n = 1 << 20
    assert prng.shuffle_rounds(n) == 2
    assert [prng.shuffle_rounds(m) for m in (0, 1, 2, 64, 1000)] == \
        [0, 0, 1, 1, 1]
    k = jax.random.key(7)
    want = np.asarray(jax.random.permutation(k, n))
    assert np.array_equal(prng.permutation(prng.key(7), n), want)
