"""Threefry-2x32 keys and draws, bit for bit those of ``jax.random``.

The seeded randomness of the gossip schedules (drop masks, random
pairings) is drawn here on the host, so a seed gives the JAX package's
rounds.  This is the port's own numpy copy of what those draws need from
JAX's default PRNG (threefry2x32 with ``jax_threefry_partitionable``
on, JAX's default since 0.5, and 32-bit mode):

  * ``key(seed)``          ``jax.random.key``: the key (0, seed mod 2^32);
  * ``fold_in(key, data)`` threefry of the count pair (0, data);
  * ``split(key, num)``    key i is threefry of the count pair (0, i);
  * ``random_bits``        32-bit draw i is x0 ^ x1 of threefry (hi(i), lo(i));
  * ``uniform``            float32 in [0, 1): the 23 high bits as mantissa;
  * ``bernoulli``          ``uniform < p`` with p as float32;
  * ``permutation``        the sort-based shuffle: ceil(3 ln n /
                           ln(2^32 - 1)) rounds of (split, random_bits,
                           stable sort on the 32-bit draws).

A key is a numpy uint32 array of shape (2,).
"""

from __future__ import annotations

import math

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _u32(x) -> np.ndarray:
    return np.asarray(x, dtype=_U32)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) of the count pairs
    (x1, x2) under the key (k1, k2); all uint32, broadcast together.
    Returns the output pair."""
    k1, k2 = _u32(k1), _u32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _U32(_PARITY))
    x0 = _u32(x1) + ks[0]
    y = _u32(x2) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + y
            y = _rotl(y, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        y = y + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, y


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)`` in 32-bit mode: (0, seed mod 2^32)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=_U32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: a new key from ``k`` and a uint32 datum."""
    x0, x1 = threefry2x32(k[0], k[1], _u32([0]), _u32([int(data) & 0xFFFFFFFF]))
    return np.concatenate([x0, x1])


def _counts(n: int):
    """The 64-bit iota 0..n-1 as (hi, lo) uint32 halves."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(_U32), i.astype(_U32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: ``num`` keys, uint32[num, 2]."""
    hi, lo = _counts(num)
    x0, x1 = threefry2x32(k[0], k[1], hi, lo)
    return np.stack([x0, x1], axis=1)


def random_bits(k: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.bits(k, (n,), uint32)``: n uint32 draws."""
    hi, lo = _counts(n)
    x0, x1 = threefry2x32(k[0], k[1], hi, lo)
    return x0 ^ x1


def uniform(k: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.uniform(k, (n,))``: float32 in [0, 1)."""
    bits = (random_bits(k, n) >> _U32(9)) | _U32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def bernoulli(k: np.ndarray, p: float, n: int) -> np.ndarray:
    """``jax.random.bernoulli(k, jnp.float32(p), (n,))``: bool[n]."""
    return uniform(k, n) < np.float32(p)


def shuffle_rounds(n: int) -> int:
    """Sort rounds of ``jax.random.permutation`` for n items."""
    return int(math.ceil(3 * math.log(max(1, n))
                         / math.log(0xFFFFFFFF)))


def permutation(k: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(k, n)``: a permutation of range(n) as
    int64[n]."""
    x = np.arange(n, dtype=np.int64)
    for _ in range(shuffle_rounds(n)):
        k, sub = split(k)
        x = x[np.argsort(random_bits(sub, n), kind="stable")]
    return x
