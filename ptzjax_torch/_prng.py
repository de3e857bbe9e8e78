"""JAX's default PRNG (threefry2x32), in numpy, for the draws the reference
makes with ``jax.random``: the hypotheses of ``match.ransac_pan_tilt`` come
from ``jax.random.randint(jax.random.PRNGKey(seed), (H,), 0, q)``, and a
port that sampled differently would pick other hypotheses and another
inlier mask.

This follows JAX's ``jax_threefry_partitionable=True`` (the default since
JAX 0.5): ``split`` and the random bits hash a 64-bit iota split into two
uint32 words, and 32-bit draws are the XOR of the two output words.
``randint`` is JAX's ``_randint``: two bit draws from a split key, combined
with the span multiplier 2^32 mod span (uint32 arithmetic, wrapping as
JAX's does). All of it is host arithmetic on uint32 arrays.
"""

from __future__ import annotations

import functools

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under ``key``; uint32 arrays in, uint32 arrays out."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _hash_iota(key: tuple[int, int], n: int) -> tuple[np.ndarray, np.ndarray]:
    """Both output words for the counters 0..n-1 (high words 0)."""
    return threefry2x32(key, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed)."""
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed must be a 32-bit unsigned value, got {seed}")
    return 0, seed


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)``."""
    w0, w1 = _hash_iota(key, num)
    return [(int(a), int(b)) for a, b in zip(w0, w1)]


def random_bits32(key: tuple[int, int], n: int) -> np.ndarray:
    """``jax.random.bits(key, (n,), uint32)``."""
    w0, w1 = _hash_iota(key, n)
    return w0 ^ w1


def randint(key: tuple[int, int], n: int, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, (n,), minval, maxval)`` (int32)."""
    k1, k2 = split(key)
    higher, lower = random_bits32(k1, n), random_bits32(k2, n)
    span = np.uint32(maxval - minval) if maxval > minval else np.uint32(1)
    mult = np.array([2**16], np.uint32) % span
    mult = (mult * mult) % span                          # wraps as JAX's uint32 multiply
    offset = ((higher % span) * mult + lower % span) % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)


@functools.lru_cache(maxsize=64)
def ransac_picks(seed: int, num_hypotheses: int, q: int) -> tuple[int, ...]:
    """The candidate indices ``ransac_pan_tilt`` draws, once per (seed, H,
    q)."""
    return tuple(int(v) for v in randint(prng_key(seed), num_hypotheses, 0, q))
