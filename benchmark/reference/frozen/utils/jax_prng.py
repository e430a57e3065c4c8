"""JAX's default PRNG (threefry2x32, partitionable layout) in numpy.

The JAX package draws the sphere segmenter's RANSAC quadruples with
`jax.random.randint(jax.random.PRNGKey(17), (128, 4), 0, top_n)`.  This
module reproduces that draw bit for bit without importing JAX, so the
port's segmenter picks the same hypotheses.  It follows JAX's
`jax_threefry_partitionable=True` layout (the default since JAX 0.5):
`split` and `random_bits` run threefry over a flat counter iota split
into (hi, lo) 32-bit words.

Every step is uint32 arithmetic with wraparound, as in JAX.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def _rotl(x, d: int):
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds (JAX's `_threefry2x32_lowering`):
    key words k1, k2 (scalars), counter words x1, x2 (arrays) ->
    two uint32 arrays."""
    # one-element arrays: numpy wraps array arithmetic silently
    k1, k2 = np.full(1, k1, _U32), np.full(1, k2, _U32)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    x = [np.asarray(x1, _U32) + ks[0], np.asarray(x2, _U32) + ks[1]]
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], rot)
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int):
    """`jax.random.PRNGKey(seed)` for a non-negative 32-bit seed."""
    return (_U32(0), _U32(seed))


def _iota_2x32(n: int):
    lo = np.arange(n, dtype=np.uint64)
    return (lo >> np.uint64(32)).astype(_U32), lo.astype(_U32)


def split(key, num: int = 2):
    """`jax.random.split(key, num)`: (num, 2) uint32 keys."""
    hi, lo = _iota_2x32(num)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b1, b2], axis=1)


def random_bits(key, shape):
    """32-bit `jax.random.bits(key, shape)`."""
    hi, lo = _iota_2x32(int(np.prod(shape)))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def randint(seed: int, shape, lo: int, hi: int):
    """`jax.random.randint(PRNGKey(seed), shape, lo, hi)` as int32.

    Higher bits come from the first split key and lower bits from the
    second; the multiplier (2**16 % span)**2 % span is squared in uint32,
    so it wraps when span exceeds 65536, exactly as in JAX.
    """
    k1, k2 = split(prng_key(seed))
    higher = random_bits(k1, shape)
    lower = random_bits(k2, shape)
    span = np.full(1, max(hi - lo, 1), _U32)
    mult = np.full(1, 2**16, _U32) % span
    mult = (mult * mult) % span
    off = (higher % span) * mult + (lower % span)
    off = off % span
    return (np.int64(lo) + off.astype(np.int64)).astype(np.int32)
