"""The threefry2x32 key chain of ``jax.random``, bit for bit, in numpy.

The reference's keyed policy (``random``) and its policy carry draw from
``jax.random`` keys: legacy ``uint32[2]`` keys, the threefry2x32 hash,
with ``jax_threefry_partitionable=True`` (the default of the installed jax
0.9.0) and 64-bit types off.  The port holds scheduler outputs to exact
equality, so it reproduces that chain exactly instead of drawing from
another generator: every function here returns the same ``uint32`` words
as its ``jax.random`` namesake on the same key.

Keys are tiny, so everything is plain ``uint32`` arithmetic on numpy
arrays on the host (additions wrap modulo 2**32).  A key is a ``(..., 2)``
``uint32`` array; the functions that take one key also take a batch of
keys on the leading axes and broadcast over them.

* :func:`threefry_2x32` — the hash (``jax._src.prng._threefry2x32_lowering``,
  20 rounds, five key injections);
* :func:`PRNGKey` — ``threefry_seed``: with 64-bit types off a seed is
  first narrowed to its low 32 bits (``jax.random.PRNGKey`` converts it to
  ``int32``), so the high word is 0;
* :func:`split` — ``_threefry_split_foldlike``: the hash of the 64-bit
  counters ``0 .. n-1`` as (high, low) word pairs;
* :func:`fold_in` — ``threefry_2x32(key, threefry_seed(data))``;
* :func:`random_bits` — ``_threefry_random_bits_partitionable`` at 32 bits:
  the two hashed words of each counter, xor-ed;
* :func:`randint` — ``jax._src.random._randint`` for ``int32``: two bit
  streams from ``split(key)`` folded into the span with wrapping ``uint32``
  products.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np

__all__ = ["threefry_2x32", "PRNGKey", "split", "fold_in", "random_bits", "randint"]

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry_2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of the counter words ``(x1, x2)`` under the
    key words ``(k1, k2)``; all four broadcast together.  Returns the two
    hashed words."""
    k1, k2, x1, x2 = np.broadcast_arrays(*(np.asarray(a, _U32) for a in (k1, k2, x1, x2)))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    with np.errstate(over="ignore"):  # uint32 additions wrap, as in the hash
        a = x1 + ks[0]
        b = x2 + ks[1]
        for step in range(5):
            for r in _ROTATIONS[step % 2]:
                a = a + b
                b = _rotl(b, r)
                b = a ^ b
            a = a + ks[(step + 1) % 3]
            b = b + ks[(step + 2) % 3] + _U32(step + 1)
    return a, b


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as a ``(2,)`` ``uint32`` array."""
    return np.array([0, int(seed) & 0xFFFFFFFF], _U32)


def _iota_2x32(shape: Sequence[int]):
    """The (high, low) ``uint32`` words of ``arange(prod(shape))``, shaped."""
    n = math.prod(shape)
    counts = np.arange(n, dtype=np.uint64).reshape(shape)
    return (counts >> np.uint64(32)).astype(_U32), (counts & np.uint64(0xFFFFFFFF)).astype(_U32)


def _key_words(key, n_axes: int):
    """A key array's two words, with ``n_axes`` axes appended to broadcast
    against a counter array of that rank."""
    key = np.asarray(key, _U32)
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key is a (..., 2) uint32 array, got shape {key.shape}")
    pad = (Ellipsis,) + (None,) * n_axes
    return key[..., 0][pad], key[..., 1][pad]


def split(key, num: Union[int, Sequence[int]] = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``(*key_batch, *num, 2)`` keys."""
    shape = (num,) if isinstance(num, (int, np.integer)) else tuple(num)
    hi, lo = _iota_2x32(shape)
    k1, k2 = _key_words(key, len(shape))
    a, b = threefry_2x32(k1, k2, hi, lo)
    return np.stack([a, b], axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    k1, k2 = _key_words(key, 0)
    a, b = threefry_2x32(k1, k2, _U32(0), _U32(int(data) & 0xFFFFFFFF))
    return np.stack([a, b], axis=-1)


def random_bits(key, shape: Sequence[int]) -> np.ndarray:
    """32 random bits per element of ``shape``, ``(*key_batch, *shape)``
    ``uint32`` (``jax.random.bits`` at 32 bits)."""
    shape = tuple(shape)
    hi, lo = _iota_2x32(shape)
    k1, k2 = _key_words(key, len(shape))
    a, b = threefry_2x32(k1, k2, hi, lo)
    return a ^ b


def randint(key, shape: Sequence[int], minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` (``int32``):
    ``(*key_batch, *shape)``."""
    shape = tuple(shape)
    lo32, hi32 = -(2**31), 2**31 - 1
    minval = min(max(int(minval), lo32), hi32)
    maxval = min(max(int(maxval), lo32), hi32)
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    span = _U32((maxval - minval) & 0xFFFFFFFF) if maxval > minval else _U32(1)
    multiplier = _U32(2**16) % span
    multiplier = _U32((int(multiplier) * int(multiplier)) & 0xFFFFFFFF) % span
    with np.errstate(over="ignore"):
        offset = (higher % span) * multiplier + (lower % span)
    offset = offset % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)
