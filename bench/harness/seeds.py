"""Independent streams drawn from one ``--seed``.

Every input of a run comes from the seed through a stream of its own
(weights, the order of the batch lengths, each batch's token ids, the
sample of the output check), so that one stream's use never shifts
another's.  Seeds of any size are taken (the driver's exceed 32 bits).
"""
from __future__ import annotations

import zlib

import numpy as np

__all__ = ["derive", "numpy_rng"]


def derive(seed: int, stream: str, *index: int) -> int:
    """A 63-bit seed for ``stream`` (and ``index``) of run seed ``seed``."""
    words = [int(seed) % (1 << 64) & 0xFFFFFFFF, int(seed) % (1 << 64) >> 32,
             zlib.crc32(stream.encode()), *[int(i) for i in index]]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def numpy_rng(seed: int, stream: str, *index: int) -> np.random.Generator:
    return np.random.default_rng(derive(seed, stream, *index))
