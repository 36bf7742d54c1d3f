"""Reading the program's outputs: field elements as 16 little-endian limbs
of 16 bits (int64), points as homogeneous projective (X, Y, Z) triples of
them, x = X / Z and y = Y / Z, infinity where Z = 0."""

from __future__ import annotations

import numpy as np

from . import secp256k1 as E

RADIX = 16
LIMBS = 16


def ints(a) -> list[int]:
    """(..., 16) limbs -> the integers they hold, flattened."""
    a = np.asarray(a, dtype=np.int64).reshape(-1, LIMBS)
    if a.size and (a.min() < 0 or a.max() >= 1 << RADIX):
        return [sum(int(v) << (RADIX * k) for k, v in enumerate(row))
                for row in a]
    raw = a.astype("<u2").tobytes()
    step = 2 * LIMBS
    return [int.from_bytes(raw[i:i + step], "little")
            for i in range(0, len(raw), step)]


def scalars(a) -> list[int]:
    """(..., 16) limbs -> integers mod the group order, flattened."""
    return [v % E.N for v in ints(a)]


def points(a) -> list:
    """(..., 3, 16) projective limbs -> affine points (None: infinity),
    flattened."""
    v = ints(np.asarray(a).reshape(-1, 3, LIMBS))
    return E.batch_affine([(v[i], v[i + 1], v[i + 2])
                           for i in range(0, len(v), 3)])
