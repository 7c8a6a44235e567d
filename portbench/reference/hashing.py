"""Frozen numpy copies of the sketch hash arithmetic.

The benchmark's references compute every sketch cell again from the raw
records, so they need the same hash functions as the program: the
murmur3 finalizer, the five-column fold of a flow key, splitmix32 seeds
and the multiply-shift bucket. These are copies, written down once from
the published definitions (murmur3 fmix32, splitmix32) and the fold the
program documents; nothing here imports the program. All arithmetic is
uint32 and wraps.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

U32 = np.uint32
GOLDEN = 0x9E3779B9
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35


def as_u32(x) -> np.ndarray:
    """Any integer array as uint32 bits (int32 keeps its bit pattern,
    wider types wrap modulo 2**32)."""
    x = np.asarray(x)
    if x.dtype == np.uint32:
        return x
    if x.dtype == np.int32:
        return x.view(np.uint32)
    return x.astype(np.uint64).astype(np.uint32)


def mix32(x: np.ndarray) -> np.ndarray:
    """murmur3 fmix32 over uint32 values."""
    x = as_u32(x)
    with np.errstate(over="ignore"):
        x = x ^ (x >> U32(16))
        x = x * U32(_C1)
        x = x ^ (x >> U32(13))
        x = x * U32(_C2)
        return x ^ (x >> U32(16))


def fold(cols: Sequence[np.ndarray]) -> np.ndarray:
    """h = mix32(h ^ (c + GOLDEN + h<<6 + h>>2)) over the columns in
    order, h starting at GOLDEN: the flow key of a 5-tuple, the service
    key of (ip, port, proto)."""
    cols = [as_u32(c) for c in cols]
    h = np.full(cols[0].shape, GOLDEN, U32)
    with np.errstate(over="ignore"):
        for c in cols:
            h = mix32(h ^ (c + U32(GOLDEN) + (h << U32(6)) + (h >> U32(2))))
    return h


def splitmix32(n: int, seed: int) -> np.ndarray:
    """n odd uint32 salts from splitmix32 seeded with `seed`."""
    out = np.empty(n, U32)
    x = int(seed) & 0xFFFFFFFF
    for i in range(n):
        x = (x + GOLDEN) & 0xFFFFFFFF
        z = x
        z = ((z ^ (z >> 16)) * 0x21F0AAAD) & 0xFFFFFFFF
        z = ((z ^ (z >> 15)) * 0x735A2D97) & 0xFFFFFFFF
        z = z ^ (z >> 15)
        out[i] = z | 1
    return out


def seed_pairs(depth: int, seed: int) -> np.ndarray:
    """[depth, 2] uint32 (multiplier, xor-salt) pairs of a hash family."""
    return splitmix32(2 * depth, seed).reshape(depth, 2)


def bucket(keys: np.ndarray, mult: int, salt: int, log2_width: int
           ) -> np.ndarray:
    """Top log2_width bits of mult * mix32(key ^ salt), as int64."""
    x = mix32(as_u32(keys) ^ U32(salt))
    with np.errstate(over="ignore"):
        return ((x * U32(mult)) >> U32(32 - log2_width)).astype(np.int64)


def clz32(x: np.ndarray) -> np.ndarray:
    """Leading zeros of uint32 values (32 for 0), as int64: 32 minus
    the bit length, which float64's exponent gives exactly below 2**53."""
    _, exp = np.frexp(as_u32(x).astype(np.float64))
    return 32 - exp.astype(np.int64)
