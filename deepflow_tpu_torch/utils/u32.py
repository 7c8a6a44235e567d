"""32-bit lane arithmetic on torch tensors.

Every hash of the sketch step is uint32 wrap-around arithmetic. torch's
uint32 dtype lacks `+`, `>>`, `<<` and `scatter_add` on the CPU, and a
uint32 product overflows int64, so this module works on a different
representation:

- a *u32 value* is an int64 tensor holding a number in [0, 2**32);
- *u32 bits* are an int32 tensor holding the same 32 bits. That is the
  layout of every uint32 leaf of the sketch state and of the planes the
  CUDA kernels read.

`as_u32` turns any integer tensor into u32 values, `to_bits` turns u32
values back into bits. Products are split into 16-bit halves (`mul32`)
so that no intermediate leaves int64's range; shifts of u32 values are
logical because the values are non-negative.

The numpy functions at the end are the host copies the packers and the
tests need (`fold_columns_np` must stay bit-identical to `fold_columns`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from deepflow_tpu_torch.utils.twinmark import host_twin_of

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_U32 = np.uint32


def as_u32(x) -> torch.Tensor:
    """Any integer tensor (or Python int) -> int64 u32 values.

    int32 input keeps its bit pattern (a negative id such as l3_epc_id
    maps to its two's complement), wider input wraps modulo 2**32."""
    if not isinstance(x, torch.Tensor):
        return torch.as_tensor(int(x) & M32, dtype=torch.int64)
    if x.dtype == torch.uint32:
        x = x.to(torch.int64)
    return x.to(torch.int64) & M32


def to_bits(x: torch.Tensor) -> torch.Tensor:
    """u32 values (int64 in [0, 2**32)) -> int32 tensor of the same bits."""
    x = x.to(torch.int64) & M32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for u32 values, without leaving int64.

    a*b = a_lo*b + a_hi*b*2**16; only the low 16 bits of a_hi*b survive
    the shift, so each partial product stays below 2**48."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & M32


def mix32(x) -> torch.Tensor:
    """murmur3 fmix32 finalizer over u32 values (any integer input)."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = mul32(x, _C1)
    x = x ^ (x >> 13)
    x = mul32(x, _C2)
    return x ^ (x >> 16)


def fold_columns(cols: Sequence) -> torch.Tensor:
    """Fold N integer columns into one well-mixed u32 key:
    h = mix32(h ^ (c + GOLDEN + h<<6 + h>>2)), h starting at GOLDEN."""
    cols = [as_u32(c) for c in cols]
    h = torch.full_like(cols[0], GOLDEN)
    for c in cols:
        h = mix32(h ^ ((c + GOLDEN + ((h << 6) & M32) + (h >> 2)) & M32))
    return h


# -- host (numpy) copies ------------------------------------------------------


def _as_u32_np(x) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype == np.uint32:
        return x
    if x.dtype == np.int32:
        return x.view(np.uint32)
    return x.astype(np.uint32)


@host_twin_of("deepflow_tpu_torch/utils/u32.py:mix32")
def _mix32_np(x: np.ndarray) -> np.ndarray:
    """numpy mix32, op for op."""
    x = x ^ (x >> _U32(16))
    x = x * _U32(_C1)
    x = x ^ (x >> _U32(13))
    x = x * _U32(_C2)
    return x ^ (x >> _U32(16))


@host_twin_of("deepflow_tpu_torch/utils/u32.py:fold_columns")
def fold_columns_np(cols) -> np.ndarray:
    """numpy fold_columns, bit-identical to the torch one: host code
    resolves device flow keys back to the tuples that made them."""
    cols = [_as_u32_np(c) for c in cols]
    with np.errstate(over="ignore"):
        h = np.full_like(cols[0], _U32(GOLDEN))
        for c in cols:
            h = _mix32_np(h ^ (c + _U32(GOLDEN) + (h << _U32(6))
                               + (h >> _U32(2))))
    return h


def splitmix32_seeds(n: int, seed: int = 0x5DEECE66) -> np.ndarray:
    """Deterministic odd uint32 salts (splitmix32) for hash rows."""
    out = np.empty(n, dtype=np.uint32)
    x = np.uint32(seed)
    with np.errstate(over="ignore"):
        for i in range(n):
            x = _U32(x + _U32(GOLDEN))
            z = x
            z = _U32((z ^ (z >> 16)) * _U32(0x21F0AAAD))
            z = _U32((z ^ (z >> 15)) * _U32(0x735A2D97))
            z = z ^ (z >> 15)
            out[i] = z | _U32(1)  # force odd
    return out
