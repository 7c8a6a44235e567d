"""Multiply-shift hash families on u32 lanes.

Widths are powers of two, so a bucket is the top log2_width bits of
mult * mix32(x ^ salt). Seeds are u32 bits in int32 tensors, [depth, 2]
(multiplier, salt) pairs, as in the JAX package's uint32 layout.
"""

from __future__ import annotations

import torch

from deepflow_tpu_torch.utils.u32 import (as_u32, mix32, mul32,
                                          splitmix32_seeds, to_bits)


def make_seeds(depth: int, seed: int = 0xDEC0DE,
               device="cuda") -> torch.Tensor:
    """[depth, 2] odd (multiplier, xor-salt) pairs as int32 u32 bits."""
    raw = splitmix32_seeds(2 * depth, seed).view("int32").reshape(depth, 2)
    return torch.tensor(raw, dtype=torch.int32, device=device)


def bucket(keys, mult, salt, log2_width: int) -> torch.Tensor:
    """h(x) = top log2_width bits of (mult * mix32(x ^ salt)), int32,
    broadcast over keys/mult/salt like the JAX version."""
    x = mix32(as_u32(keys) ^ as_u32(salt))
    return (mul32(x, as_u32(mult)) >> (32 - log2_width)).to(torch.int32)


def multi_bucket(keys, seeds: torch.Tensor, log2_width: int) -> torch.Tensor:
    """[depth, n] bucket indices, one row per seed pair."""
    mult = as_u32(seeds[:, 0])[:, None]
    salt = as_u32(seeds[:, 1])[:, None]
    x = mix32(as_u32(keys)[None, :] ^ salt)
    return (mul32(x, mult) >> (32 - log2_width)).to(torch.int32)


def fingerprint(keys, salt: int = 0xF1A9E12) -> torch.Tensor:
    """Secondary 32-bit fingerprint, independent of bucket hashes: the
    u32 bits in an int32 tensor (the JAX version's uint32 values)."""
    return to_bits(mix32(as_u32(keys) ^ (salt & 0xFFFFFFFF)))
