"""Grouped HyperLogLog: `[groups, m]` int32 registers, Ertl's estimator.

`update` takes the register maximum IN PLACE (`scatter_reduce_` with
"amax"). torch has no count-leading-zeros, so rho comes from the
exponent of `torch.frexp` on a float64 copy of the shifted hash, which is
exact for any value below 2**53.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from deepflow_tpu_torch.utils.u32 import M32, as_u32, mix32


class HLLState(NamedTuple):
    registers: torch.Tensor  # [groups, m] int32


def init(groups: int, precision: int = 12, device="cuda") -> HLLState:
    """precision p: m = 2^p registers per group."""
    if not 4 <= precision <= 16:
        raise ValueError(f"precision {precision} out of range")
    return HLLState(registers=torch.zeros(groups, 1 << precision,
                                          dtype=torch.int32, device=device))


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of u32 values (32 for 0): 32 - bit length, the bit
    length being frexp's exponent."""
    _, exp = torch.frexp(x.to(torch.float64))
    return 32 - exp.to(torch.int64)


def update(state: HLLState, group_ids: torch.Tensor, keys: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> HLLState:
    g, m = state.registers.shape
    p = int(m).bit_length() - 1
    h = mix32(as_u32(keys))
    reg_idx = h >> (32 - p)                      # top p bits
    rest = (h << p) & M32                        # low 32-p bits up top
    rho = torch.clamp(_clz32(rest), max=32 - p) + 1
    gid = torch.clamp(group_ids.to(torch.int64), 0, g - 1)
    if mask is not None:
        # masked lanes write rho=0: a no-op for max (registers >= 0)
        rho = torch.where(mask, rho, torch.zeros_like(rho))
    flat = gid * m + reg_idx
    state.registers.view(-1).scatter_reduce_(
        0, flat, rho.to(torch.int32), reduce="amax", include_self=True)
    return state


def _sigma(x: torch.Tensor, iters: int = 32) -> torch.Tensor:
    y = torch.ones_like(x)
    z = x
    for _ in range(iters):
        x = x * x
        z = z + x * y
        y = y + y
    return z


def _tau(x: torch.Tensor, iters: int = 32) -> torch.Tensor:
    y = torch.ones_like(x)
    z = 1.0 - x
    for _ in range(iters):
        x = torch.sqrt(x)
        y = 0.5 * y
        z = z - torch.square(1.0 - x) * y
    return z / 3.0


def estimate(state: HLLState) -> torch.Tensor:
    """[groups] float32 cardinality estimates (Ertl improved estimator)."""
    g, m = state.registers.shape
    p = int(m).bit_length() - 1
    q = 32 - p
    dev = state.registers.device
    rows = torch.arange(g, device=dev, dtype=torch.int64).repeat_interleave(m)
    flat = rows * (q + 2) + torch.clamp(
        state.registers.reshape(-1).to(torch.int64), 0, q + 1)
    c = torch.zeros(g * (q + 2), dtype=torch.int32, device=dev)
    c.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    c = c.reshape(g, q + 2).to(torch.float32)
    mf = torch.tensor(float(m), dtype=torch.float32, device=dev)
    z = mf * _tau(1.0 - c[:, q + 1] / mf) * (2.0 ** (-q))
    ks = torch.arange(1, q + 1, dtype=torch.float32, device=dev)
    pow2 = torch.exp2(-ks)
    mid = (c[:, 1:q + 1] * pow2[None, :]).sum(dim=1)
    denom = z + mid + mf * _sigma(c[:, 0] / mf)
    alpha_inf = torch.tensor(1.0 / (2.0 * math.log(2.0)), dtype=torch.float32,
                             device=dev)
    est = alpha_inf * mf * mf / denom
    # all-zero sketch (the sigma(1) series saturates) -> exactly 0
    return torch.where(c[:, 0] >= mf, torch.zeros_like(est), est)


def merge(a: HLLState, b: HLLState) -> HLLState:
    return HLLState(registers=torch.maximum(a.registers, b.registers))


def reset(state: HLLState) -> HLLState:
    return HLLState(registers=torch.zeros_like(state.registers))
