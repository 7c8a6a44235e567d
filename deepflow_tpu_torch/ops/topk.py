"""Heavy-hitter top-K over a CMS-estimated candidate ring.

Ring keys are u32 bits in an int32 tensor (SENTINEL = 0xFFFFFFFF, i.e.
-1, marks an empty slot); counts are int32 CMS estimates. The order of
every step matches the JAX package bit for bit:

- `lax.sort(num_keys=2)` sorts (uint32 key, int32 count) pairs
  lexicographically; torch cannot sort uint32, so one int64 composite
  ((key - 2^31) << 32) + (count + 2^31) is sorted instead;
- `lax.top_k` puts the lower index first among equal counts, which a
  stable descending sort reproduces (`torch.topk` promises no order);
- the stride sample of a batch is an index gather whose phase stays on
  the device (no `.item()` per batch).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from deepflow_tpu_torch.ops import cms
from deepflow_tpu_torch.utils.u32 import M32, as_u32, to_bits

SENTINEL = M32
_SENTINEL_BITS = -1


class TopKState(NamedTuple):
    keys: torch.Tensor    # [ring] int32 u32 bits, SENTINEL = empty
    counts: torch.Tensor  # [ring] int32 CMS estimates


def init(ring_size: int, device="cuda") -> TopKState:
    return TopKState(
        keys=torch.full((ring_size,), _SENTINEL_BITS, dtype=torch.int32,
                        device=device),
        counts=torch.full((ring_size,), -1, dtype=torch.int32, device=device))


def candidate_keys(state_keys: torch.Tensor, batch_keys: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, sample_log2: int = 0,
                   phase=0) -> torch.Tensor:
    """Standing ring keys + the (stride-sampled) batch keys, as u32
    values. Masked-out lanes become SENTINEL."""
    bk = as_u32(batch_keys)
    if mask is not None:
        bk = torch.where(mask, bk, torch.full_like(bk, SENTINEL))
    if sample_log2 > 0:
        n = bk.shape[0]
        step = 1 << sample_log2
        shift = torch.as_tensor(phase, device=bk.device).to(torch.int64) % step
        take = (torch.arange(0, n, step, device=bk.device) + shift) % n
        bk = bk[take]
    return torch.cat([as_u32(state_keys), bk])


def blend_counts(all_keys: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    """est where the key is live, -1 at sentinels."""
    return torch.where(all_keys != SENTINEL, est.to(torch.int32),
                       torch.full_like(est, -1, dtype=torch.int32))


def sort_pairs(all_keys: torch.Tensor, all_counts: torch.Tensor):
    """Lexicographic sort of (u32 key, int32 count) pairs, ascending.
    Returns (u32 values, int32 counts)."""
    comp = ((as_u32(all_keys) - (1 << 31)) << 32) \
        + (all_counts.to(torch.int64) + (1 << 31))
    comp = torch.sort(comp).values
    keys = (comp >> 32) + (1 << 31)
    counts = ((comp & M32) - (1 << 31)).to(torch.int32)
    return keys, counts


def _dedup_sorted(k: torch.Tensor, c: torch.Tensor):
    """Dedup sorted pairs: the last lane of each equal-key run holds its
    max count and is kept; the other lanes become (SENTINEL, -1)."""
    last = torch.ones_like(k, dtype=torch.bool)
    last[:-1] = k[1:] != k[:-1]
    keep = last & (k != SENTINEL)
    k = torch.where(last, k, torch.full_like(k, SENTINEL))
    c = torch.where(keep, c, torch.full_like(c, -1))
    return k, c


def _not_sentinel(keys: torch.Tensor) -> torch.Tensor:
    """[n] int32 1 where the key (u32 bits or values) is live, 0 at
    SENTINEL."""
    return (as_u32(keys) != SENTINEL).to(torch.int32)


def _stable_top(c: torch.Tensor, k: int):
    """lax.top_k: the k largest, descending, lower index first on ties."""
    order = torch.sort(c, descending=True, stable=True).indices[:k]
    return c[order], order


def select_ring(k: torch.Tensor, c: torch.Tensor, ring_size: int) -> TopKState:
    """Dedup the sorted pairs, then keep the ring_size best."""
    k2, c2 = _dedup_sorted(k, c)
    top_c, top_i = _stable_top(c2, ring_size)
    return TopKState(keys=to_bits(k2[top_i]), counts=top_c)


def offer(state: TopKState, batch_keys: torch.Tensor, sketch: cms.CMSState,
          mask: Optional[torch.Tensor] = None, sample_log2: int = 0,
          phase=0) -> TopKState:
    """Merge a batch of keys (scored via `sketch`) into the candidate
    ring; standing candidates are rescored in the same query."""
    all_keys = candidate_keys(state.keys, batch_keys, mask, sample_log2,
                              phase)
    est = cms.query(sketch, all_keys)
    k, c = sort_pairs(all_keys, blend_counts(all_keys, est))
    return select_ring(k, c, state.keys.shape[0])


def result(state: TopKState, k: int):
    """(keys, counts) of the current top-k, count-descending."""
    top_c, top_i = _stable_top(state.counts, k)
    return state.keys[top_i], top_c


def reset(state: TopKState) -> TopKState:
    return init(state.keys.shape[0], device=state.keys.device)
