"""Count-Min sketch: `[depth, width]` int32 counts, power-of-two width.

`update` and `update_conservative` change `state.counts` IN PLACE and
return a state holding the same tensor (the JAX package donates the old
state instead).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from deepflow_tpu_torch.ops import hashing, mxu_hist
from deepflow_tpu_torch.utils.u32 import as_u32


class CMSState(NamedTuple):
    counts: torch.Tensor  # [depth, width] int32
    seeds: torch.Tensor   # [depth, 2] int32 (u32 bits)


def init(depth: int, log2_width: int, seed: int = 0xDEC0DE,
         device="cuda") -> CMSState:
    if not 1 <= log2_width <= 26:
        raise ValueError(f"log2_width {log2_width} out of range")
    return CMSState(
        counts=torch.zeros(depth, 1 << log2_width, dtype=torch.int32,
                           device=device),
        seeds=hashing.make_seeds(depth, seed, device=device))


def log2_width(state: CMSState) -> int:
    return int(state.counts.shape[1]).bit_length() - 1


def update(state: CMSState, keys: torch.Tensor,
           weights: Optional[torch.Tensor] = None,
           mask: Optional[torch.Tensor] = None,
           weight_planes: int = 2) -> CMSState:
    """Add a batch of (key, weight) into all rows, in place.

    Batches of at least `mxu_hist.MIN_LANES` lanes go through the
    histogram kernel, whose weights saturate at 256**weight_planes - 1;
    smaller ones take an exact scatter-add -- the reference's "auto"
    dispatch, so both packages give the same counts for the same batch."""
    d, w = state.counts.shape
    n = keys.shape[0]
    idx = hashing.multi_bucket(keys, state.seeds, log2_width(state))
    if n >= mxu_hist.MIN_LANES:
        mxu_hist.hist_add_(state.counts, idx, w, weights, mask, weight_planes)
        return state
    if weights is None:
        weights = torch.ones(n, dtype=state.counts.dtype, device=keys.device)
    else:
        weights = weights.to(state.counts.dtype)
    if mask is not None:
        weights = weights * mask.to(state.counts.dtype)
    flat = idx.to(torch.int64) + torch.arange(d, device=keys.device)[:, None] * w
    state.counts.view(-1).index_add_(0, flat.reshape(-1),
                                     weights.expand(d, n).reshape(-1))
    return state


def query(state: CMSState, keys: torch.Tensor) -> torch.Tensor:
    """Point estimate: min over rows of the hashed buckets ([n] int32)."""
    d, w = state.counts.shape
    idx = hashing.multi_bucket(keys, state.seeds, log2_width(state))
    flat = idx.to(torch.int64) + torch.arange(d, device=keys.device)[:, None] * w
    est = state.counts.view(-1)[flat.reshape(-1)].reshape(d, -1)
    return est.min(dim=0).values


def update_conservative(state: CMSState, keys: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        mask: Optional[torch.Tensor] = None) -> CMSState:
    """Conservative update, in place: bucket <- max(bucket, est + w_total)
    for every row, where w_total is a key's summed weight in the batch.

    Keys are sorted (u32 values), duplicate weights are summed onto each
    key's first lane, and one scatter-max per row applies est + w_total.
    A duplicate or masked-out lane carries w_total 0, so its target is
    the key's own estimate: a no-op for max. Bucket indices are in range
    by construction, so the reference's `mode="drop"` drops nothing."""
    d, w = state.counts.shape
    n = keys.shape[0]
    dt = state.counts.dtype
    dev = keys.device
    if weights is None:
        weights = torch.ones(n, dtype=dt, device=dev)
    else:
        weights = weights.to(dt)
    if mask is not None:
        weights = weights * mask.to(dt)
    sk, order = torch.sort(as_u32(keys), stable=True)
    sw = weights[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    totals = torch.zeros(n, dtype=dt, device=dev).index_add_(0, seg, sw)
    w_total = totals[seg] * first.to(dt)
    target = query(state, sk) + w_total
    idx = hashing.multi_bucket(sk, state.seeds, log2_width(state))
    flat = idx.to(torch.int64) + torch.arange(d, device=dev)[:, None] * w
    state.counts.view(-1).scatter_reduce_(
        0, flat.reshape(-1), target.expand(d, n).reshape(-1), reduce="amax")
    return state


def merge(a: CMSState, b: CMSState) -> CMSState:
    """Elementwise add (seeds must match); a new tensor."""
    return a._replace(counts=a.counts + b.counts)


def reset(state: CMSState) -> CMSState:
    return state._replace(counts=torch.zeros_like(state.counts))


def decay(state: CMSState, shift: int = 1) -> CMSState:
    """Counts >> shift (arithmetic, as int32), into a new tensor: cheap
    sliding-window forgetting."""
    return state._replace(counts=state.counts >> shift)
