"""Windowed traffic-entropy histograms: `[features, buckets]` int32.

`update` adds IN PLACE into `state.hist`. Per-record weights saturate at
256**weight_planes - 1 on both the histogram-kernel and the scatter
path, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from deepflow_tpu_torch.ops import hashing, mxu_hist


class EntropyState(NamedTuple):
    hist: torch.Tensor   # [features, buckets] int32
    seeds: torch.Tensor  # [features, 2] int32 (u32 bits)


def init(features: int, log2_buckets: int = 12, seed: int = 0xE27B0,
         device="cuda") -> EntropyState:
    return EntropyState(
        hist=torch.zeros(features, 1 << log2_buckets, dtype=torch.int32,
                         device=device),
        seeds=hashing.make_seeds(features, seed, device=device))


def update(state: EntropyState, feature_cols: torch.Tensor,
           weights: Optional[torch.Tensor] = None,
           mask: Optional[torch.Tensor] = None,
           weight_planes: int = 2) -> EntropyState:
    """feature_cols: [features, n] integer columns, one row per feature.
    Batches of at least `mxu_hist.MIN_LANES` lanes go through the
    histogram kernel, smaller ones a scatter-add (the reference's
    "auto" dispatch)."""
    f, b = state.hist.shape
    lb = int(b).bit_length() - 1
    n = feature_cols.shape[1]
    idx = hashing.bucket(feature_cols, state.seeds[:, 0:1],
                         state.seeds[:, 1:2], lb)
    if n >= mxu_hist.MIN_LANES:
        mxu_hist.hist_add_(state.hist, idx, b, weights, mask, weight_planes)
        return state
    dev = feature_cols.device
    if weights is None:
        weights = torch.ones(n, dtype=state.hist.dtype, device=dev)
    else:
        weights = torch.clamp(weights.to(state.hist.dtype),
                              max=256 ** weight_planes - 1)
    if mask is not None:
        weights = weights * mask.to(state.hist.dtype)
    flat = idx.to(torch.int64) + torch.arange(f, device=dev)[:, None] * b
    state.hist.view(-1).index_add_(0, flat.reshape(-1),
                                   weights.expand(f, n).reshape(-1))
    return state


def entropies(state: EntropyState) -> torch.Tensor:
    """[features] normalized Shannon entropy in [0, 1] (float32); an
    empty feature row gives 0."""
    h = state.hist.to(torch.float32)
    total = h.sum(dim=1, keepdim=True)
    p = h / torch.clamp(total, min=1.0)
    xlogx = torch.where(p > 0, p * torch.log(p), torch.zeros_like(p))
    ent = -xlogx.sum(dim=1)
    norm = torch.log(torch.tensor(float(state.hist.shape[1]),
                                  dtype=torch.float32, device=h.device))
    return torch.where(total[:, 0] > 0, ent / norm, torch.zeros_like(ent))


def merge(a: EntropyState, b: EntropyState) -> EntropyState:
    return a._replace(hist=a.hist + b.hist)


def reset(state: EntropyState) -> EntropyState:
    return state._replace(hist=torch.zeros_like(state.hist))
