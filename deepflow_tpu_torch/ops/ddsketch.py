"""DDSketch-style quantile sketch: log-bucket histograms, mergeable.

Values land in geometrically spaced buckets (gamma = (1+alpha)/(1-alpha)):
bucket i of a group covers (min*g^(i-1), min*g^i], so any quantile reads
back with relative error alpha, and sketches merge by elementwise add.
The state is [groups, buckets]: the bucket index folds (group, bucket)
into one flat histogram axis, and a batch of every group is one launch of
the hist kernel (`mxu_hist.hist_add_`) added into the state in place.

Bucket boundaries. The reference computes `ceil(log(v/min) / log(g))` in
float32, and every implementation of `log` (XLA's, ATen's, CUDA's
`logf`) rounds differently next to a boundary. This port reads the
bucket from a table of the `buckets-1` boundaries `min*g^i`, built in
float64 on the host, as `searchsorted(boundaries, float64(max(v, min)))`:
the exact ceil of the float64 logarithm, with no transcendental, and the
same bucket on the card and on the CPU. It differs from the reference
only for values within ~1e-4 of a boundary in log_g units (one bucket
apart). `quantile`'s estimate (the bucket's midpoint in log space) reads
a table built on the host the same way, from the reference's float32
arithmetic with `g**i` taken in float64: within one float32 ulp of the
reference's estimate, where the exact midpoint would be up to ~3e-5
away (the reference rounds g to float32 before the power).

The state is int32 counts (the reference's is float32): exact at every
count, and equal to the reference's while a cell stays below 2^24.
`quantile` and `counts` read it as float32, as the reference does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from deepflow_tpu_torch.ops import mxu_hist
from deepflow_tpu_torch.utils.u32 import as_u32


class DDSketchConfig(NamedTuple):
    """Range: max = min_value * gamma**(buckets-1); at alpha=0.02
    (gamma ~1.041) 512 buckets reach ~5e8 us."""

    groups: int = 1024          # hashed service space
    buckets: int = 512
    alpha: float = 0.02         # relative accuracy target
    min_value: float = 1.0      # values below land in `zeros` (us scale)


class DDSketchState(NamedTuple):
    hist: torch.Tensor          # [groups, buckets] int32 counts
    zeros: torch.Tensor         # [groups] int32 count of values < min_value


class _Tables(NamedTuple):
    bounds: torch.Tensor        # [buckets-1] float64 min*g^i
    mids: torch.Tensor          # [buckets] float32 min*2g^i/(g+1)


def gamma(cfg: DDSketchConfig) -> float:
    return (1.0 + cfg.alpha) / (1.0 - cfg.alpha)


def boundaries(cfg: DDSketchConfig) -> np.ndarray:
    """[buckets-1] float64 upper edges min*g^i of buckets 0..buckets-2."""
    return cfg.min_value * gamma(cfg) ** np.arange(cfg.buckets - 1,
                                                   dtype=np.float64)


def midpoints(cfg: DDSketchConfig) -> np.ndarray:
    """[buckets] float32 estimate of each bucket: min*2g^i/(g+1), the
    midpoint of (min*g^(i-1), min*g^i] in log space, in the reference's
    float32 operations (g rounded to float32, the power in float64)."""
    g = gamma(cfg)
    g32 = np.float64(np.float32(g))
    p = (g32 ** np.arange(cfg.buckets, dtype=np.float64)).astype(np.float32)
    return np.float32(cfg.min_value) * (np.float32(2.0) * p) \
        / np.float32(g + 1.0)


@functools.lru_cache(maxsize=32)
def _tables(cfg: DDSketchConfig, device: torch.device) -> _Tables:
    """The config's tables on `device`, built once and only read after.
    On the card the upload is waited for here, so that every stream may
    read them at once."""
    t = _Tables(torch.from_numpy(boundaries(cfg)).to(device),
                torch.from_numpy(midpoints(cfg)).to(device))
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return t


def init(cfg: DDSketchConfig, device="cuda") -> DDSketchState:
    """A zero state; also uploads the config's tables to its device."""
    state = DDSketchState(
        hist=torch.zeros(cfg.groups, cfg.buckets, dtype=torch.int32,
                         device=device),
        zeros=torch.zeros(cfg.groups, dtype=torch.int32, device=device))
    _tables(cfg, state.hist.device)
    return state


def _as_f32(values: torch.Tensor) -> torch.Tensor:
    """The reference's `values.astype(float32)`: floats as they are,
    integers as u32 (an int32 tensor holds u32 bits, as every uint32
    column of the port does), rounded to nearest."""
    if values.is_floating_point():
        return values.to(torch.float32)
    return as_u32(values).to(torch.float32)


def _bucket_f32(v: torch.Tensor, cfg: DDSketchConfig) -> torch.Tensor:
    """[n] float32 values -> [n] int32 bucket in [0, buckets)."""
    v = torch.clamp(v, min=cfg.min_value).to(torch.float64)
    bounds = _tables(cfg, v.device).bounds
    return torch.searchsorted(bounds, v).to(torch.int32)


def bucket_index(values: torch.Tensor, cfg: DDSketchConfig) -> torch.Tensor:
    """[n] values (float, or integers read as u32) -> [n] int32 bucket in
    [0, buckets)."""
    return _bucket_f32(_as_f32(values), cfg)


def update(state: DDSketchState, group: torch.Tensor, values: torch.Tensor,
           mask: torch.Tensor | None = None,
           cfg: DDSketchConfig = DDSketchConfig()) -> DDSketchState:
    """Add a batch of (group, value) observations into `state` in place
    and return it. group: [n] integers in [0, groups); values: [n]
    durations (float, or integers read as u32); mask: [n] bool rows to
    take (None: all). Values below min_value count in `zeros`."""
    group = group.to(torch.int32)
    v = _as_f32(values)
    flat = (group * cfg.buckets + _bucket_f32(v, cfg))[None, :]
    is_zero = v < cfg.min_value
    w = ~is_zero
    if mask is not None:
        w = w & mask
        is_zero = is_zero & mask
    mxu_hist.hist_add_(state.hist.view(1, -1), flat,
                       cfg.groups * cfg.buckets, None, w)
    state.zeros.index_add_(0, group.to(torch.int64), is_zero.to(torch.int32))
    return state


def merge(a: DDSketchState, b: DDSketchState) -> DDSketchState:
    """Sketch union, exact: elementwise add into new tensors."""
    return DDSketchState(hist=a.hist + b.hist, zeros=a.zeros + b.zeros)


def quantiles(state: DDSketchState, qs: Sequence[float],
              cfg: DDSketchConfig = DDSketchConfig()) -> torch.Tensor:
    """[len(qs), groups] float32 q-quantile estimates per group (relative
    error <= alpha for values >= min_value); empty groups read 0. The
    counts become float32 before the cumulative sum, so `cdf < q*total`
    is the reference's float32 comparison."""
    hist = state.hist.to(torch.float32)
    zeros = state.zeros.to(torch.float32)
    total = zeros + hist.sum(dim=1)                         # [groups]
    cdf = zeros[:, None] + torch.cumsum(hist, dim=1)        # [groups, B]
    mids = _tables(cfg, hist.device).mids
    out = []
    for q in qs:
        target = q * total
        idx = (cdf < target[:, None]).sum(dim=1).clamp(0, cfg.buckets - 1)
        keep = (total > 0) & ~(target <= zeros)
        out.append(torch.where(keep, mids[idx], 0.0))
    return torch.stack(out)


def quantile(state: DDSketchState, q: float,
             cfg: DDSketchConfig = DDSketchConfig()) -> torch.Tensor:
    """[groups] float32 q-quantile estimate per group."""
    return quantiles(state, (q,), cfg)[0]


def counts(state: DDSketchState) -> torch.Tensor:
    """[groups] float32 total observations per group."""
    return state.zeros.to(torch.float32) \
        + state.hist.to(torch.float32).sum(dim=1)
