"""Streaming anomaly models over the flow_metrics Document stream.

Two detectors over METRIC_SCHEMA batches (the decoded form of the
agent's 1 s Documents):

- **DDoS entropy detector**: per-window traffic entropy over
  (ip, server_port) weighted by packets, tracked by an EWMA; a z-score
  swing past `z_threshold` once the EWMA has seen 10 windows raises the
  alarm.
- **Golden-signal PCA**: Oja streaming PCA over the log1p'd meter
  vector; the reconstruction residual is each record's anomaly score.
- **Matrix-profile discords**: per-signal rings of window sums; the
  newest subsequence's nearest-neighbour distance flags window shapes
  the instantaneous detectors cannot see.

State is a NamedTuple of tensors with the JAX package's field names,
leaf order and dtypes. `update` adds the entropy histograms IN PLACE
(the state passed in must not be used afterwards except through the
returned state). The u32 columns may arrive as int32 bits: every
column is read as u32 before a float conversion or an add.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import torch

from deepflow_tpu_torch.models.flow_suite import check_device
from deepflow_tpu_torch.ops import entropy, matrix_profile, pca
from deepflow_tpu_torch.utils.u32 import as_u32, to_bits

GOLDEN_SIGNALS = (
    "packet_tx", "packet_rx", "byte_tx", "byte_rx",
    "new_flow", "closed_flow", "syn", "synack",
    "retrans_tx", "retrans_rx", "rtt_sum", "rtt_count",
)

ENTROPY_FEATURES = ("ip", "server_port")


@dataclass(frozen=True)
class MetricsSuiteConfig:
    pca_k: int = 3
    entropy_log2_buckets: int = 10
    ewma_alpha: float = 0.05
    z_threshold: float = 4.0
    pca_lr: float = 0.05
    mp_length: int = 512      # windows of history per signal ring
    mp_m: int = 16            # subsequence length (windows)
    seed: int = 0x3E7


class MetricsSuiteState(NamedTuple):
    ent: entropy.EntropyState
    ent_mean: torch.Tensor  # [2] float32 EWMA of per-window entropies
    ent_var: torch.Tensor   # [2] float32
    windows: torch.Tensor   # [] int32
    pca: pca.PCAState
    win_sum: torch.Tensor   # [signals] float32 raw window sums (pre-log)
    mp: matrix_profile.MPState


class MetricsWindowOutput(NamedTuple):
    entropies: torch.Tensor       # [2] float32
    z_scores: torch.Tensor        # [2] float32
    ddos_alarm: torch.Tensor      # [] bool
    anomaly_scores: torch.Tensor  # [n] PCA residual per record of the batch
    mp_scores: torch.Tensor       # [signals] newest-window discord distances


def init(cfg: MetricsSuiteConfig, device="cuda") -> MetricsSuiteState:
    device = check_device(device)
    nf, ns = len(ENTROPY_FEATURES), len(GOLDEN_SIGNALS)
    return MetricsSuiteState(
        ent=entropy.init(nf, cfg.entropy_log2_buckets, cfg.seed, device),
        ent_mean=torch.full((nf,), 0.5, dtype=torch.float32, device=device),
        ent_var=torch.full((nf,), 0.25, dtype=torch.float32, device=device),
        windows=torch.zeros((), dtype=torch.int32, device=device),
        pca=pca.init(ns, cfg.pca_k, device=device),
        win_sum=torch.zeros(ns, dtype=torch.float32, device=device),
        mp=matrix_profile.init(ns, cfg.mp_length, device=device),
    )


def raw_signals(cols: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[n, signals] float32 raw golden-signal matrix (u32 values rounded
    to float32), the one stack the PCA and matrix-profile paths share."""
    return torch.stack([as_u32(cols[s]).to(torch.float32)
                        for s in GOLDEN_SIGNALS], dim=1)


def signal_matrix(cols: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[n, signals] log1p-compressed golden-signal matrix."""
    return torch.log1p(raw_signals(cols))


def entropy_update(ent: entropy.EntropyState, cols: Dict[str, torch.Tensor],
                   mask: torch.Tensor) -> entropy.EntropyState:
    """The entropy half of the update, shared with the sharded suite.
    Packets are the u32 sum of packet_tx and packet_rx (wrapping), read
    as int32 as the reference reads it; 2 weight planes saturate them at
    65535."""
    feats = torch.stack([as_u32(cols[f]) for f in ENTROPY_FEATURES])
    packets = to_bits(as_u32(cols["packet_tx"]) + as_u32(cols["packet_rx"]))
    return entropy.update(ent, feats, packets, mask, weight_planes=2)


def _masked_sum(raw: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (raw * mask.to(torch.float32)[:, None]).sum(dim=0)


def window_sum(cols: Dict[str, torch.Tensor],
               mask: torch.Tensor) -> torch.Tensor:
    """[signals] masked raw sums for the matrix-profile ring (summed
    before the log, so shards add exactly; log1p at push time)."""
    return _masked_sum(raw_signals(cols), mask)


def update(state: MetricsSuiteState, cols: Dict[str, torch.Tensor],
           mask: torch.Tensor, cfg: MetricsSuiteConfig) -> MetricsSuiteState:
    ent = entropy_update(state.ent, cols, mask)
    raw = raw_signals(cols)
    p = pca.update(state.pca, torch.log1p(raw), mask, lr=cfg.pca_lr)
    return state._replace(ent=ent, pca=p,
                          win_sum=state.win_sum + _masked_sum(raw, mask))


def flush(state: MetricsSuiteState, cols: Dict[str, torch.Tensor],
          mask: torch.Tensor, cfg: MetricsSuiteConfig
          ) -> Tuple[MetricsSuiteState, MetricsWindowOutput]:
    """Close the entropy window; score the (last) batch against the PCA."""
    ents = entropy.entropies(state.ent)
    std = torch.sqrt(state.ent_var + 1e-6)
    z = (ents - state.ent_mean) / std
    # volumetric DDoS: victim (dst ip) entropy collapses while the window
    # is busy; alarm on a large |z| swing once the EWMA is warmed up
    alarm = (state.windows > 10) & (torch.max(torch.abs(z)) > cfg.z_threshold)
    a = cfg.ewma_alpha
    mean = (1 - a) * state.ent_mean + a * ents
    var = (1 - a) * state.ent_var + a * (ents - mean) ** 2
    scores = pca.score(state.pca, signal_matrix(cols)) \
        * mask.to(torch.float32)
    # push the window's (merged) aggregate vector, then price the newest
    # subsequence against history
    mp = matrix_profile.push(state.mp, torch.log1p(state.win_sum))
    mp_scores = matrix_profile.latest_score(mp, cfg.mp_m)
    out = MetricsWindowOutput(entropies=ents, z_scores=z, ddos_alarm=alarm,
                              anomaly_scores=scores, mp_scores=mp_scores)
    fresh = state._replace(
        ent=entropy.reset(state.ent),
        ent_mean=mean,
        ent_var=var,
        windows=state.windows + 1,
        win_sum=torch.zeros_like(state.win_sum),
        mp=mp,
    )
    return fresh, out
