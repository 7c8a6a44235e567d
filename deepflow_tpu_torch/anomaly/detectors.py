"""The anomaly plane's detectors: device state, the per-batch active-flow
offer and the per-window step.

Three detectors advance in one window step at every window close:

- **entropy_ddos**: EWMA z-scores of the suite's 4 feature entropies,
  combined directionally (source dispersion rises under spoofing while
  destination entropy collapses onto the victim). Beside it runs a
  device-resident **active-flow table**: a direct-mapped key table fed
  per batch from the planes the sketch update already moved to the
  device, evicted LRU-by-window, whose active and new flow counts ride
  the golden-signal vector.
- **pca_residual**: the streaming-PCA reconstruction residual of the
  per-window golden-signal vector (`GOLDEN_FEATURES`), standardized
  against an EWMA of its own history (`ops/pca.py`).
- **mp_discord**: the matrix-profile discord of the newest subsequence
  of golden vectors (`ops/matrix_profile.py`).

The state is a NamedTuple of tensors, separate from the sketch state, in
the reference's leaf order and dtypes (the uint32 key table is held as
int32 bits; `_SENTINEL_BITS` -1 marks an empty slot). Every function
returns new tensors and leaves its input state untouched. Nothing here
reads a device value on the host: per-plane valid counts are read from
the staged buffer on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from deepflow_tpu_torch.models import flow_dict, flow_suite
from deepflow_tpu_torch.ops import matrix_profile, pca
from deepflow_tpu_torch.utils.twinmark import host_twin_of
from deepflow_tpu_torch.utils.u32 import as_u32, fold_columns, mix32, to_bits

__all__ = ["AnomalyConfig", "AnomalyState", "WindowScores", "DETECTORS",
           "GOLDEN_FEATURES", "init", "offer", "window_step", "feed_lanes",
           "feed_cols", "feed_flat", "feed_news", "feed_hits",
           "feed_dict_flat", "ddos_score_np"]

# detector order is the wire order: scores[i], thresholds[i] and
# alerts_total[i] all index this tuple
DETECTORS = ("entropy_ddos", "pca_residual", "mp_discord")

# the golden-signal vector (one per window close) the PCA and
# matrix-profile detectors consume; counts are log1p-compressed
GOLDEN_FEATURES = (
    "log_rows", "log_active_flows", "log_new_flows",
    "entropy_ip_src", "entropy_ip_dst", "entropy_port_src",
    "entropy_port_dst", "log_distinct_clients", "top1_share",
)

_SENTINEL = 0xFFFFFFFF         # empty active-table slot, as a u32 value
_SENTINEL_BITS = -1            # the same, as int32 bits in the state
# EWMA-variance floor of the z-scores (the ops/pca.py posture)
_VAR_FLOOR = 1e-4


@dataclass(frozen=True)
class AnomalyConfig:
    """Threshold and sizing knobs."""

    active_log2: int = 14        # active-flow table slots (2^n); 0 disables
    entropy_z: float = 4.0       # entropy_ddos alert threshold (z units)
    pca_z: float = 4.0           # pca_residual alert threshold (z units)
    mp_threshold: float = 3.0    # mp_discord threshold (z-norm distance)
    warmup_windows: int = 8      # windows before any detector may score
    ewma_alpha: float = 0.05
    pca_k: int = 3
    mp_length: int = 128         # windows of golden-vector history
    mp_m: int = 8                # discord subsequence length (windows)
    top_contributors: int = 5    # ring top-K keys attached to an alert
    seed: int = 0xA70A17

    @property
    def thresholds(self) -> Tuple[float, float, float]:
        return (self.entropy_z, self.pca_z, self.mp_threshold)


class AnomalyState(NamedTuple):
    # active-flow working set (direct-mapped, LRU-by-window)
    keys: torch.Tensor          # [cap] int32 u32 bits, -1 = empty
    born: torch.Tensor          # [cap] int32 window the key first appeared
    last_window: torch.Tensor   # [cap] int32 window the key was last seen
    offers: torch.Tensor        # [] int32 rows offered to the table
    evictions: torch.Tensor     # [] int32 LRU-by-window displacements
    window: torch.Tensor        # [] int32 current (open) window index
    # entropy_ddos EWMA baseline over the 4 feature entropies
    ent_mean: torch.Tensor      # [4] float32
    ent_var: torch.Tensor       # [4] float32
    # pca_residual: Oja subspace + EWMA of its own residual
    pca: pca.PCAState
    res_mean: torch.Tensor      # [] float32
    res_var: torch.Tensor       # [] float32
    # mp_discord: golden-vector rings
    mp: matrix_profile.MPState


class WindowScores(NamedTuple):
    """One window step's outputs (device tensors)."""

    scores: torch.Tensor        # [3] float32, DETECTORS order, 0 pre-warmup
    z: torch.Tensor             # [4] float32 entropy z-scores
    feats: torch.Tensor         # [9] float32 golden-signal vector
    active_flows: torch.Tensor  # [] int32 table slots seen this window
    new_flows: torch.Tensor     # [] int32 of those, first seen this window
    rows: torch.Tensor          # [] int32 the window's row count


def init(cfg: AnomalyConfig, window: int = 0, device="cuda") -> AnomalyState:
    """Fresh plane state; `window` seeds the window counter (a reset
    mid-run keeps the table's LRU epoch aligned with the host count)."""
    device = flow_suite.check_device(device)
    cap = 1 << cfg.active_log2 if cfg.active_log2 > 0 else 1
    f = len(GOLDEN_FEATURES)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return AnomalyState(
        keys=full((cap,), _SENTINEL_BITS, torch.int32),
        born=full((cap,), 0, torch.int32),
        last_window=full((cap,), -1, torch.int32),
        offers=full((), 0, torch.int32),
        evictions=full((), 0, torch.int32),
        window=full((), int(window), torch.int32),
        ent_mean=full((4,), 0.5, torch.float32),
        ent_var=full((4,), 0.25, torch.float32),
        pca=pca.init(f, cfg.pca_k, seed=cfg.seed & 0xFFFF, device=device),
        res_mean=full((), 0.0, torch.float32),
        res_var=full((), 1.0, torch.float32),
        mp=matrix_profile.init(f, cfg.mp_length, device=device),
    )


# -- active-flow working set (per batch) -----------------------------------

def offer(state: AnomalyState, fkeys: torch.Tensor, mask: torch.Tensor,
          cfg: AnomalyConfig) -> AnomalyState:
    """Offer one batch of flow keys (u32 values or int32 bits) to the
    active-flow table.

    Direct-mapped by a multiply-shift hash; a slot admits the incoming
    key when it is empty, already holds the key, or its occupant was not
    seen in the current window (LRU-by-window: the stale occupant is
    displaced, counted). An occupant seen this window wins the
    collision. Every row is judged against the table as it stood before
    the batch. Among the admitted rows of one slot the highest row index
    wins, chosen explicitly (a scatter with duplicate indices leaves the
    winner undefined on CUDA), and keys, born and last_window are all
    written from that one row. `evictions` counts every evicting row."""
    w = state.window
    cap = state.keys.shape[0]
    fkeys = as_u32(fkeys)
    n = fkeys.shape[0]
    dev = fkeys.device
    slot = mix32(fkeys ^ (cfg.seed & 0xFFFFFFFF)) >> (32 - cfg.active_log2)
    occ_key = as_u32(state.keys[slot])
    occ_born = state.born[slot]
    empty = occ_key == _SENTINEL
    same = occ_key == fkeys
    stale = state.last_window[slot] < w
    admit = mask & (empty | same | stale)
    # the winner of each slot: the highest admitted row (-1: none)
    row = torch.arange(n, device=dev)
    win = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    win.scatter_reduce_(0, slot, torch.where(admit, row, -1), "amax")
    has = win >= 0
    pick = torch.clamp(win, min=0)
    new_born = torch.where(same, occ_born, w)
    evicted = admit & ~empty & ~same
    return state._replace(
        keys=torch.where(has, to_bits(fkeys)[pick], state.keys),
        born=torch.where(has, new_born[pick], state.born),
        last_window=torch.where(has, w, state.last_window),
        offers=state.offers + mask.sum(dtype=torch.int32),
        evictions=state.evictions + evicted.sum(dtype=torch.int32))


# -- the window step (one per flush) ----------------------------------------

def _golden_vector(entropies, topk_counts, card, rows, active, new):
    rows_f = rows.to(torch.float32)
    top1 = torch.clamp(topk_counts.max(), min=0).to(torch.float32)
    return torch.stack([
        torch.log1p(rows_f),
        torch.log1p(active.to(torch.float32)),
        torch.log1p(new.to(torch.float32)),
        entropies[0], entropies[1], entropies[2], entropies[3],
        torch.log1p(torch.clamp(card.sum(), min=0.0)),
        top1 / torch.clamp(rows_f, min=1.0),
    ]).to(torch.float32)


def _ddos_score(z: torch.Tensor) -> torch.Tensor:
    """Directional combination of the 4 entropy z-scores: source
    dispersion rising or destination entropy collapsing pushes the score
    up; either alone can cross the threshold, both together compound."""
    up = torch.clamp(z[0], min=0.0) + torch.clamp(z[2], min=0.0)
    down = torch.clamp(-z[1], min=0.0) + torch.clamp(-z[3], min=0.0)
    return torch.maximum(torch.maximum(up, down), (up + down) / 2.0)


def _select(cond, new, old):
    """Leafwise torch.where over two NamedTuples of one type."""
    return type(new)(*(torch.where(cond, a, b) for a, b in zip(new, old)))


def window_step(state: AnomalyState, entropies: torch.Tensor,
                topk_counts: torch.Tensor, card: torch.Tensor, rows,
                cfg: AnomalyConfig) -> Tuple[AnomalyState, WindowScores]:
    """Close one window: score all three detectors against the settled
    window output, then advance every cross-window state (EWMA baselines,
    Oja subspace, matrix-profile ring, window counter).

    Scoring uses the pre-update baselines; an empty window (rows == 0)
    scores 0 and leaves the baselines untouched. The effective EWMA rate
    is max(alpha, 1/(w+1)): a running average while young. A window a
    detector alerts on does not update that detector's own baseline."""
    w = state.window
    dev = w.device
    rows = torch.as_tensor(rows, device=dev).to(torch.int32).reshape(())
    busy = rows > 0
    warm = w >= cfg.warmup_windows
    live = busy & warm

    seen = state.last_window == w
    active = seen.sum(dtype=torch.int32)
    new = (seen & (state.born == w)).sum(dtype=torch.int32)
    ent = entropies.to(torch.float32)
    g = _golden_vector(ent, topk_counts, card, rows, active, new)

    z = (ent - state.ent_mean) / torch.sqrt(
        torch.clamp(state.ent_var, min=_VAR_FLOOR))
    s_ddos = _ddos_score(z)

    r = pca.score(state.pca, g[None, :])[0]
    s_pca = (r - state.res_mean) / torch.sqrt(
        torch.clamp(state.res_var, min=_VAR_FLOOR))

    mp = matrix_profile.push(state.mp, g)
    s_mp = matrix_profile.latest_score(mp, cfg.mp_m).max()

    scores = torch.where(live, torch.stack([s_ddos, s_pca, s_mp]),
                         torch.zeros(3, dtype=torch.float32, device=dev))

    a = torch.clamp(1.0 / (w.to(torch.float32) + 1.0), min=cfg.ewma_alpha)
    ent_calm = busy & ~(live & (s_ddos >= cfg.entropy_z))
    res_calm = busy & ~(live & (s_pca >= cfg.pca_z))
    ent_mean = torch.where(ent_calm, (1 - a) * state.ent_mean + a * ent,
                           state.ent_mean)
    ent_var = torch.where(
        ent_calm, (1 - a) * state.ent_var + a * (ent - ent_mean) ** 2,
        state.ent_var)
    res_mean = torch.where(res_calm, (1 - a) * state.res_mean + a * r,
                           state.res_mean)
    res_var = torch.where(
        res_calm, (1 - a) * state.res_var + a * (r - res_mean) ** 2,
        state.res_var)
    p = _select(res_calm, pca.update(state.pca, g[None, :]), state.pca)
    mp_kept = _select(busy, mp, state.mp)

    out = WindowScores(scores=scores, z=z, feats=g, active_flows=active,
                       new_flows=new, rows=rows)
    return state._replace(
        window=w + 1, ent_mean=ent_mean, ent_var=ent_var, pca=p,
        res_mean=res_mean, res_var=res_var, mp=mp_kept), out


# -- per-wire batch feeds -----------------------------------------------------

def _lanes_key(ip_src, ip_dst, ports, proto_word) -> torch.Tensor:
    """The 5-tuple flow key of lane words (proto in the top byte of
    `proto_word`), as `flow_suite.flow_key(unpack_lanes(...))` folds it."""
    ports = as_u32(ports)
    return fold_columns([ip_src, ip_dst, ports >> 16, ports & 0xFFFF,
                         as_u32(proto_word) >> 24])


def feed_lanes(state: AnomalyState, lanes: Dict[str, torch.Tensor],
               mask: torch.Tensor, cfg: AnomalyConfig) -> AnomalyState:
    """Offer one packed-lane batch (the planes the sketch update already
    moved to the device)."""
    return offer(state, _lanes_key(lanes["ip_src"], lanes["ip_dst"],
                                   lanes["ports"], lanes["proto_pkts"]),
                 mask, cfg)


def feed_cols(state: AnomalyState, cols: Dict[str, torch.Tensor],
              mask: torch.Tensor, cfg: AnomalyConfig) -> AnomalyState:
    """Offer one full-column batch."""
    return offer(state, flow_suite.flow_key(cols), mask, cfg)


def feed_flat(state: AnomalyState, flat: torch.Tensor, k: int,
              capacity: int, cfg: AnomalyConfig) -> AnomalyState:
    """Offer a K-slot coalesced lane buffer (int32 words), each slot's
    plane parsed as `flow_suite.make_coalesced_update` parses it; each
    slot's n is read on the device."""
    slots = flat.view(k, flow_suite.slot_words(capacity))
    for i in range(k):
        plane = slots[i, 1:].view(4, capacity)
        mask = flow_suite._valid(slots[i, 0:1], capacity, flat.device)
        state = offer(state, _lanes_key(*plane), mask, cfg)
    return state


def feed_news(state: AnomalyState, plane: torch.Tensor, n,
              cfg: AnomalyConfig) -> AnomalyState:
    """Offer one dict-wire (6, C) news plane (rows 1..3 are the lane key
    words, row 4 the raw proto byte)."""
    mask = flow_suite._valid(n, plane.shape[1], plane.device)
    key = fold_columns([plane[1], plane[2], as_u32(plane[3]) >> 16,
                        as_u32(plane[3]) & 0xFFFF, as_u32(plane[4]) & 0xFF])
    return offer(state, key, mask, cfg)


def feed_hits(state: AnomalyState, table: torch.Tensor, plane: torch.Tensor,
              n, cfg: AnomalyConfig) -> AnomalyState:
    """Offer one dict-wire (3, H) pairs-packed hits plane: key words
    gathered from the device dictionary table after the group's news
    were written (indices clamped, as `flow_dict.update_hits` gathers)."""
    idx, _pkts = flow_dict.unpack_hits(plane)
    rows = table[:, torch.clamp(idx, max=table.shape[1] - 1)]
    mask = flow_suite._valid(n, 2 * plane.shape[1], plane.device)
    return offer(state, _lanes_key(*rows), mask, cfg)


def feed_dict_flat(state: AnomalyState, table: torch.Tensor,
                   flat: torch.Tensor, sig, cfg: AnomalyConfig
                   ) -> AnomalyState:
    """Offer one staged dict-wire buffer (the [n-headers | raveled
    planes] layout `flow_dict.make_wire_update` reads), one offer per
    plane. Hits gather from the dictionary table after the whole group
    was applied: a hit whose index a later news plane of the same group
    reassigned is offered under the new tenant's key, a bounded
    approximation of a working-set tracker."""
    off = len(sig)
    for i, (kind, w) in enumerate(sig):
        n = flat[i:i + 1]
        nwords = flow_dict._KIND_ROWS[kind] * w
        plane = flat[off:off + nwords].view(flow_dict._KIND_ROWS[kind], w)
        off += nwords
        if kind == "news":
            state = feed_news(state, plane, n, cfg)
        else:
            state = feed_hits(state, table, plane, n, cfg)
    return state


# -- host scorer (the detection audit) ----------------------------------------

@host_twin_of("deepflow_tpu_torch/anomaly/detectors.py:_ddos_score")
def ddos_score_np(z: np.ndarray) -> float:
    """`_ddos_score` in plain numpy on host values: the shadow auditor
    scores its exact entropies with the same directional rule the device
    runs."""
    up = max(float(z[0]), 0.0) + max(float(z[2]), 0.0)
    down = max(-float(z[1]), 0.0) + max(-float(z[3]), 0.0)
    return max(up, down, (up + down) / 2.0)
