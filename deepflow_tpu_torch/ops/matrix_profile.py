"""Streaming matrix-profile discords: nearest-neighbour subsequence
distances as batched products.

For every length-m subsequence of a windowed series, the profile is the
z-normalized Euclidean distance to its nearest non-trivial neighbour; a
high value is a discord, a window pattern unlike anything seen before.
The all-pairs dot products of one series are one batched product
([n_sub, m] x [m, n_sub]); means and deviations come per subsequence;
distances, trivial-match exclusion and the row minimum are elementwise.

The state is a right-aligned ring per series: `push` appends the newest
window's values, `latest_score` prices only the newest subsequence
against history (one product per series), `profile` computes the whole
profile.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class MPState(NamedTuple):
    ring: torch.Tensor    # [series, length] float32, right-aligned
    count: torch.Tensor   # [] int32 windows ever pushed


def init(series: int, length: int = 512, device="cuda") -> MPState:
    return MPState(
        ring=torch.zeros(series, length, dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device))


def push(state: MPState, values: torch.Tensor) -> MPState:
    """Append one window's [series] values (the oldest falls off)."""
    ring = torch.cat([state.ring[:, 1:],
                      values.to(torch.float32)[:, None]], dim=1)
    return MPState(ring=ring, count=state.count + 1)


_SD_FLOOR = 1e-5


def _sub_stats(ring: torch.Tensor, m: int):
    """Sliding [series, n_sub, m] subsequences and their mean and
    standard deviation (population variance). A non-finite variance (an
    overflowing or inf/NaN-poisoned subsequence) is taken as zero, so it
    prices by the constant-subsequence rule instead of poisoning every
    row it neighbours."""
    subs = ring.unfold(1, m, 1)                        # [s, n_sub, m]
    mu = subs.mean(dim=2)
    var = subs.var(dim=2, correction=0)
    var = torch.where(torch.isfinite(var), var, torch.zeros_like(var))
    sd = torch.sqrt(torch.clamp(var, min=_SD_FLOOR ** 2))
    return subs, mu, sd


def _znorm_dist2(qt, mu_a, sd_a, mu_b, sd_b, m: int):
    """z-normalized squared distance from dot products,
    2m (1 - (qt - m mu_a mu_b) / (m sd_a sd_b)), clipped to [0, 4m].
    Flat against flat is 0, flat against varying is m. A non-finite
    correlation (inf - inf in an overflowing subsequence) is blanked to
    0 before the clip."""
    corr = (qt - m * mu_a * mu_b) / (m * sd_a * sd_b)
    corr = torch.where(torch.isfinite(corr), corr, torch.zeros_like(corr))
    corr = torch.clamp(corr, -1.0, 1.0)
    d2 = 2.0 * m * (1.0 - corr)
    const_a = sd_a <= _SD_FLOOR
    const_b = sd_b <= _SD_FLOOR
    return torch.where(const_a & const_b, torch.zeros_like(d2),
                       torch.where(const_a | const_b,
                                   torch.full_like(d2, float(m)), d2))


def _valid_sub_mask(count, length: int, n_sub: int, device):
    """Subsequence j is real data iff it lies in the ring's seen region
    (the last min(count, length) entries)."""
    first = length - torch.clamp(count, max=length)
    return torch.arange(n_sub, device=device) >= first


def profile(state: MPState, m: int = 16) -> torch.Tensor:
    """[series, n_sub] nearest-neighbour distance per subsequence; +inf
    where the subsequence (or every neighbour) is invalid. Self-match and
    trivial matches within m//2 are excluded."""
    length = state.ring.shape[1]
    n_sub = length - m + 1
    dev = state.ring.device
    subs, mu, sd = _sub_stats(state.ring, m)
    qt = torch.einsum("sim,sjm->sij", subs, subs)
    d2 = _znorm_dist2(qt, mu[:, :, None], sd[:, :, None],
                      mu[:, None, :], sd[:, None, :], m)
    i = torch.arange(n_sub, device=dev)
    trivial = (i[:, None] - i[None, :]).abs() < max(m // 2, 1)
    valid = _valid_sub_mask(state.count, length, n_sub, dev)
    bad = trivial[None, :, :] | ~valid[None, None, :]
    d2 = torch.where(bad, torch.full_like(d2, float("inf")), d2)
    prof = torch.sqrt(torch.amin(d2, dim=2))
    return torch.where(valid[None, :], prof,
                       torch.full_like(prof, float("inf")))


def latest_score(state: MPState, m: int = 16) -> torch.Tensor:
    """[series] discord score of the newest subsequence: its distance to
    the nearest older neighbour. 0 until 2m windows were pushed."""
    length = state.ring.shape[1]
    n_sub = length - m + 1
    dev = state.ring.device
    subs, mu, sd = _sub_stats(state.ring, m)
    q = subs[:, -1]                                    # [s, m]
    qt = torch.einsum("sm,sjm->sj", q, subs)
    d2 = _znorm_dist2(qt, mu[:, -1:], sd[:, -1:], mu, sd, m)
    i = torch.arange(n_sub, device=dev)
    trivial = i > (n_sub - 1 - max(m // 2, 1))
    valid = _valid_sub_mask(state.count, length, n_sub, dev)
    d2 = torch.where(trivial[None, :] | ~valid[None, :],
                     torch.full_like(d2, float("inf")), d2)
    score = torch.sqrt(torch.amin(d2, dim=1))
    warm = state.count >= 2 * m
    return torch.where(warm & torch.isfinite(score), score,
                       torch.zeros_like(score))


def discords(state: MPState, m: int = 16,
             k: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k discords (score, subsequence index) per series from the full
    profile, highest first, the lower index first among equal scores;
    invalid subsequences score -inf."""
    prof = profile(state, m)
    finite = torch.where(torch.isfinite(prof), prof,
                         torch.full_like(prof, float("-inf")))
    order = torch.sort(finite, dim=1, descending=True, stable=True).indices
    idx = order[:, :k]
    return torch.gather(finite, 1, idx), idx
