"""Streaming PCA (Oja subspace tracking) for golden-signal anomaly scores.

Tracks the top-k principal subspace of a feature vector with
EMA-standardized inputs and batched Oja updates; the anomaly score is
the reconstruction residual outside the tracked subspace.

`update` is `grad` then `apply_grad`, so a multi-device caller can
all-reduce the `grad` tuple between the two calls. The basis is
re-orthonormalized with `torch.linalg.qr`, whose column signs may differ
from another QR implementation's (LAPACK, cuSOLVER): every score depends
only on the projector `w @ w.T`, so compare projectors, never `w`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PCAState(NamedTuple):
    mean: torch.Tensor   # [f] float32 EMA mean
    var: torch.Tensor    # [f] float32 EMA variance
    w: torch.Tensor      # [f, k] float32 orthonormal basis
    step: torch.Tensor   # [] int32


def init(features: int, k: int, seed: int = 7, device="cuda") -> PCAState:
    """Deterministic full-rank start: an identity slab plus a small sine
    perturbation, orthonormalized (`seed` is kept for the reference's
    signature; the start does not depend on it)."""
    a = torch.eye(features, k, dtype=torch.float32, device=device)
    noise = torch.sin(torch.arange(features * k, dtype=torch.float32,
                                   device=device)).reshape(features, k)
    q, _ = torch.linalg.qr(a + 0.01 * noise)
    return PCAState(
        mean=torch.zeros(features, dtype=torch.float32, device=device),
        var=torch.ones(features, dtype=torch.float32, device=device),
        w=q.to(torch.float32),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


# EMA-variance floor for standardization: a (near-)constant feature's
# variance decays toward 0, and without a floor one count of jitter on a
# quiet signal becomes a huge z
_VAR_FLOOR = 1e-4


def _standardize(state: PCAState, x: torch.Tensor) -> torch.Tensor:
    return (x - state.mean[None, :]) \
        / torch.sqrt(torch.clamp(state.var[None, :], min=_VAR_FLOOR))


def update(state: PCAState, x: torch.Tensor, mask=None, lr: float = 0.05,
           ema: float = 0.01) -> PCAState:
    """One batched Oja step on x: [n, features] float32."""
    return apply_grad(state, *grad(state, x, mask), lr=lr, ema=ema)


def score(state: PCAState, x: torch.Tensor) -> torch.Tensor:
    """[n] reconstruction-residual scores (L2 norm outside the subspace)."""
    z = _standardize(state, x)
    proj = (z @ state.w) @ state.w.T
    return torch.sqrt(torch.sum((z - proj) ** 2, dim=1))


def grad(state: PCAState, x: torch.Tensor, mask=None):
    """(count, sum, sum of squares, Oja gradient) of one batch: the terms
    a multi-device caller sums before `apply_grad`."""
    n = x.shape[0]
    m = torch.ones(n, dtype=torch.float32, device=x.device) if mask is None \
        else mask.to(torch.float32)
    cnt = torch.sum(m)
    s1 = torch.sum(x * m[:, None], dim=0)
    s2 = torch.sum((x ** 2) * m[:, None], dim=0)
    z = _standardize(state, x) * m[:, None]
    g = z.T @ (z @ state.w)
    return cnt, s1, s2, g


def apply_grad(state: PCAState, cnt, s1, s2, g, lr: float = 0.05,
               ema: float = 0.01) -> PCAState:
    """Apply the (summed) batch statistics and gradient."""
    c = torch.clamp(cnt, min=1.0)
    bmean = s1 / c
    bvar = torch.clamp(s2 / c - bmean ** 2, min=0.0)
    mean = (1 - ema) * state.mean + ema * bmean
    var = (1 - ema) * state.var + ema * bvar
    w, _ = torch.linalg.qr(state.w + lr * g / c)
    return PCAState(mean=mean, var=var, w=w.to(torch.float32),
                    step=state.step + 1)
