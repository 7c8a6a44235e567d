"""Batched histogram front end with the JAX package's `mxu_hist` semantics.

The reference computes histograms as one-hot matmuls on the TPU's MXU;
on the H100 the same function is the hand-written scatter kernel of
`ops/cuda_hist.py`, which adds into an int32 state in place. `hist_add_`
is what the sketches call (state + the reference's `hist_masked`, in one
launch); `hist` and `hist_masked` return the reference's float32 counts.
The kernel runs for CUDA tensors, its plain version for CPU ones.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepflow_tpu_torch.ops import cuda_hist

# Below this many lanes the reference takes its XLA scatter path (exact,
# unsaturated weights); cms/entropy keep the same dispatch so a batch
# gets the same answer on either package.
MIN_LANES = 8192


def hist_add_(acc: torch.Tensor, idx: torch.Tensor, width: int,
              weights: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None,
              weight_planes: int = 2) -> torch.Tensor:
    """acc [d, width] int32 += hist_masked(idx, width, weights, mask,
    weight_planes), in place; returns acc. idx [d, n] and weights [n] are
    read as int32, mask [n] as bool; a masked-out lane adds nothing, and
    without weights every other lane adds 1."""
    if idx.dtype != torch.int32:
        idx = idx.to(torch.int32)
    if not idx.is_contiguous():
        idx = idx.contiguous()
    if weights is not None:
        if weights.dtype != torch.int32:
            weights = weights.to(torch.int32)
        if not weights.is_contiguous():
            weights = weights.contiguous()
    if mask is not None:
        if mask.dtype != torch.bool:
            mask = mask.to(torch.bool)
        if not mask.is_contiguous():
            mask = mask.contiguous()
    return cuda_hist.hist_add_(acc, idx, width, weights, mask, weight_planes)


def hist_masked(idx: torch.Tensor, width: int,
                weights: Optional[torch.Tensor],
                mask: Optional[torch.Tensor],
                weight_planes: int = 2) -> torch.Tensor:
    """[d, width] float32 counts of the masked lanes."""
    acc = torch.zeros(idx.shape[0], width, dtype=torch.int32,
                      device=idx.device)
    return hist_add_(acc, idx, width, weights, mask,
                     weight_planes).to(torch.float32)


def hist(idx: torch.Tensor, width: int,
         weights: Optional[torch.Tensor] = None,
         weight_planes: int = 2) -> torch.Tensor:
    """idx [d, n] -> [d, width] float32 counts. `weights` [n] is shared
    across rows and saturates at 256**weight_planes - 1; indices are
    clamped to [0, width)."""
    return hist_masked(idx, width, weights, None, weight_planes)
