"""Batched histogram front end with the JAX package's `mxu_hist` semantics.

The reference computes histograms as one-hot matmuls on the TPU's MXU;
on the H100 the same function is the hand-written scatter kernel of
`ops/cuda_hist.py`. `hist` takes the kernel for a CUDA tensor and its
plain version for a CPU one; both return float32, as the reference does.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepflow_tpu_torch.ops import cuda_hist

# Below this many lanes the reference takes its XLA scatter path (exact,
# unsaturated weights); cms/entropy keep the same dispatch so a batch
# gets the same answer on either package.
MIN_LANES = 8192


def hist(idx: torch.Tensor, width: int,
         weights: Optional[torch.Tensor] = None,
         weight_planes: int = 2) -> torch.Tensor:
    """idx [d, n] int32 -> [d, width] float32 counts. `weights` [n] is
    shared across rows and saturates at 256**weight_planes - 1; indices
    are clamped to [0, width)."""
    if weights is not None:
        weights = weights.to(torch.int32).contiguous()
    return cuda_hist.hist(idx.to(torch.int32).contiguous(), width, weights,
                          weight_planes)


def hist_masked(idx: torch.Tensor, width: int,
                weights: Optional[torch.Tensor],
                mask: Optional[torch.Tensor],
                weight_planes: int = 2) -> torch.Tensor:
    """`hist` with the mask folded into the weights (mask-only batches
    need one weight plane)."""
    if weights is None and mask is not None:
        weights, weight_planes = mask.to(torch.int32), 1
    elif weights is not None and mask is not None:
        weights = weights.to(torch.int32) * mask.to(torch.int32)
    return hist(idx, width, weights, weight_planes)
