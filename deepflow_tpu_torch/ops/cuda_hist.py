"""Batched histogram added in place: the CUDA kernel `csrc/hist.cu` and
its plain version.

Replaces `hist_pallas` in deepflow_tpu/ops/pallas_hist.py (the Pallas
kernel `_kernel` and its `pl.pallas_call`), which recast the scatter-add
as one-hot bf16 matmuls into a VMEM-resident f32 accumulator because the
TPU has no scatter unit.

`hist_add_(acc, idx, width, weights, mask, weight_planes)` adds into the
int32 state `acc` [d, width] in place what the reference computes as
`state + mxu_hist.hist_masked(idx, width, weights, mask, weight_planes)`:
indices clamp to [0, width); a lane whose mask is False adds nothing;
weights are shared across rows and saturate at 256**weight_planes - 1
(keeping the low 8*weight_planes bits, which is what the reference's
digit planes add up to for any int32 weight); without weights a lane adds
1. `mxu_hist.hist` keeps the reference's float32 form on top of it.

What bounds it on the H100: bytes. idx [d, n] int32 and the weights or
mask are read once, the state read and written once; the arithmetic is an
add per item. How the design answers: one launch adds straight into the
int32 state (no zero fill, no float conversion, no separate add); a row
that fits a block's shared memory (the entropy width) is counted into a
private copy per block and merged once per non-zero bin; wider rows (the
Count-Min width) take atomics into the L2-resident state.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deepflow_tpu_torch.ops import _build

_SIGNATURES = {"df_hist_add": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
               + [ctypes.c_void_p]}


def _check_args(acc: torch.Tensor, idx: torch.Tensor, width: int,
                weights: Optional[torch.Tensor],
                mask: Optional[torch.Tensor],
                weight_planes: int) -> Tuple[int, int, int]:
    """Raise on what neither version takes; return (d, n, wmax)."""
    if idx.dim() != 2 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be [d, n] int32, got {tuple(idx.shape)} "
                         f"{idx.dtype}")
    d, n = idx.shape
    if width < 1:
        raise ValueError(f"width {width} < 1")
    if acc.dtype != torch.int32 or tuple(acc.shape) != (d, width) \
            or acc.device != idx.device or not acc.is_contiguous():
        raise ValueError(f"acc must be a contiguous [{d}, {width}] int32 "
                         f"tensor on {idx.device}, got {tuple(acc.shape)} "
                         f"{acc.dtype} on {acc.device}")
    if weights is not None and (weights.dim() != 1 or weights.shape[0] != n
                                or weights.dtype != torch.int32
                                or weights.device != idx.device):
        raise ValueError("weights must be [n] int32 on idx's device")
    if mask is not None and (mask.dim() != 1 or mask.shape[0] != n
                             or mask.dtype != torch.bool
                             or mask.device != idx.device):
        raise ValueError("mask must be [n] bool on idx's device")
    if not 1 <= weight_planes <= 3:
        raise ValueError(f"weight_planes {weight_planes} not in 1..3")
    return d, n, 256 ** weight_planes - 1


def hist_add_plain(acc: torch.Tensor, idx: torch.Tensor, width: int,
                   weights: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None,
                   weight_planes: int = 2) -> torch.Tensor:
    """The plain PyTorch version of the kernel (any device): one
    `index_add_` into `acc`, which it returns."""
    d, n, wmax = _check_args(acc, idx, width, weights, mask, weight_planes)
    rows = torch.arange(d, device=idx.device, dtype=torch.int64)[:, None]
    flat = (idx.to(torch.int64).clamp(0, width - 1) + rows * width).reshape(-1)
    if weights is None:
        w = torch.ones(n, dtype=torch.int32, device=idx.device)
    else:
        w = torch.clamp(weights, max=wmax) & wmax
    if mask is not None:
        w = w * mask.to(torch.int32)
    acc.view(-1).index_add_(0, flat, w.expand(d, n).reshape(-1))
    return acc


def hist_add_cuda(acc: torch.Tensor, idx: torch.Tensor, width: int,
                  weights: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  weight_planes: int = 2) -> torch.Tensor:
    """Launch `df_hist_add` on the current stream, adding into `acc`;
    every launch counts one in `hist_add_cuda.launches`."""
    d, n, wmax = _check_args(acc, idx, width, weights, mask, weight_planes)
    for t in (idx, weights, mask):
        if t is not None and not t.is_contiguous():
            raise ValueError("hist_add_cuda needs contiguous tensors")
    if idx.device.type != "cuda":
        raise ValueError(f"hist_add_cuda needs CUDA tensors, got {idx.device}")
    if d == 0 or n == 0:
        return acc
    fn = _build.function("hist", "df_hist_add", _SIGNATURES)
    err = fn(idx.data_ptr(), None if weights is None else weights.data_ptr(),
             None if mask is None else mask.data_ptr(), acc.data_ptr(), d, n,
             width, wmax, _build.stream_handle(acc.device))
    _build.check(err, "df_hist_add")
    hist_add_cuda.launches += 1
    return acc


hist_add_cuda.launches = 0


def hist_add_(acc: torch.Tensor, idx: torch.Tensor, width: int,
              weights: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None,
              weight_planes: int = 2) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    if acc.device.type == "cuda":
        return hist_add_cuda(acc, idx, width, weights, mask, weight_planes)
    if acc.device.type == "cpu":
        return hist_add_plain(acc, idx, width, weights, mask, weight_planes)
    raise ValueError(f"hist_add_: unsupported device {acc.device}")
