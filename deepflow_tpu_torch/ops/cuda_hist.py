"""Batched histogram: the CUDA kernel `csrc/hist.cu` and its plain version.

Replaces `hist_pallas` in deepflow_tpu/ops/pallas_hist.py (the Pallas
kernel `_kernel` and its `pl.pallas_call`), which recast the scatter-add
as one-hot bf16 matmuls into a VMEM-resident f32 accumulator because the
TPU has no scatter unit.

What bounds it on the H100: bytes. idx [d, n] int32 and weights [n] are
read once and the [d, width] output written once; the arithmetic is an
add per item. How the design answers: int32 atomics instead of matmuls
(exact at any count); where a row fits in shared memory (entropy's 2^12
bins) each block privatizes one row over a chunk of lanes and merges it
once per non-zero bin; wider rows (the Count-Min's 2^17 bins) take
global atomics into the L2-resident output.

Semantics are `mxu_hist.hist`'s: indices clamp to [0, width); weights are
shared across rows and saturate at 256**weight_planes - 1 (keeping the
low 8*weight_planes bits, which is what the reference's digit planes
add up to for any int32 weight); no weights count 1 per lane; the result
is float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deepflow_tpu_torch.ops import _build

_SIGNATURES = {"df_hist": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
               + [ctypes.c_void_p]}


def _check_args(idx: torch.Tensor, width: int,
                weights: Optional[torch.Tensor], weight_planes: int) -> int:
    if idx.dim() != 2 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be [d, n] int32, got {tuple(idx.shape)} "
                         f"{idx.dtype}")
    if weights is not None and (weights.dim() != 1
                                or weights.shape[0] != idx.shape[1]
                                or weights.dtype != torch.int32
                                or weights.device != idx.device):
        raise ValueError("weights must be [n] int32 on idx's device")
    if not 1 <= weight_planes <= 3:
        raise ValueError(f"weight_planes {weight_planes} not in 1..3")
    if width < 1:
        raise ValueError(f"width {width} < 1")
    return 256 ** weight_planes - 1 if weights is not None else 1


def hist_plain(idx: torch.Tensor, width: int,
               weights: Optional[torch.Tensor] = None,
               weight_planes: int = 2) -> torch.Tensor:
    """The plain PyTorch version of the kernel (any device)."""
    wmax = _check_args(idx, width, weights, weight_planes)
    d, n = idx.shape
    rows = torch.arange(d, device=idx.device, dtype=torch.int64)[:, None]
    flat = (idx.to(torch.int64).clamp(0, width - 1) + rows * width).reshape(-1)
    if weights is None:
        w = torch.ones(n, dtype=torch.int32, device=idx.device)
    else:
        w = torch.clamp(weights, max=wmax) & wmax
    acc = torch.zeros(d * width, dtype=torch.int32, device=idx.device)
    acc.index_add_(0, flat, w.expand(d, n).reshape(-1))
    return acc.to(torch.float32).reshape(d, width)


def hist_cuda(idx: torch.Tensor, width: int,
              weights: Optional[torch.Tensor] = None,
              weight_planes: int = 2) -> torch.Tensor:
    """Launch `df_hist` on the current stream; every call counts one
    launch in `hist_cuda.launches`."""
    wmax = _check_args(idx, width, weights, weight_planes)
    if idx.device.type != "cuda":
        raise ValueError(f"hist_cuda needs CUDA tensors, got {idx.device}")
    if not idx.is_contiguous() or (weights is not None
                                   and not weights.is_contiguous()):
        raise ValueError("hist_cuda needs contiguous tensors")
    d, n = idx.shape
    lib = _build.library("hist", _SIGNATURES)
    acc = torch.zeros(d * width, dtype=torch.int32, device=idx.device)
    out = torch.empty(d, width, dtype=torch.float32, device=idx.device)
    err = lib.df_hist(idx.data_ptr(),
                      None if weights is None else weights.data_ptr(),
                      acc.data_ptr(), out.data_ptr(), d, n, width, wmax,
                      _build.stream_handle(idx.device))
    _build.check(err, "df_hist")
    hist_cuda.launches += 1
    return out


hist_cuda.launches = 0


def hist(idx: torch.Tensor, width: int,
         weights: Optional[torch.Tensor] = None,
         weight_planes: int = 2) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if idx.device.type == "cuda":
        return hist_cuda(idx, width, weights, weight_planes)
    if idx.device.type == "cpu":
        return hist_plain(idx, width, weights, weight_planes)
    raise ValueError(f"hist: unsupported device {idx.device}")
