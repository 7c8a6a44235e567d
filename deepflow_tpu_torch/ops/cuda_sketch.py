"""Fused unpack + fold + sketch histograms: the CUDA kernels of
`csrc/fused_sketch.cu` and their plain versions.

Replaces `fused_lane_hists` and `fused_news_hists` in
deepflow_tpu/ops/pallas_sketch.py (the Pallas kernels `_kernel` and
`_news_kernel` around the shared `_hist_body`, launched by one
`pl.pallas_call` in `_call_hists`). Per record of a staged plane they
unpack the wire words, fold the 5-tuple into the flow key, and count d
Count-Min rows (weight 1) and 4 entropy feature rows (ip_src, ip_dst,
port_src, port_dst; weight min(pkts, 65535)). Records at or beyond the
batch's valid count `n` count nothing.

What bounds them on the H100: bytes -- the plane is read once (16 B or
24 B per record), the sketch state read and written once. How the design
answers: one pass per plane with the unpack in the kernel; `n` is read
from device memory (on the coalesced and wire paths it lives in the
staged buffer, so the host never syncs to learn it); the counts go
straight into the int32 state with atomics, IN PLACE -- there are no
delta buffers (the reference returns f32 deltas that the caller adds);
one thread per record loads and folds it once and issues every
Count-Min add (L2-resident global atomics) and every entropy add (into a
block's copy of the 4 entropy rows in shared memory, merged once per
block, or for batches of at most 8192 records and for entropy rows too
wide for shared memory straight into the state).

Both wrappers update `cms_counts` and `ent_hist` in place and return
nothing. The result equals the reference's `_advance_sketches` given the
Pallas deltas: state + delta, exact (int32 atomics never round).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from deepflow_tpu_torch.ops import _build
from deepflow_tpu_torch.ops.hashing import bucket, multi_bucket
from deepflow_tpu_torch.utils.u32 import as_u32, fold_columns

ENT_FEATURES = 4
_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 2
         + [ctypes.c_void_p] * 3)
_SIGNATURES = {"df_fused_lane_hists": _ARGS, "df_fused_news_hists": _ARGS}


def _log2(width: int) -> int:
    lw = int(width).bit_length() - 1
    if width != 1 << lw:
        raise ValueError(f"width {width} is not a power of two")
    return lw


def _check(plane, rows, n, cms_counts, ent_hist, cms_seeds, ent_seeds,
           weight_planes):
    dev = plane.device
    if plane.dim() != 2 or plane.shape[0] != rows or plane.dtype != torch.int32:
        raise ValueError(f"plane must be ({rows}, C) int32 u32 bits, got "
                         f"{tuple(plane.shape)} {plane.dtype}")
    for name, t in (("cms_counts", cms_counts), ("ent_hist", ent_hist),
                    ("cms_seeds", cms_seeds), ("ent_seeds", ent_seeds)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.device != dev:
            raise ValueError(f"{name} must be a 2-d int32 tensor on {dev}")
    d = cms_counts.shape[0]
    if tuple(cms_seeds.shape) != (d, 2):
        raise ValueError(f"cms_seeds must be [{d}, 2]")
    if ent_hist.shape[0] != ENT_FEATURES or \
            tuple(ent_seeds.shape) != (ENT_FEATURES, 2):
        raise ValueError(f"entropy state must have {ENT_FEATURES} rows")
    if isinstance(n, torch.Tensor) and (n.numel() != 1 or n.device != dev):
        raise ValueError(f"n must be one element on {dev}")
    if not 1 <= weight_planes <= 3:
        raise ValueError(f"weight_planes {weight_planes} not in 1..3")
    return _log2(cms_counts.shape[1]), _log2(ent_hist.shape[1])


def _hists_plain(cols, pkts, n, cms_counts, ent_hist, cms_seeds, ent_seeds,
                 weight_planes):
    """The shared histogram half of both plain versions (u32 columns)."""
    cms_lw, ent_lw = _log2(cms_counts.shape[1]), _log2(ent_hist.shape[1])
    C = cols[0].shape[0]
    dev = cms_counts.device
    valid = torch.arange(C, device=dev) < torch.as_tensor(n, device=dev) \
        .reshape(()).to(torch.int64)
    fkey = fold_columns(cols)
    d, cw = cms_counts.shape
    idx = multi_bucket(fkey, cms_seeds, cms_lw).to(torch.int64)
    idx = idx + torch.arange(d, device=dev)[:, None] * cw
    cms_counts.view(-1).index_add_(
        0, idx.reshape(-1), valid.to(torch.int32).expand(d, C).reshape(-1))
    wmax = 256 ** weight_planes - 1
    wm = (torch.clamp(pkts, max=wmax) & wmax).to(torch.int32) \
        * valid.to(torch.int32)
    f, ew = ent_hist.shape
    feats = torch.stack(cols[:ENT_FEATURES])
    eidx = bucket(feats, ent_seeds[:, 0:1], ent_seeds[:, 1:2], ent_lw)
    eidx = eidx.to(torch.int64) + torch.arange(f, device=dev)[:, None] * ew
    ent_hist.view(-1).index_add_(0, eidx.reshape(-1),
                                 wm.expand(f, C).reshape(-1))


def fused_lane_hists_plain(plane, n, cms_counts, ent_hist, cms_seeds,
                           ent_seeds, weight_planes: int = 2) -> None:
    """Plain version of the lane kernel: (4, C) lane plane -> in-place adds."""
    _check(plane, 4, n, cms_counts, ent_hist, cms_seeds, ent_seeds,
           weight_planes)
    w = as_u32(plane)
    cols = (w[0], w[1], w[2] >> 16, w[2] & 0xFFFF, w[3] >> 24)
    _hists_plain(cols, w[3] & 0xFFFFFF, n, cms_counts, ent_hist, cms_seeds,
                 ent_seeds, weight_planes)


def fused_news_hists_plain(plane, n, cms_counts, ent_hist, cms_seeds,
                           ent_seeds, weight_planes: int = 2) -> None:
    """Plain version of the news kernel: (6, C) news plane -> in-place adds."""
    _check(plane, 6, n, cms_counts, ent_hist, cms_seeds, ent_seeds,
           weight_planes)
    w = as_u32(plane)
    cols = (w[1], w[2], w[3] >> 16, w[3] & 0xFFFF, w[4] & 0xFF)
    _hists_plain(cols, w[5] & 0xFFFFFF, n, cms_counts, ent_hist, cms_seeds,
                 ent_seeds, weight_planes)


def _launch(fn_name, rows, plane, n, cms_counts, ent_hist, cms_seeds,
            ent_seeds, weight_planes):
    cms_lw, ent_lw = _check(plane, rows, n, cms_counts, ent_hist, cms_seeds,
                            ent_seeds, weight_planes)
    dev = plane.device
    if dev.type != "cuda":
        raise ValueError(f"{fn_name} needs CUDA tensors, got {dev}")
    if not isinstance(n, torch.Tensor):
        n = torch.tensor([int(n)], dtype=torch.int32, device=dev)
    if n.dtype != torch.int32:
        raise ValueError("n must be int32 (u32 bits)")
    for t in (plane, n, cms_counts, ent_hist, cms_seeds, ent_seeds):
        if not t.is_contiguous():
            raise ValueError(f"{fn_name} needs contiguous tensors")
    fn = _build.function("fused_sketch", fn_name, _SIGNATURES)
    err = fn(plane.data_ptr(), plane.shape[1], n.data_ptr(),
             cms_seeds.data_ptr(), cms_counts.shape[0], cms_lw,
             ent_seeds.data_ptr(), ent_lw, 256 ** weight_planes - 1,
             cms_counts.data_ptr(), ent_hist.data_ptr(),
             _build.stream_handle(dev))
    _build.check(err, fn_name)


def fused_lane_hists_cuda(plane, n, cms_counts, ent_hist, cms_seeds,
                          ent_seeds, weight_planes: int = 2) -> None:
    """Launch the lane kernel; adds into the state in place. `n` is a
    one-element int32 device tensor (or a host int, copied over)."""
    _launch("df_fused_lane_hists", 4, plane, n, cms_counts, ent_hist,
            cms_seeds, ent_seeds, weight_planes)
    fused_lane_hists_cuda.launches += 1


def fused_news_hists_cuda(plane, n, cms_counts, ent_hist, cms_seeds,
                          ent_seeds, weight_planes: int = 2) -> None:
    """Launch the news kernel; adds into the state in place."""
    _launch("df_fused_news_hists", 6, plane, n, cms_counts, ent_hist,
            cms_seeds, ent_seeds, weight_planes)
    fused_news_hists_cuda.launches += 1


fused_lane_hists_cuda.launches = 0
fused_news_hists_cuda.launches = 0


# While a CUDA graph capture splits a program at the hand kernels
# (runtime/wire_graphs.py), the capturing thread's launches go to its
# hook instead of to the stream.
_split = threading.local()


@contextlib.contextmanager
def split_launches(hook):
    """Hand every `fused_lane_hists`/`fused_news_hists` call made on this
    thread inside the block to `hook(fn, args)` instead of launching it:
    a graph capture ends its segment there, and its replay makes the
    call from the host."""
    _split.hook = hook
    try:
        yield
    finally:
        _split.hook = None


def _split_off(fn, args) -> bool:
    hook = getattr(_split, "hook", None)
    if hook is None:
        return False
    hook(fn, args)
    return True


def _dispatch(cuda_fn, plain_fn, plane, *args, **kw) -> None:
    if plane.device.type == "cuda":
        return cuda_fn(plane, *args, **kw)
    if plane.device.type == "cpu":
        return plain_fn(plane, *args, **kw)
    raise ValueError(f"unsupported device {plane.device}")


def fused_lane_hists(plane, n, cms_counts, ent_hist, cms_seeds, ent_seeds,
                     weight_planes: int = 2) -> None:
    """(4, C) lane plane + valid count n -> Count-Min and entropy counts
    added IN PLACE into `cms_counts` [d, 2^cms_lw] and `ent_hist`
    [4, 2^ent_lw]. The kernel for CUDA tensors, the plain version for
    CPU ones."""
    args = (plane, n, cms_counts, ent_hist, cms_seeds, ent_seeds,
            weight_planes)
    if _split_off(fused_lane_hists, args):
        return
    _dispatch(fused_lane_hists_cuda, fused_lane_hists_plain, plane, n,
              cms_counts, ent_hist, cms_seeds, ent_seeds, weight_planes)


def fused_news_hists(plane, n, cms_counts, ent_hist, cms_seeds, ent_seeds,
                     weight_planes: int = 2) -> None:
    """(6, C) dict-wire news plane; otherwise as `fused_lane_hists`."""
    args = (plane, n, cms_counts, ent_hist, cms_seeds, ent_seeds,
            weight_planes)
    if _split_off(fused_news_hists, args):
        return
    _dispatch(fused_news_hists_cuda, fused_news_hists_plain, plane, n,
              cms_counts, ent_hist, cms_seeds, ent_seeds, weight_planes)
