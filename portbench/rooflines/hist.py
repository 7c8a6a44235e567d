"""Roofline of the histogram kernel (`hist_smem_kernel`,
`hist_global_kernel`, csrc/hist.cu), as chip_smoke's phase 2 counts it:
the [d, n] int32 indices, the [n] bool mask and the [n] int32 weights
read once, and each sector of the [d, width] state holding a cell that
the launch changed read and written once (indices clamp into the row;
a masked-out lane, or one whose saturated weight is 0, changes
nothing). Operations, counted from the kernel's source (`clamp_bin`,
`Weights`, `add_quad`), ten an item: the clamp 4 (two compares, two
selects), the weight 3 (the mask test, min, and), the non-zero test,
the address and the atomic add."""

from __future__ import annotations

import numpy as np

from rooflines.sectors import touched_bytes

TARGET = ("deepflow_tpu_torch.ops.cuda_hist", "hist_add_cuda")
KERNEL = r"hist_(smem|global)_kernel"
OPS_PER_ITEM = 4 + 3 + 1 + 1 + 1


def capture(args, kwargs):
    names = ("acc", "idx", "width", "weights", "mask", "weight_planes")
    a = dict(zip(names, args))
    a.update(kwargs)
    return (a["idx"], a.get("weights"), a.get("mask"), int(a["width"]),
            int(a.get("weight_planes", 2)))


def cost(rec, config: dict):
    idx, weights, mask, width, planes = rec
    idx = idx.cpu().numpy().astype(np.int64)
    d, n = idx.shape
    if n == 0:
        return 0, 0
    wmax = 256 ** planes - 1
    if weights is None:
        wt = np.ones(n, np.int64)
    else:
        wt = np.minimum(weights.cpu().numpy().astype(np.int64), wmax) & wmax
    live = wt != 0
    if mask is not None:
        live &= mask.cpu().numpy().astype(bool)
    cells = (np.clip(idx, 0, width - 1)
             + np.arange(d)[:, None] * width)[:, live]
    nbytes = idx.size * 4 + (0 if mask is None else n) \
        + (0 if weights is None else 4 * n) + touched_bytes(cells.ravel())
    return nbytes, OPS_PER_ITEM * idx.size
