"""Bytes and operations of one launch of a fused sketch kernel (the lane
and news kernels of csrc/fused_sketch.cu): each valid record's plane
words read once, the valid count's word read once, and each sector of
the Count-Min and entropy state that the records change read and
written once. Records at or past the valid count cost nothing.

Operations, counted from the kernel's source (`hist_body`,
`load_record`), one for each 32-bit ALU operation or atomic add a record
makes: mix32 is 8 (three shift-xors, two multiplies); a fold step 14
(an add of the golden constant, a shift and add each way, the xor, then
mix32), five of them 70; a bucket 11 (the salt's xor, mix32, the
multiply, the shift), and with its address (shift, add) and the atomic
add 14, four Count-Min rows and four entropy features 112; the weight
3 (min, and, the zero test); the unpack 4; the loop 2. 191 in all."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from reference import hashing as H
from reference.l4_sketch import Sizes
from rooflines.sectors import touched_bytes

OPS_PER_RECORD = 5 * 14 + 8 * 14 + 3 + 4 + 2
WEIGHT_MAX = 0xFFFF       # two weight planes


def capture(args, kwargs) -> Tuple:
    """What a launch's bytes follow from: its plane and valid count
    (device tensors, held until the traced slice ends)."""
    return args[0], args[1]


def to_host(rec) -> Tuple[np.ndarray, int]:
    plane, n = rec
    n = int(n.reshape(-1)[0].item()) if hasattr(n, "reshape") else int(n)
    return plane.cpu().numpy().view(np.uint32), n


def cost(cols, pkts: np.ndarray, rows: int, n: int,
         suite: Dict) -> Tuple[int, int]:
    """(bytes, operations) of a launch over n valid records whose
    unpacked 5-tuple columns are `cols` and packet weights `pkts`."""
    sz = Sizes(suite)
    keys = H.fold(cols)
    w = 1 << sz.cms_lw
    cms = np.concatenate([H.bucket(keys, int(sz.cms_seeds[d, 0]),
                                   int(sz.cms_seeds[d, 1]), sz.cms_lw)
                          + d * w for d in range(sz.depth)])
    b = 1 << sz.ent_lw
    wt = np.minimum(pkts.astype(np.int64), WEIGHT_MAX)
    ent = []
    for f in range(4):
        idx = H.bucket(cols[f], int(sz.ent_seeds[f, 0]),
                       int(sz.ent_seeds[f, 1]), sz.ent_lw) + f * b
        tot = np.bincount(idx, weights=wt.astype(np.float64),
                          minlength=4 * b)
        ent.append(np.nonzero(tot)[0])
    nbytes = rows * 4 * n + 4 + touched_bytes(cms, np.concatenate(ent))
    return nbytes, OPS_PER_RECORD * n
