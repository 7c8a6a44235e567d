"""Roofline of the lane kernel (`fused_hists_kernel<false, ...>`,
csrc/fused_sketch.cu): one (4, C) lane plane of ip_src, ip_dst,
port_src<<16|port_dst and proto<<24|packets."""

from __future__ import annotations

import numpy as np

from rooflines import fused_common as F

TARGET = ("deepflow_tpu_torch.ops.cuda_sketch", "fused_lane_hists_cuda")
KERNEL = r"fused_hists_kernel<\s*false"
capture = F.capture


def cost(rec, config: dict):
    w, n = F.to_host(rec)
    w = w[:, :n]
    cols = [w[0], w[1], w[2] >> np.uint32(16), w[2] & np.uint32(0xFFFF),
            w[3] >> np.uint32(24)]
    return F.cost(cols, w[3] & np.uint32(0xFFFFFF), 4, n,
                  config["flow_suite"])
