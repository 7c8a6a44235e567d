"""Roofline of the news kernel (`fused_hists_kernel<true, ...>`,
csrc/fused_sketch.cu): one (6, C) news plane of index, ip_src, ip_dst,
port_src<<16|port_dst, the raw proto byte and packets."""

from __future__ import annotations

import numpy as np

from rooflines import fused_common as F

TARGET = ("deepflow_tpu_torch.ops.cuda_sketch", "fused_news_hists_cuda")
KERNEL = r"fused_hists_kernel<\s*true"
capture = F.capture


def cost(rec, config: dict):
    w, n = F.to_host(rec)
    w = w[:, :n]
    cols = [w[1], w[2], w[3] >> np.uint32(16), w[3] & np.uint32(0xFFFF),
            w[4] & np.uint32(0xFF)]
    return F.cost(cols, w[5] & np.uint32(0xFFFFFF), 6, n,
                  config["flow_suite"])
