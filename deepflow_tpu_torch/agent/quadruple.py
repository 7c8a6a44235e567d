"""Quadruple generator: flow output -> 1s metric Documents.

Reference: agent/src/collector/quadruple_generator.rs folds TaggedFlows
into per-(ip, server_port, protocol) 1s/1m Document meters via
per-thread stashes. Here the fold is one segment reduction over the
tick's flow columns — the same aggregation primitive as everywhere else
— keyed server-side (the ip column is the service endpoint, matching
the reference's single-side 'port' table).

A copy of the JAX package's `agent/quadruple.py` whose rollup runs
through the port's `store/rollup.group_reduce` on `device` (CUDA unless
the caller names the CPU, with no fallback). Its `ip` key is cast to
int64, so it takes the host-lexsort path in both packages: group ids
from a host lexsort, the meters reduced on the device, one copy of the
reduced block back per call.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from deepflow_tpu_torch.agent.flow_map import CLOSE_FIN, CLOSE_RST
from deepflow_tpu_torch.models.flow_suite import check_device
from deepflow_tpu_torch.store.rollup import group_reduce
from deepflow_tpu_torch.wire.gen import metric_pb2


def flows_to_documents(cols: Dict[str, np.ndarray], second: int, *,
                       device="cuda") -> Dict[str, np.ndarray]:
    """Aggregate tick flow columns into METRIC_SCHEMA-shaped columns,
    reduced on `device`."""
    device = check_device(device)
    n = len(cols["ip_dst"])
    if n == 0:
        return {}
    # first-ever report of the flow only — a forced re-report each second
    # must not look like a new connection (reference: is_new_flow flag)
    is_new = cols["is_new_flow"] > 0
    closed = np.isin(cols["close_type"], (CLOSE_FIN, CLOSE_RST))
    work = {
        "ip": cols["ip_dst"].astype(np.int64),
        "server_port": cols["port_dst"].astype(np.int64),
        "protocol": cols["proto"].astype(np.int64),
        "vtap_id": cols["vtap_id"].astype(np.int64),
        "packet_tx": cols["packet_tx"].astype(np.int64),
        "packet_rx": cols["packet_rx"].astype(np.int64),
        "byte_tx": cols["byte_tx"].astype(np.int64),
        "byte_rx": cols["byte_rx"].astype(np.int64),
        "new_flow": is_new.astype(np.int64),
        "closed_flow": closed.astype(np.int64),
        "retrans": cols["retrans"].astype(np.int64),
        "rtt_sum": cols["rtt"].astype(np.int64),
        "rtt_count": (cols["rtt"] > 0).astype(np.int64),
    }
    # TCP perf engine columns (tcp_perf.py) fold straight into the
    # Document meter: per-flow window sums are sum-mergeable, maxes are
    # max-mergeable (zerodoc FlowMeter merge discipline)
    sums = ["packet_tx", "packet_rx", "byte_tx", "byte_rx", "new_flow",
            "closed_flow", "retrans", "rtt_sum", "rtt_count"]
    maxes: list = []
    for name in ("srt_sum", "srt_count", "art_sum", "art_count",
                 "cit_sum", "cit_count", "rtt_client_sum",
                 "rtt_client_count", "rtt_server_sum", "rtt_server_count",
                 "zero_win_tx", "zero_win_rx", "retrans_tx", "retrans_rx",
                 "retrans_syn", "retrans_synack", "syn", "synack"):
        src = {"syn": "syn_count", "synack": "synack_count"}.get(name, name)
        if src in cols:
            work[name] = cols[src].astype(np.int64)
            sums.append(name)
    for name in ("srt_max", "art_max", "cit_max", "rtt_client_max",
                 "rtt_server_max"):
        src = {"rtt_client_max": "rtt_client",
               "rtt_server_max": "rtt_server"}.get(name, name)
        if src in cols:
            work[name] = cols[src].astype(np.int64)
            maxes.append(name)
    aggs = {k: "sum" for k in sums}
    aggs.update({k: "max" for k in maxes})
    red = group_reduce(
        work, ["ip", "server_port", "protocol", "vtap_id"], aggs,
        device=device)
    red["timestamp"] = np.full(len(red["ip"]), second, np.int64)
    return red


def documents_to_records(doc_cols: Dict[str, np.ndarray]) -> List[bytes]:
    """Serialize aggregated rows as wire Document records
    (message/metric.proto shape; decode side:
    decode/columnar.decode_metric_records)."""
    out: List[bytes] = []
    if not doc_cols:
        return out
    # zerodoc Code bitmask for the dimension set this generator tags
    # over: IP | Protocol | ServerPort | VTAPID (tag.go:36-95 bit
    # layout) — receivers group per code, so documents with different
    # dimension sets never merge
    code = (0x1            # IP
            | (1 << 42)    # Protocol
            | (1 << 43)    # ServerPort
            | (1 << 47))   # VTAPID
    for i in range(len(doc_cols["ip"])):
        d = metric_pb2.Document()
        d.timestamp = int(doc_cols["timestamp"][i])
        d.tag.code = code
        fld = d.tag.field
        fld.ip = int(doc_cols["ip"][i]).to_bytes(4, "big")
        fld.server_port = int(doc_cols["server_port"][i])
        fld.vtap_id = int(doc_cols["vtap_id"][i])
        fld.protocol = int(doc_cols["protocol"][i])
        t = d.meter.flow.traffic
        t.packet_tx = int(doc_cols["packet_tx"][i])
        t.packet_rx = int(doc_cols["packet_rx"][i])
        t.byte_tx = int(doc_cols["byte_tx"][i])
        t.byte_rx = int(doc_cols["byte_rx"][i])
        t.new_flow = int(doc_cols["new_flow"][i])
        t.closed_flow = int(doc_cols["closed_flow"][i])
        p = d.meter.flow.performance
        if "retrans_tx" in doc_cols:
            p.retrans_tx = int(doc_cols["retrans_tx"][i])
            p.retrans_rx = int(doc_cols["retrans_rx"][i])
        else:
            p.retrans_tx = int(doc_cols["retrans"][i])
        for name in ("zero_win_tx", "zero_win_rx", "retrans_syn",
                     "retrans_synack"):
            if name in doc_cols:
                setattr(p, name, int(doc_cols[name][i]))
        lat = d.meter.flow.latency
        lat.rtt_sum = int(doc_cols["rtt_sum"][i])
        lat.rtt_count = int(doc_cols["rtt_count"][i])
        for name in ("srt_sum", "srt_count", "srt_max", "art_sum",
                     "art_count", "art_max", "cit_sum", "cit_count",
                     "cit_max", "rtt_client_sum", "rtt_client_count",
                     "rtt_client_max", "rtt_server_sum",
                     "rtt_server_count", "rtt_server_max"):
            if name in doc_cols:
                setattr(lat, name, int(doc_cols[name][i]))
        out.append(d.SerializeToString())
    return out
