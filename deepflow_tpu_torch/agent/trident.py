"""The agent's tick on the wire: flow columns -> L4_SCHEMA planar
columns and TaggedFlow records.

A copy of the wire half of the JAX package's `agent/trident.py`
(`columns_to_l4_schema`, `columns_to_l4_records`): what the agent's 1 s
tick ships of `FlowMap.tick_columns`' output, as the COLUMNAR_FLOW
payload or as TAGGEDFLOW protobuf records. The `Agent` orchestrator
(capture front, controller sync, L7 sessions, the senders' wiring) is
not ported.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from deepflow_tpu_torch.batch.schema import L4_SCHEMA
from deepflow_tpu_torch.wire.gen import flow_log_pb2

__all__ = ["columns_to_l4_schema", "columns_to_l4_records"]


def columns_to_l4_schema(cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Vectorized tick-columns -> L4_SCHEMA planar columns, the payload of
    the columnar wire mode. Matches the server decoders' unit contract
    (timestamp s, duration us, 4-byte planes) without any per-row work."""
    out: Dict[str, np.ndarray] = {}
    for name, dt in L4_SCHEMA.columns:
        if name == "timestamp":
            out[name] = (cols["start_time"]
                         // np.uint64(1_000_000_000)).astype(dt)
        elif name == "duration_us":
            out[name] = np.minimum(cols["duration"] // np.uint64(1000),
                                   np.uint64(0xFFFFFFFF)).astype(dt)
        elif name in cols:
            out[name] = cols[name].astype(dt, copy=False)
        else:
            out[name] = np.zeros(len(cols["ip_src"]), dt)
    return out


def columns_to_l4_records(cols: Dict[str, np.ndarray]) -> List[bytes]:
    """Serialize tick flow columns as TaggedFlow wire records."""
    out: List[bytes] = []
    for i in range(len(cols["ip_src"])):
        m = flow_log_pb2.TaggedFlow()
        f = m.flow
        k = f.flow_key
        k.vtap_id = int(cols["vtap_id"][i])
        k.ip_src = int(cols["ip_src"][i])
        k.ip_dst = int(cols["ip_dst"][i])
        k.port_src = int(cols["port_src"][i])
        k.port_dst = int(cols["port_dst"][i])
        k.proto = int(cols["proto"][i])
        src = f.metrics_peer_src
        src.byte_count = int(cols["byte_tx"][i])
        src.packet_count = int(cols["packet_tx"][i])
        src.l3_epc_id = int(cols["l3_epc_id"][i])
        dst = f.metrics_peer_dst
        dst.byte_count = int(cols["byte_rx"][i])
        dst.packet_count = int(cols["packet_rx"][i])
        f.flow_id = int(cols["flow_id"][i])
        f.start_time = int(cols["start_time"][i])
        f.duration = int(cols["duration"][i])
        f.end_time = f.start_time + f.duration
        f.close_type = int(cols["close_type"][i])
        f.tap_side = int(cols["tap_side"][i])
        f.is_new_flow = int(cols["is_new_flow"][i])
        f.eth_type = 0x0800
        has_perf = cols["rtt"][i] or cols["retrans"][i]
        if not has_perf:
            # any engine signal warrants the stats block: a mid-stream
            # capture can have zero-window/CIT/continuous-RTT data with
            # no handshake rtt and no retransmissions
            for name in ("srt_count", "art_count", "cit_count",
                         "zero_win_tx", "zero_win_rx", "syn_count",
                         "synack_count", "rtt_client", "rtt_server"):
                if name in cols and cols[name][i]:
                    has_perf = True
                    break
        if has_perf:
            f.has_perf_stats = 1
            f.perf_stats.l4_protocol = 1
            t = f.perf_stats.tcp
            t.rtt = int(cols["rtt"][i])
            t.total_retrans_count = int(cols["retrans"][i])
            for name in ("srt_sum", "srt_count", "srt_max", "art_sum",
                         "art_count", "art_max", "cit_sum", "cit_count",
                         "cit_max", "syn_count", "synack_count"):
                if name in cols:
                    setattr(t, name, int(cols[name][i]))
            if "rtt_client" in cols:
                t.rtt_client_max = int(cols["rtt_client"][i])
                t.rtt_server_max = int(cols["rtt_server"][i])
                t.counts_peer_tx.retrans_count = int(cols["retrans_tx"][i])
                t.counts_peer_rx.retrans_count = int(cols["retrans_rx"][i])
                t.counts_peer_tx.zero_win_count = \
                    int(cols["zero_win_tx"][i])
                t.counts_peer_rx.zero_win_count = \
                    int(cols["zero_win_rx"][i])
        out.append(m.SerializeToString())
    return out
