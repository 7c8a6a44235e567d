"""The flow_metrics Document schema (METRIC_SCHEMA): the decoded,
columnar form of the agent's 1 s metrics Documents, as the flow_metrics
pipeline hands it to the exporters and the store.

A copy of the JAX package's batch/schema.py METRIC_SCHEMA (this package
imports none of it); the store table generated from the tag-Code model
(`pipelines/schemas.py` METRICS_TABLE) is checked against it column for
column at import.
"""

from __future__ import annotations

import numpy as np

from deepflow_tpu_torch.batch.batcher import Schema

_U32 = np.dtype(np.uint32)
_I32 = np.dtype(np.int32)
_U64 = np.dtype(np.uint64)

# Full zerodoc tag+meter model (reference: server/libs/zerodoc — MiniTag
# dimensions :basic_tag.go, FlowMeter = Traffic+Latency+Performance+
# Anomaly :basic_meter.go, AppMeter :app_meter.go). String dimensions are
# u32 dictionary hashes like everywhere else.
METRIC_SCHEMA = Schema(
    name="flow_metrics",
    columns=(
        ("timestamp", _U32),
        # tag dimensions. tag_code is the zerodoc Code bitmask (tag.go
        # :36-95): WHICH dimensions this Document's tag carries — part
        # of grouping identity, so Documents tagged over different
        # dimension sets never merge (the reference's per-Code tables)
        ("tag_code", _U64),
        ("ip", _U32),
        ("server_port", _U32),
        ("vtap_id", _U32),
        ("protocol", _U32),
        ("l3_epc_id", _I32),
        ("direction", _U32),
        ("tap_side", _U32),
        ("tap_type", _U32),
        ("tap_port", _U32),
        ("l7_protocol", _U32),
        ("gprocess_id", _U32),
        ("signal_source", _U32),
        ("pod_id", _U32),
        ("app_service_hash", _U32),
        ("endpoint_hash", _U32),
        # traffic
        ("packet_tx", _U32),
        ("packet_rx", _U32),
        ("byte_tx", _U32),
        ("byte_rx", _U32),
        ("l3_byte_tx", _U32),
        ("l3_byte_rx", _U32),
        ("l4_byte_tx", _U32),
        ("l4_byte_rx", _U32),
        ("new_flow", _U32),
        ("closed_flow", _U32),
        ("l7_request", _U32),
        ("l7_response", _U32),
        ("syn", _U32),
        ("synack", _U32),
        # latency
        ("rtt_sum", _U32),
        ("rtt_count", _U32),
        ("rtt_max", _U32),
        ("rtt_client_sum", _U32),
        ("rtt_client_count", _U32),
        ("rtt_server_sum", _U32),
        ("rtt_server_count", _U32),
        ("srt_sum", _U32),
        ("srt_count", _U32),
        ("srt_max", _U32),
        ("art_sum", _U32),
        ("art_count", _U32),
        ("art_max", _U32),
        ("rrt_sum", _U32),
        ("rrt_count", _U32),
        ("rrt_max", _U32),
        ("cit_sum", _U32),
        ("cit_count", _U32),
        ("cit_max", _U32),
        # performance
        ("retrans_tx", _U32),
        ("retrans_rx", _U32),
        ("zero_win_tx", _U32),
        ("zero_win_rx", _U32),
        ("retrans_syn", _U32),
        ("retrans_synack", _U32),
        # anomaly
        ("client_rst_flow", _U32),
        ("server_rst_flow", _U32),
        ("client_syn_repeat", _U32),
        ("server_synack_repeat", _U32),
        ("client_half_close_flow", _U32),
        ("server_half_close_flow", _U32),
        ("tcp_timeout", _U32),
        ("l7_client_error", _U32),
        ("l7_server_error", _U32),
        ("l7_timeout", _U32),
    ),
)
