"""The decoded columnar schemas: L4_SCHEMA (104 columns of the
reference's l4_flow_log families), L7_SCHEMA (73 columns of l7_flow_log)
and METRIC_SCHEMA (the agent's 1 s metrics Documents), as the decoders
hand them to the exporters and the store.

Copies of the JAX package's batch/schema.py schemas (this package imports
none of it). Strings travel as u32 content hashes, IPv6 addresses fold to
u32 at decode with `is_ipv6` set, and true 64-bit identities keep u64
columns at each schema's tail. The store tables generated from them
(`pipelines/schemas.py`) are checked against them column for column at
import.
"""

from __future__ import annotations

import numpy as np

from deepflow_tpu_torch.batch.batcher import Schema

_U32 = np.dtype(np.uint32)
_I32 = np.dtype(np.int32)
_U64 = np.dtype(np.uint64)

# -- L4 flow log -----------------------------------------------------------
# The first 17 columns are the original core set (and the sketch-kernel
# input contract); families follow in reference order. u64 columns sit at
# the tail (one u32 plane block, then one u64 plane block).

_L4_CORE = (
    ("ip_src", _U32),
    ("ip_dst", _U32),
    ("port_src", _U32),
    ("port_dst", _U32),
    ("proto", _U32),
    ("vtap_id", _U32),
    ("tap_side", _U32),
    ("l3_epc_id", _I32),          # src-side epc (reference l3_epc_id_0)
    ("byte_tx", _U32),
    ("byte_rx", _U32),
    ("packet_tx", _U32),
    ("packet_rx", _U32),
    ("rtt", _U32),
    ("retrans", _U32),
    ("close_type", _U32),
    ("timestamp", _U32),          # start_time ns -> s
    ("duration_us", _U32),
)

_L4_DATALINK = (                  # l4_flow_log.go DataLinkLayer :57
    ("eth_type", _U32),
    ("vlan", _U32),
)

_L4_NETWORK = (                   # NetworkLayer tunnel block :79
    ("is_ipv6", _U32),
    ("tunnel_tier", _U32),
    ("tunnel_type", _U32),
    ("tunnel_tx_id", _U32),
    ("tunnel_rx_id", _U32),
    ("tunnel_tx_ip_0", _U32),
    ("tunnel_tx_ip_1", _U32),
    ("tunnel_rx_ip_0", _U32),
    ("tunnel_rx_ip_1", _U32),
)

_L4_TRANSPORT = (                 # TransportLayer :166
    ("tcp_flags_bit_0", _U32),
    ("tcp_flags_bit_1", _U32),
    ("syn_seq", _U32),
    ("synack_seq", _U32),
    ("last_keepalive_seq", _U32),
    ("last_keepalive_ack", _U32),
)

_L4_APP = (                       # ApplicationLayer :199
    ("l7_protocol", _U32),
)

_L4_INTERNET = (                  # Internet :~330 (geo, dict-hashed)
    ("province_0", _U32),
    ("province_1", _U32),
)

_L4_FLOWINFO = (                  # FlowInfo :363
    ("l3_epc_id_1", _I32),        # dst-side epc
    ("signal_source", _U32),
    ("tap_type", _U32),
    ("tap_port", _U32),
    ("tap_port_type", _U32),
    ("is_new_flow", _U32),
    ("is_active_service", _U32),
    ("l2_end_0", _U32),
    ("l2_end_1", _U32),
    ("l3_end_0", _U32),
    ("l3_end_1", _U32),
    ("direction_score", _U32),
    ("gprocess_id_0", _U32),
    ("gprocess_id_1", _U32),
    ("nat_real_ip_0", _U32),
    ("nat_real_ip_1", _U32),
    ("nat_real_port_0", _U32),
    ("nat_real_port_1", _U32),
    ("nat_source", _U32),
    # LogMessageStatus derived from close_type (l4_flow_log.go getStatus
    # :857): 0 ok / 2 not-exist / 3 server-error (this framework's
    # 4-value close enum has no client/server RST split, so RSTs land
    # server-side — the common mid-session attribution)
    ("status", _U32),
    # reference: Array(UInt16) of PCAP policy ACL gids; columnar image
    # is the FIRST gid (0 = none) — multi-policy hits keep the earliest
    ("acl_gids", _U32),
)

_L4_METRICS = (                   # Metrics :466
    ("l3_byte_tx", _U32),
    ("l3_byte_rx", _U32),
    ("l4_byte_tx", _U32),
    ("l4_byte_rx", _U32),
    ("total_byte_tx", _U32),
    ("total_byte_rx", _U32),
    ("total_packet_tx", _U32),
    ("total_packet_rx", _U32),
    ("l7_request", _U32),
    ("l7_response", _U32),
    ("l7_parse_failed", _U32),
    ("l7_client_error", _U32),
    ("l7_server_error", _U32),
    ("l7_server_timeout", _U32),
    ("rtt_client", _U32),         # us (max over window)
    ("rtt_server", _U32),
    ("tls_rtt", _U32),
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
    ("retrans_tx", _U32),
    ("retrans_rx", _U32),
    ("zero_win_tx", _U32),
    ("zero_win_rx", _U32),
    ("syn_count", _U32),
    ("synack_count", _U32),
    # derived at ingest exactly like the reference (l4_flow_log.go:960):
    # handshake repeats counted as retransmissions
    ("retrans_syn", _U32),
    ("retrans_synack", _U32),
    ("l7_error", _U32),           # client + server errors (:926)
)

_L4_WIDE64 = (                    # true 64-bit identities, tail block
    ("mac_src", _U64),
    ("mac_dst", _U64),
    ("flow_id", _U64),
    ("start_time_us", _U64),
    ("end_time_us", _U64),
    # outer tunnel endpoint MACs (reference tunnel_tx_mac_0/1 + rx pairs
    # carry each MAC as two u32 halves; one u64 column each here)
    ("tunnel_tx_mac", _U64),
    ("tunnel_rx_mac", _U64),
    # row id stamped at ingest: time<<32 | analyzer<<22 | counter
    # (l4_flow_log.go genID :1040)
    ("_id", _U64),
)

L4_SCHEMA = Schema(
    name="l4_flow_log",
    columns=(_L4_CORE + _L4_DATALINK + _L4_NETWORK + _L4_TRANSPORT
             + _L4_APP + _L4_INTERNET + _L4_FLOWINFO + _L4_METRICS
             + _L4_WIDE64),
)

# -- L7 flow log -----------------------------------------------------------
# Reference: log_data/l7_flow_log.go L7Base + L7FlowLog :187-286. String
# fields are *_hash u32 dictionary codes; nullable wire fields use 0 as
# the null image (the store has no null concept, same as SmartEncoding
# dropping Nullable for dictionary codes).

_L7_CORE = (
    ("ip_src", _U32),
    ("ip_dst", _U32),
    ("port_src", _U32),
    ("port_dst", _U32),
    ("protocol", _U32),           # transport proto
    ("l7_protocol", _U32),        # AppProtoHead.proto
    ("msg_type", _U32),           # 0 request / 1 response / 2+ session
    ("vtap_id", _U32),
    ("endpoint_hash", _U32),      # hashed req endpoint string
    ("status", _U32),
    ("rrt_us", _U32),
    ("req_len", _I32),
    ("resp_len", _I32),
    ("timestamp", _U32),
)

_L7_WIDE = (
    ("l3_epc_id_0", _I32),
    ("l3_epc_id_1", _I32),
    ("tap_side", _U32),
    ("tap_type", _U32),
    ("tap_port", _U32),
    ("tap_port_type", _U32),
    ("is_ipv6", _U32),
    ("is_tls", _U32),
    ("version_hash", _U32),
    ("request_type_hash", _U32),
    ("request_domain_hash", _U32),
    ("request_resource_hash", _U32),
    ("request_id", _U32),
    ("response_code", _I32),
    ("response_exception_hash", _U32),
    ("response_result_hash", _U32),
    ("trace_id_hash", _U32),
    ("span_id_hash", _U32),
    ("parent_span_id_hash", _U32),
    ("x_request_id_0_hash", _U32),
    ("x_request_id_1_hash", _U32),
    ("http_proxy_client_hash", _U32),
    ("app_service_hash", _U32),
    ("app_instance_hash", _U32),
    ("user_agent_hash", _U32),
    ("referer_hash", _U32),
    ("process_id_0", _U32),
    ("process_id_1", _U32),
    ("gprocess_id_0", _U32),
    ("gprocess_id_1", _U32),
    ("pod_id_0", _U32),
    ("pod_id_1", _U32),
    ("req_tcp_seq", _U32),
    ("resp_tcp_seq", _U32),
    ("sql_affected_rows", _U32),
    ("direction_score", _U32),
    ("signal_source", _U32),
    # l7_flow_log.go L7Base/L7FlowLog tail parity
    ("nat_source", _U32),
    ("tunnel_type", _U32),
    ("span_kind", _U32),
    ("trace_id_index", _U32),     # low bits of trace_id for joins
    ("process_kname_0_hash", _U32),
    ("process_kname_1_hash", _U32),
    ("syscall_thread_0", _U32),
    ("syscall_thread_1", _U32),
    # dynamic attribute/metric arrays fold to one content hash per list
    # (SmartEncoding: the dict holds the joined names/values strings)
    ("attribute_names_hash", _U32),
    ("attribute_values_hash", _U32),
    ("metrics_names_hash", _U32),
    ("metrics_values_hash", _U32),
)

_L7_WIDE64 = (
    ("syscall_trace_id_request", _U64),
    ("syscall_trace_id_response", _U64),
    ("syscall_coroutine_0", _U64),
    ("syscall_coroutine_1", _U64),
    ("syscall_cap_seq_0", _U64),
    ("syscall_cap_seq_1", _U64),
    ("flow_id", _U64),
    ("start_time_us", _U64),
    ("end_time_us", _U64),
    ("_id", _U64),
)

L7_SCHEMA = Schema(
    name="l7_flow_log",
    columns=_L7_CORE + _L7_WIDE + _L7_WIDE64,
)

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
