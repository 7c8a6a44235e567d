"""Columnar decoders: protobuf records -> schema columns.

A copy of the JAX package's Python decoders, the ones its pipelines run
whenever its native decoder is not built. Mirrors the reference decode stage
(server/ingester/flow_log/decoder/decoder.go:176-192 TaggedFlow ->
L4FlowLog), but emits structure-of-arrays instead of row structs.

Column extraction covers the reference's full row families (l4_flow_log.go
DataLinkLayer/NetworkLayer/TransportLayer/FlowInfo/Metrics,
l7_flow_log.go L7Base/L7FlowLog); strings become u32 dictionary hashes
(SmartEncoding), IPv6 addresses fold to u32 FNV hashes with is_ipv6 set.
"""

from __future__ import annotations

import functools
import zlib
from typing import Dict, Iterable, List

import numpy as np

from deepflow_tpu_torch.batch.schema import L4_SCHEMA, L7_SCHEMA, METRIC_SCHEMA
from deepflow_tpu_torch.wire.gen import flow_log_pb2, metric_pb2, otel_pb2

# L7Protocol ids (reference: agent l7_protocol enum)
L7_PROTO_HTTP1 = 20
L7_PROTO_GRPC = 41
L7_PROTO_UNKNOWN = 0

# FlowInfo.signal_source values (reference: datatype/flow.go SignalSource)
SIGNAL_SOURCE_PACKET = 0
SIGNAL_SOURCE_EBPF = 3
SIGNAL_SOURCE_OTEL = 4

_NS_PER_S = 1_000_000_000

# schema-order name tuples, hoisted so the per-record row projection
# doesn't re-walk the column specs
_L4_NAMES = L4_SCHEMA.names
_L7_NAMES = L7_SCHEMA.names


def _fnv1a32(data: bytes) -> int:
    h = 0x811C9DC5
    for b in data:
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


# The same endpoint/domain/service strings (and v6 addresses) recur on
# every batch for the lifetime of a service, and byte-at-a-time FNV-1a
# in Python is pure host decode time. Bounded LRU over the PURE hash only:
# TagDict codes stay on the dict's own map (encode_one records the
# reversible mapping; caching its result here would pin codes across a
# dict reset). lru_cache is thread-safe for the parallel decoder fleet
# and its cache_info() feeds the hash_cache Countable.
_HASH_CACHE_CAP = 1 << 16
_fnv1a32_cached = functools.lru_cache(maxsize=_HASH_CACHE_CAP)(_fnv1a32)


def hash_cache_counters() -> Dict[str, int]:
    """Countable for the string-hash LRU (registered once per process
    by FlowLogPipeline as `decode.hash_cache`)."""
    info = _fnv1a32_cached.cache_info()
    return {"hash_cache_hits": info.hits,
            "hash_cache_misses": info.misses,
            "hash_cache_size": info.currsize}


def _hash_str(s: str, endpoint_dict=None) -> int:
    """String -> u32 dictionary code. Empty maps to 0 (the null image of
    the reference's Nullable string columns); with a TagDict the code is
    recorded reversibly, else a raw FNV-1a. One definition for every
    string column, so the decoders can never diverge."""
    if not s:
        return 0
    return endpoint_dict.encode_one(s) if endpoint_dict is not None \
        else _fnv1a32_cached(s.encode())


def _u32(v: int) -> int:
    return v & 0xFFFFFFFF


def _fill(schema, rows: List[tuple]) -> Dict[str, np.ndarray]:
    """rows of python ints (schema order) -> typed columns. int32 columns
    travel as their two's-complement u32 image."""
    cols = schema.alloc(len(rows))
    if rows:
        arr = np.array(rows, dtype=np.uint64)
        for i, (name, dt) in enumerate(schema.columns):
            if dt == np.dtype(np.int32):
                cols[name][:] = arr[:, i].astype(np.uint32).view(np.int32)
            else:
                cols[name][:] = arr[:, i].astype(dt)
    return cols


def _ip_u32(ip4: int, ip6: bytes) -> int:
    """v4 address, or the system-wide class-E-confined fold of a v6
    address (store.dict_store.fold_ipv6; is_ipv6 marks which) — the
    same u32 the capture path produces for the same address."""
    return (_fnv1a32_cached(ip6) | 0xF0000000) if ip6 else _u32(ip4)


def _l4_status(close_type: int, proto: int) -> int:
    """LogMessageStatus from close type (l4_flow_log.go getStatus :857;
    enum protocol_logs.go:58 — 0 OK, 2 not-exist, 3 server-error).
    This framework's 4-value close enum has no client/server RST split,
    so RSTs land server-side."""
    if close_type in (0, 1):                  # forced report / FIN
        return 0
    if close_type == 3:                       # timeout
        return 3 if proto == 6 else 0
    if close_type == 2:                       # RST
        return 3
    return 2


def decode_l4_records(records: Iterable[bytes]) -> Dict[str, np.ndarray]:
    """Parse TaggedFlow records into L4_SCHEMA columns (all families)."""
    rows: List[tuple] = []
    for raw in records:
        m = flow_log_pb2.TaggedFlow()
        try:
            m.ParseFromString(raw)
        except Exception:
            continue  # skip the one bad record, keep the batch
        f = m.flow
        k = f.flow_key
        src, dst = f.metrics_peer_src, f.metrics_peer_dst
        tcp = f.perf_stats.tcp
        l7 = f.perf_stats.l7
        tun = f.tunnel
        v = {
            # core
            "ip_src": _ip_u32(k.ip_src, k.ip6_src),
            "ip_dst": _ip_u32(k.ip_dst, k.ip6_dst),
            "port_src": k.port_src, "port_dst": k.port_dst,
            "proto": k.proto, "vtap_id": k.vtap_id, "tap_side": f.tap_side,
            "l3_epc_id": _u32(src.l3_epc_id),
            "byte_tx": _u32(src.byte_count), "byte_rx": _u32(dst.byte_count),
            "packet_tx": _u32(src.packet_count),
            "packet_rx": _u32(dst.packet_count),
            "rtt": tcp.rtt, "retrans": tcp.total_retrans_count,
            "close_type": f.close_type,
            "timestamp": _u32(f.start_time // _NS_PER_S),
            "duration_us": _u32(min(f.duration // 1000, 0xFFFFFFFF)),
            # datalink
            "eth_type": f.eth_type, "vlan": f.vlan,
            # network / tunnel
            "is_ipv6": 1 if (k.ip6_src or k.ip6_dst) else 0,
            "tunnel_tier": tun.tier, "tunnel_type": tun.tunnel_type,
            "tunnel_tx_id": tun.tx_id, "tunnel_rx_id": tun.rx_id,
            "tunnel_tx_ip_0": tun.tx_ip0, "tunnel_tx_ip_1": tun.tx_ip1,
            "tunnel_rx_ip_0": tun.rx_ip0, "tunnel_rx_ip_1": tun.rx_ip1,
            # transport
            "tcp_flags_bit_0": src.tcp_flags, "tcp_flags_bit_1": dst.tcp_flags,
            "syn_seq": f.syn_seq, "synack_seq": f.synack_seq,
            "last_keepalive_seq": f.last_keepalive_seq,
            "last_keepalive_ack": f.last_keepalive_ack,
            # application
            "l7_protocol": f.perf_stats.l7_protocol,
            # internet (geo enrichment, never on the wire)
            "province_0": 0, "province_1": 0,
            # flow info
            "l3_epc_id_1": _u32(dst.l3_epc_id),
            "signal_source": f.signal_source,
            "tap_type": k.tap_type,
            "tap_port": _u32(k.tap_port),
            "tap_port_type": (k.tap_port >> 32) & 0xFF,
            "is_new_flow": f.is_new_flow,
            "is_active_service": f.is_active_service,
            "l2_end_0": src.is_l2_end, "l2_end_1": dst.is_l2_end,
            "l3_end_0": src.is_l3_end, "l3_end_1": dst.is_l3_end,
            "direction_score": f.direction_score,
            "gprocess_id_0": src.gpid, "gprocess_id_1": dst.gpid,
            "nat_real_ip_0": src.real_ip, "nat_real_ip_1": dst.real_ip,
            "nat_real_port_0": src.real_port, "nat_real_port_1": dst.real_port,
            "nat_source": 0,
            "status": _l4_status(f.close_type, k.proto),
            "acl_gids": f.acl_gids[0] if f.acl_gids else 0,
            # metrics
            "l3_byte_tx": _u32(src.l3_byte_count),
            "l3_byte_rx": _u32(dst.l3_byte_count),
            "l4_byte_tx": _u32(src.l4_byte_count),
            "l4_byte_rx": _u32(dst.l4_byte_count),
            "total_byte_tx": _u32(src.total_byte_count),
            "total_byte_rx": _u32(dst.total_byte_count),
            "total_packet_tx": _u32(src.total_packet_count),
            "total_packet_rx": _u32(dst.total_packet_count),
            "l7_request": l7.request_count, "l7_response": l7.response_count,
            "l7_parse_failed": f.perf_stats.l7_failed_count,
            "l7_client_error": l7.err_client_count,
            "l7_server_error": l7.err_server_count,
            "l7_server_timeout": l7.err_timeout,
            "rtt_client": tcp.rtt_client_max, "rtt_server": tcp.rtt_server_max,
            "tls_rtt": l7.tls_rtt,
            "srt_sum": tcp.srt_sum, "srt_count": tcp.srt_count,
            "srt_max": tcp.srt_max,
            "art_sum": tcp.art_sum, "art_count": tcp.art_count,
            "art_max": tcp.art_max,
            "rrt_sum": _u32(l7.rrt_sum), "rrt_count": l7.rrt_count,
            "rrt_max": l7.rrt_max,
            "cit_sum": tcp.cit_sum, "cit_count": tcp.cit_count,
            "cit_max": tcp.cit_max,
            "retrans_tx": tcp.counts_peer_tx.retrans_count,
            "retrans_rx": tcp.counts_peer_rx.retrans_count,
            "zero_win_tx": tcp.counts_peer_tx.zero_win_count,
            "zero_win_rx": tcp.counts_peer_rx.zero_win_count,
            "syn_count": tcp.syn_count, "synack_count": tcp.synack_count,
            # handshake repeats count as retransmissions at ingest
            # (reference l4_flow_log.go:960)
            "retrans_syn": max(int(tcp.syn_count) - 1, 0),
            "retrans_synack": max(int(tcp.synack_count) - 1, 0),
            "l7_error": l7.err_client_count + l7.err_server_count,
            # u64 tail
            "mac_src": k.mac_src, "mac_dst": k.mac_dst,
            "flow_id": f.flow_id,
            "start_time_us": f.start_time // 1000,
            "end_time_us": f.end_time // 1000,
            "tunnel_tx_mac": (tun.tx_mac0 << 32) | tun.tx_mac1,
            "tunnel_rx_mac": (tun.rx_mac0 << 32) | tun.rx_mac1,
            "_id": 0,   # stamped by the ingest pipeline (genID role)
        }
        rows.append(tuple(v[n] for n in _L4_NAMES))
    return _fill(L4_SCHEMA, rows)


def decode_l7_records(records: Iterable[bytes],
                      endpoint_dict=None) -> Dict[str, np.ndarray]:
    """Parse AppProtoLogsData records into L7_SCHEMA columns.

    Strings are hashed to uint32 on the host, matching the SmartEncoding
    philosophy: strings become integers before they reach the
    columnar/device domain (reference: the tagrecorder dictionary approach,
    SURVEY.md §2.3). With `endpoint_dict` (a TagDict) hashes are recorded
    reversibly; without, a raw FNV-1a is used. Empty strings map to 0 (the
    null image of the reference's Nullable columns).
    """
    def h(s: str) -> int:
        return _hash_str(s, endpoint_dict)

    rows: List[tuple] = []
    for raw in records:
        m = flow_log_pb2.AppProtoLogsData()
        try:
            m.ParseFromString(raw)
        except Exception:
            continue
        b = m.base
        t = m.trace_info
        e = m.ext_info
        endpoint = m.req.endpoint or m.req.resource or m.req.domain
        v = {
            # core
            "ip_src": _ip_u32(b.ip_src, b.ip6_src),
            "ip_dst": _ip_u32(b.ip_dst, b.ip6_dst),
            "port_src": b.port_src, "port_dst": b.port_dst,
            "protocol": b.protocol,
            "l7_protocol": b.head.proto, "msg_type": b.head.msg_type,
            "vtap_id": b.vtap_id,
            "endpoint_hash": h(endpoint), "status": m.resp.status,
            "rrt_us": _u32(b.head.rrt // 1000),
            "req_len": _u32(m.req_len), "resp_len": _u32(m.resp_len),
            "timestamp": _u32(b.start_time // _NS_PER_S),
            # wide
            "l3_epc_id_0": _u32(b.l3_epc_id_src),
            "l3_epc_id_1": _u32(b.l3_epc_id_dst),
            "tap_side": b.tap_side, "tap_type": b.tap_type,
            "tap_port": _u32(b.tap_port),
            "tap_port_type": (b.tap_port >> 32) & 0xFF,
            "is_ipv6": b.is_ipv6,
            "is_tls": m.flags & 1,
            "version_hash": h(m.version),
            "request_type_hash": h(m.req.req_type),
            "request_domain_hash": h(m.req.domain),
            "request_resource_hash": h(m.req.resource),
            "request_id": e.request_id,
            "response_code": _u32(m.resp.code),
            "response_exception_hash": h(m.resp.exception),
            "response_result_hash": h(m.resp.result),
            "trace_id_hash": h(t.trace_id),
            "span_id_hash": h(t.span_id),
            "parent_span_id_hash": h(t.parent_span_id),
            "x_request_id_0_hash": h(e.x_request_id_0),
            "x_request_id_1_hash": h(e.x_request_id_1),
            "http_proxy_client_hash": h(e.client_ip),
            "app_service_hash": h(e.service_name or e.rpc_service),
            "app_instance_hash": 0,
            "user_agent_hash": h(e.http_user_agent),
            "referer_hash": h(e.http_referer),
            "process_id_0": b.process_id_0, "process_id_1": b.process_id_1,
            "gprocess_id_0": b.gpid_0, "gprocess_id_1": b.gpid_1,
            "pod_id_0": b.pod_id_0, "pod_id_1": b.pod_id_1,
            "req_tcp_seq": b.req_tcp_seq, "resp_tcp_seq": b.resp_tcp_seq,
            "sql_affected_rows": m.row_effect,
            "direction_score": m.direction_score,
            # syscall identities only exist on eBPF-sourced records — the
            # wire has no signal_source field, so provenance is inferred
            # exactly like the reference's separate queue routing would
            "signal_source": (SIGNAL_SOURCE_EBPF
                              if (b.syscall_trace_id_request
                                  or b.syscall_trace_id_response
                                  or b.syscall_trace_id_thread_0
                                  or b.syscall_trace_id_thread_1
                                  or b.syscall_cap_seq_0
                                  or b.syscall_cap_seq_1)
                              else SIGNAL_SOURCE_PACKET),
            "nat_source": 0,
            "tunnel_type": 0,
            "span_kind": 0,      # OTel-sourced rows set this (span path)
            # join key for trace fan-out queries: the trace id's content
            # hash doubles as the reference's trace_id_index role
            "trace_id_index": h(t.trace_id),
            "process_kname_0_hash": h(b.process_kname_0),
            "process_kname_1_hash": h(b.process_kname_1),
            "syscall_thread_0": b.syscall_trace_id_thread_0,
            "syscall_thread_1": b.syscall_trace_id_thread_1,
            "attribute_names_hash": h(",".join(e.attribute_names)),
            "attribute_values_hash": h(",".join(e.attribute_values)),
            "metrics_names_hash": h(",".join(e.metrics_names)),
            "metrics_values_hash": h(",".join(
                f"{x:g}" for x in e.metrics_values)),
            # u64 tail
            "syscall_trace_id_request": b.syscall_trace_id_request,
            "syscall_trace_id_response": b.syscall_trace_id_response,
            "syscall_coroutine_0": b.syscall_coroutine_0,
            "syscall_coroutine_1": b.syscall_coroutine_1,
            "syscall_cap_seq_0": b.syscall_cap_seq_0,
            "syscall_cap_seq_1": b.syscall_cap_seq_1,
            "flow_id": b.flow_id,
            "start_time_us": b.start_time // 1000,
            "end_time_us": b.end_time // 1000,
            "_id": 0,
        }
        rows.append(tuple(v[n] for n in _L7_NAMES))
    return _fill(L7_SCHEMA, rows)


def decode_otel_frames(payloads: Iterable[bytes],
                       compressed: bool = False, vtap_id: int = 0,
                       endpoint_dict=None):
    """OTLP trace exports -> (L7_SCHEMA columns, bad_payload_count)
    (reference: flow_log decoder.go:219 zlib+pb decode ->
    log_data/otel.go span mapping).

    Each payload is one ExportTraceServiceRequest. Spans map like the
    reference's: name -> endpoint, duration -> rrt, OTLP status code ->
    response status (0 ok, 1 error), rpc.system/http.* attributes pick
    the l7 protocol; network peers come from net.* attributes when
    present, else 0. Trace/span identities and the resource's
    service.name land in the wide columns with signal_source=OTEL.
    """
    def h(s: str) -> int:
        return _hash_str(s, endpoint_dict)

    zero = {n: 0 for n in _L7_NAMES}
    rows: List[tuple] = []
    bad = 0
    for payload in payloads:
        if compressed:
            try:
                payload = zlib.decompress(payload)
            except zlib.error:
                bad += 1
                continue
        req = otel_pb2.ExportTraceServiceRequest()
        try:
            req.ParseFromString(payload)
        except Exception:
            bad += 1
            continue
        for rs in req.resource_spans:
            service = ""
            for kv in rs.resource.attributes:
                if kv.key == "service.name":
                    service = kv.value.string_value
            for ss in rs.scope_spans:
                for span in ss.spans:
                    attrs = {kv.key: kv.value for kv in span.attributes}
                    l7 = L7_PROTO_UNKNOWN
                    if "rpc.system" in attrs and \
                            attrs["rpc.system"].string_value == "grpc":
                        l7 = L7_PROTO_GRPC
                    elif any(k.startswith("http.") for k in attrs):
                        l7 = L7_PROTO_HTTP1
                    port = (int(attrs["net.peer.port"].int_value)
                            & 0xFFFF) if "net.peer.port" in attrs else 0
                    # mask to the i32 wire image: AnyValue.int_value is a
                    # full int64 and may be hostile/negative — an unmasked
                    # value would overflow the u64 row staging
                    code = _u32(int(attrs["http.status_code"].int_value)) \
                        if "http.status_code" in attrs else 0
                    dur_us = max(span.end_time_unix_nano
                                 - span.start_time_unix_nano, 0) // 1000
                    v = dict(zero)
                    v.update({
                        "port_dst": port, "protocol": 6, "l7_protocol": l7,
                        "msg_type": 3,           # session
                        "vtap_id": vtap_id,
                        # span.name recorded in the dictionary so the hash
                        # is reversible at query/export time
                        "endpoint_hash": h(span.name),
                        "status": 1 if span.status.code == 2 else 0,
                        "rrt_us": _u32(dur_us),
                        "timestamp":
                            _u32(span.start_time_unix_nano // _NS_PER_S),
                        "response_code": code,
                        "trace_id_hash": h(span.trace_id.hex()),
                        "trace_id_index": h(span.trace_id.hex()),
                        "span_id_hash": h(span.span_id.hex()),
                        "parent_span_id_hash": h(span.parent_span_id.hex()),
                        "app_service_hash": h(service),
                        "span_kind": span.kind,
                        "signal_source": SIGNAL_SOURCE_OTEL,
                        "start_time_us": span.start_time_unix_nano // 1000,
                        "end_time_us": span.end_time_unix_nano // 1000,
                    })
                    rows.append(tuple(v[n] for n in _L7_NAMES))
    return _fill(L7_SCHEMA, rows), bad


_METRIC_NAMES = METRIC_SCHEMA.names


def decode_metric_records(records: Iterable[bytes],
                          endpoint_dict=None) -> Dict[str, np.ndarray]:
    """Parse metric Document records into METRIC_SCHEMA columns — the full
    zerodoc tag+meter model (MiniTag dimensions, Traffic/Latency/
    Performance/Anomaly meters, AppMeter l7 counters)."""
    rows: List[tuple] = []
    for raw in records:
        d = metric_pb2.Document()
        try:
            d.ParseFromString(raw)
        except Exception:
            continue
        fld = d.tag.field
        ip = (_fnv1a32_cached(fld.ip) | 0xF0000000) if len(fld.ip) == 16 else (
            int.from_bytes(fld.ip, "big") if fld.ip else 0)
        t = d.meter.flow.traffic
        p = d.meter.flow.performance
        lat = d.meter.flow.latency
        an = d.meter.flow.anomaly
        app = d.meter.app
        v = {
            "timestamp": d.timestamp,
            "tag_code": int(d.tag.code),
            "ip": _u32(ip), "server_port": fld.server_port,
            "vtap_id": fld.vtap_id, "protocol": fld.protocol,
            "l3_epc_id": _u32(fld.l3_epc_id),
            "direction": fld.direction, "tap_side": fld.tap_side,
            "tap_type": fld.tap_type, "tap_port": _u32(fld.tap_port),
            "l7_protocol": fld.l7_protocol,
            "gprocess_id": fld.gpid,
            "signal_source": fld.signal_source,
            "pod_id": fld.pod_id,
            "app_service_hash": _hash_str(fld.app_service, endpoint_dict),
            "endpoint_hash": _hash_str(fld.endpoint, endpoint_dict),
            "packet_tx": _u32(t.packet_tx), "packet_rx": _u32(t.packet_rx),
            "byte_tx": _u32(t.byte_tx), "byte_rx": _u32(t.byte_rx),
            "l3_byte_tx": _u32(t.l3_byte_tx),
            "l3_byte_rx": _u32(t.l3_byte_rx),
            "l4_byte_tx": _u32(t.l4_byte_tx),
            "l4_byte_rx": _u32(t.l4_byte_rx),
            "new_flow": _u32(t.new_flow),
            "closed_flow": _u32(t.closed_flow),
            "l7_request": t.l7_request or app.traffic.request,
            "l7_response": t.l7_response or app.traffic.response,
            "syn": t.syn, "synack": t.synack,
            "rtt_sum": _u32(lat.rtt_sum), "rtt_count": lat.rtt_count,
            "rtt_max": lat.rtt_max,
            "rtt_client_sum": _u32(lat.rtt_client_sum),
            "rtt_client_count": lat.rtt_client_count,
            "rtt_server_sum": _u32(lat.rtt_server_sum),
            "rtt_server_count": lat.rtt_server_count,
            "srt_sum": _u32(lat.srt_sum), "srt_count": lat.srt_count,
            "srt_max": lat.srt_max,
            "art_sum": _u32(lat.art_sum), "art_count": lat.art_count,
            "art_max": lat.art_max,
            "rrt_sum": _u32(lat.rrt_sum), "rrt_count": lat.rrt_count,
            "rrt_max": lat.rrt_max,
            "cit_sum": _u32(lat.cit_sum), "cit_count": lat.cit_count,
            "cit_max": lat.cit_max,
            "retrans_tx": _u32(p.retrans_tx),
            "retrans_rx": _u32(p.retrans_rx),
            "zero_win_tx": _u32(p.zero_win_tx),
            "zero_win_rx": _u32(p.zero_win_rx),
            "retrans_syn": p.retrans_syn,
            "retrans_synack": p.retrans_synack,
            "client_rst_flow": _u32(an.client_rst_flow),
            "server_rst_flow": _u32(an.server_rst_flow),
            "client_syn_repeat": _u32(an.client_syn_repeat),
            "server_synack_repeat": _u32(an.server_synack_repeat),
            "client_half_close_flow": _u32(an.client_half_close_flow),
            "server_half_close_flow": _u32(an.server_half_close_flow),
            "tcp_timeout": _u32(an.tcp_timeout),
            "l7_client_error": an.l7_client_error,
            "l7_server_error": an.l7_server_error,
            "l7_timeout": an.l7_timeout,
        }
        rows.append(tuple(v[n] for n in _METRIC_NAMES))
    return _fill(METRIC_SCHEMA, rows)
