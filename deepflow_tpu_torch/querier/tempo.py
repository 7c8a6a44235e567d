"""Tempo-compatible trace query API over l7_flow_log.

Reference: server/querier/tempo/tempo.go — DeepFlow serves Grafana's
Tempo datasource so distributed traces stored in l7_flow_log render in
the Traces panel: /api/traces/{id} returns the span batch, /api/search
finds recent traces, /api/search/tags enumerates searchable tags.

Trace/span identities travel SmartEncoded (u32 dictionary hashes through
the shared l7_endpoint TagDict), so trace lookup is: dict lookup(trace_id)
-> one vectorized column compare -> decode the matched rows' string
hashes back out. No string columns ever hit the store.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from deepflow_tpu_torch.store.db import Store
from deepflow_tpu_torch.store.dict_store import TagDictRegistry

# l7_protocol enum -> display name (reference: datatype L7Protocol)
L7_PROTOCOL_NAMES = {
    0: "unknown", 1: "other", 20: "HTTP", 21: "HTTP2", 40: "Dubbo",
    41: "gRPC", 43: "SofaRPC", 44: "FastCGI", 60: "MySQL",
    61: "PostgreSQL", 62: "Oracle", 80: "Redis", 81: "MongoDB",
    100: "Kafka", 101: "MQTT", 102: "AMQP", 103: "OpenWire",
    104: "NATS", 120: "DNS", 121: "TLS",
}


def _ip_str(v: int) -> str:
    return ".".join(str((v >> s) & 0xFF) for s in (24, 16, 8, 0))


_DURATION_UNITS_US = {"ns": 1e-3, "us": 1.0, "µs": 1.0, "ms": 1e3,
                      "s": 1e6, "m": 60e6, "h": 3600e6}


def parse_duration_us(text: str) -> int:
    """Go-style duration string -> microseconds ('5ms', '1.5s', '300us');
    bare numbers read as microseconds. Grafana's Tempo datasource sends
    the Go form in minDuration/maxDuration."""
    text = str(text).strip()
    if not text:
        return 0
    for unit in sorted(_DURATION_UNITS_US, key=len, reverse=True):
        if text.endswith(unit):
            return int(float(text[:-len(unit)]) * _DURATION_UNITS_US[unit])
    return int(float(text))


class TempoQuery:
    def __init__(self, store: Store, tag_dicts: TagDictRegistry,
                 db: str = "flow_log", table: str = "l7_flow_log") -> None:
        self.store = store
        self.strings = tag_dicts.get("l7_endpoint")
        self.db = db
        self.table = table

    # column sets per endpoint: the l7 table is ~90 columns wide and a
    # Grafana poll must not pay a full-width scan for the handful it reads
    _SPAN_COLS = ("trace_id_hash", "span_id_hash", "parent_span_id_hash",
                  "endpoint_hash", "app_service_hash", "start_time_us",
                  "end_time_us", "rrt_us", "l7_protocol", "status",
                  "response_code", "ip_src", "ip_dst", "port_dst",
                  "vtap_id")
    _SEARCH_COLS = ("trace_id_hash", "app_service_hash", "endpoint_hash",
                    "start_time_us", "end_time_us")

    def _scan(self, time_range: Optional[Tuple[int, int]] = None,
              columns=None):
        try:
            t = self.store.table(self.db, self.table)
        except KeyError:
            return None
        return t.scan(columns=columns, time_range=time_range)

    def _span(self, cols: Dict[str, np.ndarray], i: int) -> dict:
        dec = self.strings.decode
        start_us = int(cols["start_time_us"][i])
        end_us = int(cols["end_time_us"][i])
        dur_us = max(end_us - start_us, 0) or int(cols["rrt_us"][i])
        proto = int(cols["l7_protocol"][i])
        return {
            "traceID": dec(int(cols["trace_id_hash"][i])) or "",
            "spanID": dec(int(cols["span_id_hash"][i])) or "",
            "parentSpanID": dec(int(cols["parent_span_id_hash"][i])) or "",
            "operationName": dec(int(cols["endpoint_hash"][i])) or "",
            "serviceName": dec(int(cols["app_service_hash"][i])) or "",
            "startTimeUnixNano": start_us * 1000,
            "durationNanos": dur_us * 1000,
            "attributes": {
                "l7.protocol": L7_PROTOCOL_NAMES.get(proto, str(proto)),
                "response.status": int(cols["status"][i]),
                "response.code": int(cols["response_code"][i]),
                "ip.src": _ip_str(int(cols["ip_src"][i])),
                "ip.dst": _ip_str(int(cols["ip_dst"][i])),
                "port.dst": int(cols["port_dst"][i]),
                "vtap.id": int(cols["vtap_id"][i]),
            },
        }

    def trace(self, trace_id: str,
              time_range: Optional[Tuple[int, int]] = None) -> Optional[dict]:
        """All spans of one trace (GET /api/traces/{id}); None = unknown."""
        h = self.strings.lookup(trace_id)   # read-only: never grows dict
        if h is None:
            return None
        cols = self._scan(time_range, columns=self._SPAN_COLS)
        if cols is None:
            return None
        idx = np.nonzero(cols["trace_id_hash"] == np.uint32(h))[0]
        if len(idx) == 0:
            return None
        order = idx[np.argsort(cols["start_time_us"][idx])]
        spans = [self._span(cols, int(i)) for i in order]
        return {"traceID": trace_id, "spans": spans}

    _TRACING_COLS = _SPAN_COLS + ("syscall_trace_id_request",
                                  "syscall_trace_id_response",
                                  "x_request_id_0_hash",
                                  "x_request_id_1_hash", "_id")

    def l7_tracing(self, row_id: int,
                   time_range: Optional[Tuple[int, int]] = None,
                   max_hops: int = 8) -> Optional[dict]:
        """Distributed tracing WITHOUT instrumentation: starting from one
        l7 row (_id), expand the span set to a fixpoint over every
        correlation the row family carries — app trace ids where present,
        syscall_trace_id_request/response (the eBPF thread-session ids:
        a service's inbound request and its outbound downstream call
        share one, agent/ebpf_source.py), and x_request_id pairs. The
        reference serves this as /v1/stats/querier/L7FlowTracing by
        delegating to the external deepflow-app service; here the walk
        is native, vectorized per hop."""
        cols = self._scan(time_range, columns=self._TRACING_COLS)
        if cols is None or len(cols["_id"]) == 0:
            return None
        in_trace = cols["_id"] == np.uint64(row_id)
        if not in_trace.any():
            return None

        def _link_keys(name, mask):
            vals = cols[name][mask]
            return vals[vals != 0]

        # frontier expansion: each hop extracts link keys only from the
        # rows ADDED last hop (earlier rows' keys were already applied)
        # and tests membership only on rows not yet in the trace
        frontier = in_trace
        for _ in range(max_hops):
            tr = _link_keys("trace_id_hash", frontier)
            sys_ids = np.concatenate([
                _link_keys("syscall_trace_id_request", frontier),
                _link_keys("syscall_trace_id_response", frontier)])
            xreq = np.concatenate([
                _link_keys("x_request_id_0_hash", frontier),
                _link_keys("x_request_id_1_hash", frontier)])
            new = ~in_trace & (
                np.isin(cols["trace_id_hash"], tr)
                | np.isin(cols["syscall_trace_id_request"], sys_ids)
                | np.isin(cols["syscall_trace_id_response"], sys_ids)
                | np.isin(cols["x_request_id_0_hash"], xreq)
                | np.isin(cols["x_request_id_1_hash"], xreq))
            if not new.any():
                break
            in_trace |= new
            frontier = new
        idx = np.nonzero(in_trace)[0]
        order = idx[np.argsort(cols["start_time_us"][idx])]
        spans = []
        for i in order:
            s = self._span(cols, int(i))
            for attr, col in (("syscall_trace_id.request",
                               "syscall_trace_id_request"),
                              ("syscall_trace_id.response",
                               "syscall_trace_id_response")):
                v = int(cols[col][i])
                if v:
                    s["attributes"][attr] = v
            s["attributes"]["_id"] = int(cols["_id"][i])
            spans.append(s)
        trace_id = next((s["traceID"] for s in spans if s["traceID"]),
                        f"l7-tracing-{row_id}")
        return {"traceID": trace_id, "spans": spans}

    def search(self, service: Optional[str] = None,
               min_duration_us: int = 0, limit: int = 20,
               time_range: Optional[Tuple[int, int]] = None) -> List[dict]:
        """Recent trace summaries (GET /api/search): one row per trace with
        root service, span count, duration."""
        cols = self._scan(time_range, columns=self._SEARCH_COLS)
        if cols is None:
            return []
        sel = cols["trace_id_hash"] != 0
        if service:
            h = self.strings.lookup(service)
            if h is None:
                return []
            sel &= cols["app_service_hash"] == np.uint32(h)
        idx = np.nonzero(sel)[0]
        if len(idx) == 0:
            return []
        th = cols["trace_id_hash"][idx]
        starts = cols["start_time_us"][idx].astype(np.int64)
        ends = cols["end_time_us"][idx].astype(np.int64)
        uniq, inv = np.unique(th, return_inverse=True)
        t_start = np.full(len(uniq), np.iinfo(np.int64).max, np.int64)
        np.minimum.at(t_start, inv, starts)
        t_end = np.zeros(len(uniq), np.int64)
        np.maximum.at(t_end, inv, ends)
        n_spans = np.bincount(inv, minlength=len(uniq))
        dur = np.maximum(t_end - t_start, 0)
        keep = dur >= min_duration_us
        order = np.argsort(t_start[keep])[::-1][:limit]
        out = []
        kept = np.nonzero(keep)[0][order]
        for u in kept:
            tid = self.strings.decode(int(uniq[u])) or ""
            # root span: earliest row of the trace supplies the service
            rows = idx[inv == u]
            root = rows[np.argmin(cols["start_time_us"][rows])]
            out.append({
                "traceID": tid,
                "rootServiceName": self.strings.decode(
                    int(cols["app_service_hash"][root])) or "",
                "rootTraceName": self.strings.decode(
                    int(cols["endpoint_hash"][root])) or "",
                "startTimeUnixNano": int(t_start[u]) * 1000,
                "durationMs": int(dur[u]) // 1000,
                "spanSets": [{"matched": int(n_spans[u])}],
            })
        return out

    def tags(self) -> List[str]:
        """Searchable tag names (GET /api/search/tags)."""
        return ["service.name", "l7.protocol", "response.status"]

    def tag_values(self, tag: str,
                   time_range: Optional[Tuple[int, int]] = None
                   ) -> List[str]:
        cols = self._scan(
            time_range,
            columns=("app_service_hash", "l7_protocol", "status"))
        if cols is None or not len(cols["l7_protocol"]):
            return []
        if tag == "service.name":
            vals = {self.strings.decode(int(h))
                    for h in np.unique(cols["app_service_hash"]) if h}
            return sorted(v for v in vals if v)
        if tag == "l7.protocol":
            return sorted({L7_PROTOCOL_NAMES.get(int(p), str(int(p)))
                           for p in np.unique(cols["l7_protocol"])})
        if tag == "response.status":
            return [str(int(s)) for s in np.unique(cols["status"])]
        return []
