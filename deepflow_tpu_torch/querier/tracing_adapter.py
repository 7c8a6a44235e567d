"""External-APM tracing adapter: pull third-party traces into the
DeepFlow span model.

Reference: server/querier/app/tracing-adapter/ — a TraceAdapter
registry (`service/base.go Register`, skywalking + packet services),
an ExSpan normalization model (`model/tracing.go`), per-APM endpoint
config (`config ExternalAPM {name, addr, timeout, extra_config}`), and
one route (`router/router.go GET /api/v1/adapter/tracing?traceid=`)
that fans the trace id out to every configured APM and merges the
normalized spans. The flagship adapter speaks the SkyWalking GraphQL
query protocol (`service/skywalking.go query_trace`, v8+).

Here the same shape in Python: `TraceAdapter.get_trace`, an
`ADAPTERS` registry, `ExternalAPM` config rows (yaml `external_apm:`
under `querier:`), and the `SkyWalkingAdapter` speaking the public
skywalking-query-protocol over urllib. Spans normalize into the
dataclass below, which serializes to the reference's ExSpan JSON so
existing consumers of that API shape can switch backends.
"""

from __future__ import annotations

import base64
import json
import logging
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from deepflow_tpu_torch.store.dict_store import fnv1a32

log = logging.getLogger(__name__)

# span_kind (model/tracing.go ExSpan.SpanKind, OTel numbering)
KIND_INTERNAL, KIND_SERVER, KIND_CLIENT = 1, 2, 3
_KIND_TAP_SIDE = {KIND_SERVER: "s-app", KIND_CLIENT: "c-app",
                  KIND_INTERNAL: "app"}

# SkyWalking span `type` values (skywalking-query-protocol trace.graphqls)
_SW_TYPE_KIND = {"Entry": KIND_SERVER, "Exit": KIND_CLIENT,
                 "Local": KIND_INTERNAL}

# SkyWalking `layer` -> deepflow l7_protocol family label. The adapter
# only knows the layer, not the concrete protocol, so these map to the
# display string; the numeric id stays 0 (unknown) like the reference
# does for non-HTTP layers.
_SW_LAYER_PROTO = {"Http": (20, "HTTP"), "Database": (0, "SQL"),
                   "Cache": (0, "Cache"), "MQ": (0, "MQ"),
                   "RPCFramework": (0, "RPC"), "Unknown": (0, "")}

_SW_QUERY = """query queryTrace($traceId: ID!) {
  trace: queryTrace(traceId: $traceId) {
    spans {
      traceId segmentId spanId parentSpanId
      refs { traceId parentSegmentId parentSpanId type }
      serviceCode serviceInstanceName startTime endTime endpointName
      type peer component isError layer
      tags { key value }
    }
  }
}"""


@dataclass
class ExSpan:
    """Normalized external span (reference model/tracing.go ExSpan)."""

    name: str = ""
    _id: int = 0
    start_time_us: int = 0
    end_time_us: int = 0
    tap_side: str = "app"
    l7_protocol: int = 0
    l7_protocol_str: str = ""
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: str = ""
    span_kind: int = KIND_INTERNAL
    endpoint: str = ""
    request_type: str = ""
    request_resource: str = ""
    response_status: int = 0
    app_service: str = ""
    app_instance: str = ""
    service_uname: str = ""
    attribute: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict:
        return asdict(self)


@dataclass
class ExternalAPM:
    """One configured APM endpoint (reference config.ExternalAPM)."""

    name: str
    addr: str                       # e.g. http://host:port
    timeout_s: float = 60.0
    extra_config: Dict[str, str] = field(default_factory=dict)


class SkyWalkingAdapter:
    """SkyWalking v8+ query-protocol adapter (reference
    service/skywalking.go): POST the queryTrace GraphQL document to
    {addr}/graphql, normalize segments/spans/refs into ExSpans."""

    def get_trace(self, trace_id: str, apm: ExternalAPM) -> List[ExSpan]:
        body = json.dumps({"query": _SW_QUERY,
                           "variables": {"traceId": trace_id}}).encode()
        req = urllib.request.Request(
            apm.addr.rstrip("/") + "/graphql", data=body,
            headers={"Content-Type": "application/json"})
        auth = apm.extra_config.get("auth")
        if auth:
            req.add_header("Authorization", "Basic "
                           + base64.b64encode(auth.encode()).decode())
        with urllib.request.urlopen(req, timeout=apm.timeout_s) as resp:
            doc = json.load(resp)
        trace = (doc.get("data") or {}).get("trace") or {}
        return [self._to_exspan(s, trace_id)
                for s in trace.get("spans") or []]

    @staticmethod
    def _span_uid(segment_id: str, span_id) -> str:
        # spans are unique per (segment, spanId); refs address parents
        # the same way, so the composite is the cross-segment link key
        return f"{segment_id}-{span_id}"

    def _to_exspan(self, s: dict, trace_id: str) -> ExSpan:
        tags = {t.get("key", ""): t.get("value") or ""
                for t in s.get("tags") or []}
        kind = _SW_TYPE_KIND.get(s.get("type", ""), KIND_INTERNAL)
        proto_id, proto_str = _SW_LAYER_PROTO.get(s.get("layer") or
                                                  "Unknown", (0, ""))
        span_uid = self._span_uid(s.get("segmentId", ""),
                                  s.get("spanId", 0))
        # parent: same-segment spanId unless -1, else the cross-segment
        # ref (CROSS_PROCESS/CROSS_THREAD both carry parentSegmentId)
        parent = ""
        if int(s.get("parentSpanId", -1)) >= 0:
            parent = self._span_uid(s.get("segmentId", ""),
                                    s["parentSpanId"])
        else:
            refs = s.get("refs") or []
            if refs:
                parent = self._span_uid(refs[0].get("parentSegmentId", ""),
                                        refs[0].get("parentSpanId", 0))
        status = 0
        for k in ("http.status_code", "http.status.code"):
            v = tags.get(k, "")
            if v.isascii() and v.isdigit():
                status = int(v)
                break
        if not status and s.get("isError"):
            status = 500
        endpoint = s.get("endpointName") or ""
        uid = f"{trace_id}/{span_uid}".encode()
        return ExSpan(
            name=endpoint,
            # deterministic 64-bit id (hash() is seed-randomized)
            _id=(fnv1a32(uid) << 32) | fnv1a32(uid[::-1]),
            start_time_us=int(s.get("startTime", 0)) * 1000,
            end_time_us=int(s.get("endTime", 0)) * 1000,
            tap_side=_KIND_TAP_SIDE[kind],
            l7_protocol=proto_id,
            l7_protocol_str=proto_str,
            trace_id=trace_id,
            span_id=span_uid,
            parent_span_id=parent,
            span_kind=kind,
            endpoint=endpoint,
            request_type=tags.get("http.method", ""),
            request_resource=tags.get("url") or tags.get("db.statement")
            or tags.get("cache.key") or endpoint,
            response_status=status,
            app_service=s.get("serviceCode") or "",
            app_instance=s.get("serviceInstanceName") or "",
            service_uname=s.get("serviceCode") or "",
            attribute={k: v for k, v in tags.items()},
        )


# adapter registry (reference service/base.go Register); custom
# adapters register here by protocol name
ADAPTERS: Dict[str, object] = {"skywalking": SkyWalkingAdapter()}


def register_adapter(name: str, adapter) -> None:
    if not hasattr(adapter, "get_trace"):
        raise TypeError("adapter lacks .get_trace")
    ADAPTERS[name] = adapter


class TracingAdapterService:
    """Fan a trace id out to every configured APM and merge the
    normalized spans (reference tracing_adapter TraceHandler)."""

    def __init__(self, apms: Optional[List[ExternalAPM]] = None) -> None:
        self.apms = apms or []

    @classmethod
    def from_config(cls, rows: List[dict]) -> "TracingAdapterService":
        """yaml rows: [{name, addr, timeout_s?, extra_config?}]."""
        apms = []
        for r in rows:
            if r.get("name") not in ADAPTERS:
                log.warning("external_apm %r: no adapter registered",
                            r.get("name"))
                continue
            if not r.get("addr"):
                # a malformed optional-feature row must not prevent the
                # querier from starting
                log.warning("external_apm %r: addr missing; skipped",
                            r.get("name"))
                continue
            apms.append(ExternalAPM(
                name=r["name"], addr=r["addr"],
                timeout_s=float(r.get("timeout_s", 60.0)),
                extra_config=dict(r.get("extra_config") or {})))
        return cls(apms)

    def get_trace(self, trace_id: str) -> List[ExSpan]:
        def one(apm: ExternalAPM) -> List[ExSpan]:
            adapter = ADAPTERS.get(apm.name)
            if adapter is None:
                return []
            try:
                return adapter.get_trace(trace_id, apm)
            except Exception as e:
                # one unreachable APM must not fail the whole query
                # (reference: logs and continues per adapter)
                log.warning("external apm %s trace %s failed: %s",
                            apm.name, trace_id, e)
                return []

        if not self.apms:
            return []
        if len(self.apms) == 1:
            return one(self.apms[0])
        # concurrent fan-out: response latency is the slowest single
        # APM, not the sum of every timeout
        with ThreadPoolExecutor(max_workers=len(self.apms)) as pool:
            results = list(pool.map(one, self.apms))
        spans: List[ExSpan] = []
        for got in results:
            spans.extend(got)
        return spans
