"""Trace-context extraction from instrumented-app request headers.

Reference: agent/src/flow_generator/protocol_logs/http.rs:1120-1240 —
`decode_id` dispatches on TraceType (traceparent / SkyWalking sw3/sw6/
sw8 / X-B3 / uber-trace-id / customized keys) and stamps trace_id /
span_id into the l7 log. These ids are what link eBPF/packet spans to
OTel spans in one distributed trace; without them tempo assembly rests
solely on syscall ids.

All decoders are written from the public wire formats:
- W3C trace context (https://www.w3.org/TR/trace-context/):
  `traceparent: 00-<32hex trace-id>-<16hex parent-id>-<flags>`
- SkyWalking sw6/sw8: `-`-separated, base64 segments:
  `<sample>-<trace-id b64>-<segment-id b64>-<span-id>-...`
- SkyWalking sw3: `|`-separated:
  `SEGMENTID|SPANID|100|100|...|TRACEID|SAMPLING` (trace at index 7,
  span shown as SEGMENTID-SPANID)
- Zipkin B3 single/multi: `X-B3-TraceId` / `X-B3-SpanId` raw values
- Jaeger: `uber-trace-id: TRACEID:SPANID:PARENTSPAN:FLAGS`
- anything else (customized key): the raw header value

The key *list* is pushed agent config (the reference's
`http_log_trace_id` / `http_log_span_id` proxy config fields,
trident.proto Config) and hot-swappable.

The port's own copy of the JAX package's `agent/trace_context.py` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

import base64
import binascii
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

TRACE_ID = 0
SPAN_ID = 1


def _b64(seg: str) -> str:
    try:
        return base64.b64decode(seg + "=" * (-len(seg) % 4)).decode(
            "utf-8", "replace")
    except (binascii.Error, ValueError):
        return seg


def _decode_traceparent(value: str, id_type: int) -> Optional[str]:
    segs = value.strip().split("-")
    if id_type == TRACE_ID and len(segs) > 1:
        return segs[1]
    if id_type == SPAN_ID and len(segs) > 2:
        return segs[2]
    return None


def _decode_sw8(value: str, id_type: int) -> Optional[str]:
    segs = value.strip().split("-")
    if id_type == TRACE_ID and len(segs) > 2:
        return _b64(segs[1])
    if id_type == SPAN_ID and len(segs) > 4:
        return f"{_b64(segs[2])}-{segs[3]}"
    return None


def _decode_sw3(value: str, id_type: int) -> Optional[str]:
    segs = value.strip().split("|")
    if len(segs) > 7:
        if id_type == TRACE_ID:
            return segs[7]
        if id_type == SPAN_ID:
            return f"{segs[0]}-{segs[1]}"
    return None


def _decode_uber(value: str, id_type: int) -> Optional[str]:
    segs = value.strip().split(":")
    if id_type == TRACE_ID and len(segs) > 0 and segs[0]:
        return segs[0]
    if id_type == SPAN_ID and len(segs) > 2:
        return segs[2]
    return None


def _decode_raw(value: str, id_type: int) -> Optional[str]:
    return value.strip() or None


# header key (lowercase) -> decoder; anything not listed decodes raw
# (the reference's TraceType::Customize / XB3 behavior)
_DECODERS = {
    "traceparent": _decode_traceparent,
    "sw8": _decode_sw8,
    "sw6": _decode_sw8,          # same layout as sw8 for ids
    "sw3": _decode_sw3,
    "uber-trace-id": _decode_uber,
}


def decode_id(key: str, value: str, id_type: int) -> Optional[str]:
    """Extract trace or span id from one header, by the key's format."""
    return _DECODERS.get(key.lower(), _decode_raw)(value, id_type)


@dataclass
class HttpLogConfig:
    """Pushed, hot-swappable header-extraction config (the reference's
    l7-protocol-advanced-features / http_log_* proxy fields). Key lists
    are ordered: first present header wins."""
    trace_types: Tuple[str, ...] = ("traceparent", "sw8")
    span_types: Tuple[str, ...] = ("traceparent", "sw8")
    x_request_id: Tuple[str, ...] = ("x-request-id",)
    proxy_client: Tuple[str, ...] = ("x-forwarded-for", "x-real-ip")


_CONFIG = HttpLogConfig()
_LOCK = threading.Lock()


def _norm(v) -> Tuple[str, ...]:
    """Key list from pushed config: a list/tuple, or the reference's
    comma-joined string form."""
    if isinstance(v, str):
        v = v.split(",")
    return tuple(s.strip().lower() for s in v if s.strip())


def configure(trace_types=None, span_types=None,
              x_request_id=None, proxy_client=None) -> None:
    """Swap the process-global extraction config (parsers are a
    process-global registry; the agent applies pushed config here).
    Every field accepts an iterable of keys or a comma-joined string."""
    global _CONFIG
    with _LOCK:
        cur = _CONFIG
        _CONFIG = HttpLogConfig(
            trace_types=_norm(trace_types)
            if trace_types is not None else cur.trace_types,
            span_types=_norm(span_types)
            if span_types is not None else cur.span_types,
            x_request_id=_norm(x_request_id)
            if x_request_id is not None else cur.x_request_id,
            proxy_client=_norm(proxy_client)
            if proxy_client is not None else cur.proxy_client)


def config() -> HttpLogConfig:
    return _CONFIG


def extract(headers: Dict[str, str]) -> Dict[str, str]:
    """headers (lowercase names) -> {trace_id, span_id, x_request_id,
    client_ip}; empty strings where absent. Shared by HTTP/1 and
    HTTP/2+gRPC so the two stamp identical columns."""
    cfg = _CONFIG
    out = {"trace_id": "", "span_id": "", "x_request_id": "",
           "client_ip": ""}
    for key in cfg.trace_types:
        v = headers.get(key)
        if v:
            got = decode_id(key, v, TRACE_ID)
            if got:
                out["trace_id"] = got
                break
    for key in cfg.span_types:
        v = headers.get(key)
        if v:
            got = decode_id(key, v, SPAN_ID)
            if got:
                out["span_id"] = got
                break
    for key in cfg.x_request_id:
        v = headers.get(key)
        if v:
            out["x_request_id"] = v.strip()
            break
    for key in cfg.proxy_client:
        v = headers.get(key)
        if v:
            # first address of a comma-joined proxy chain = the client
            out["client_ip"] = v.split(",")[0].strip()
            break
    return out
