"""L7 protocol parsers: payload bytes -> request/response log records.

Reference: agent/src/flow_generator/protocol_logs/ — per-protocol
check_payload/parse_payload trait objects dispatched over an enum
(agent/src/common/l7_protocol_log.rs:162-219), feeding a session
aggregator that merges request+response by stream. The re-design keeps
the same two-phase contract (cheap check, then parse) as plain Python
classes in a registry; parsers run host-side on the payload slices the
batched packet decoder exposes, and their output is already the columnar
L7 record shape.

Protocol ids follow the reference's L7Protocol enum: HTTP1=20, DNS=120,
MySQL=60, Redis=80.

The port's own copy of the JAX package's `agent/l7.py` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

import re
import struct
import threading
from dataclasses import dataclass
from typing import ClassVar, List, Optional

L7_HTTP1 = 20
L7_MYSQL = 60
L7_REDIS = 80
L7_DNS = 120

MSG_REQUEST = 0
MSG_RESPONSE = 1


@dataclass
class L7Record:
    proto: int
    msg_type: int           # MSG_REQUEST / MSG_RESPONSE
    endpoint: str = ""      # method+path / query name / statement verb
    status: int = 0         # protocol status code
    req_len: int = 0
    resp_len: int = 0
    # instrumented-app trace context (reference: http.rs decode_id) —
    # what links this packet/syscall span to OTel spans in one trace
    trace_id: str = ""
    span_id: str = ""
    # request detail (reference: HttpInfo host/user-agent/referer/
    # x-request-id/proxy-real-ip extraction, http.rs:990-1080)
    req_type: str = ""      # method
    domain: str = ""        # Host / :authority
    resource: str = ""      # full path incl. query
    version: str = ""       # "1.1" / "2"
    user_agent: str = ""
    referer: str = ""
    x_request_id: str = ""
    client_ip: str = ""     # X-Forwarded-For / X-Real-IP first hop


def parse_http_headers(payload: bytes,
                       max_headers: int = 64) -> dict:
    """Header block after the first CRLF -> {lowercase-name: value}.
    Duplicate names keep the first occurrence (proxy-chain semantics:
    the outermost hop's value). Bounded: header floods can't balloon."""
    headers: dict = {}
    head_end = payload.find(b"\r\n\r\n")
    block = payload[:head_end if head_end >= 0 else len(payload)]
    for line in block.split(b"\r\n")[1:max_headers + 1]:
        name, sep, value = line.partition(b":")
        if not sep:
            continue
        key = name.strip().decode("latin-1").lower()
        if key and key not in headers:
            headers[key] = value.strip().decode("latin-1")
    return headers


def http_body_len(payload: bytes, headers: dict) -> int:
    """Body bytes per the message's own framing (reference: http.rs
    content-length tracking): Content-Length when present; for
    Transfer-Encoding: chunked, the sum of the chunk sizes visible in
    this capture slice (each capped to what's actually present — a
    lying chunk header must not inflate the accounting); else the bytes
    past the header block."""
    head_end = payload.find(b"\r\n\r\n")
    body_off = head_end + 4 if head_end >= 0 else len(payload)
    cl = headers.get("content-length", "")
    if cl.isascii() and cl.isdigit():   # utils.text.parse_int's form
        return int(cl)
    if "chunked" in headers.get("transfer-encoding", "").lower():
        total = 0
        off = body_off
        while off < len(payload):
            line_end = payload.find(b"\r\n", off)
            if line_end < 0:
                break
            size_tok = payload[off:line_end].split(b";")[0].strip()
            # strict hex only: int(x, 16) also accepts signs and
            # underscores, and a hostile b"-2" chunk header would drive
            # the accumulated length negative (u32-wrapping downstream)
            if not size_tok or not all(c in b"0123456789abcdefABCDEF"
                                       for c in size_tok):
                break
            size = int(size_tok, 16)
            if size == 0:
                break
            avail = max(len(payload) - (line_end + 2), 0)
            total += min(size, avail)
            off = line_end + 2 + size + 2      # data + trailing CRLF
        return total
    return max(len(payload) - body_off, 0)


class HttpParser:
    """HTTP/1.x (reference: protocol_logs/http.rs): request line +
    full header extraction (host, content-type, user-agent, referer,
    x-request-id, proxy client ip), trace-context decode
    (trace_context.extract), and content-length/chunked body
    accounting."""

    proto: ClassVar[int] = L7_HTTP1
    _METHODS = (b"GET ", b"POST ", b"PUT ", b"DELETE ", b"HEAD ",
                b"OPTIONS ", b"PATCH ")

    def check(self, payload: bytes) -> bool:
        # "HTTP/2 " (ASCII status line): the http2-uprobe assembler's
        # synthesized blocks (agent/http2_trace.py) — real h2 framing
        # is binary and never hits this prefix
        return payload.startswith(self._METHODS) or \
            payload.startswith(b"HTTP/1.") or \
            payload.startswith(b"HTTP/2 ")

    def parse(self, payload: bytes) -> Optional[L7Record]:
        from deepflow_tpu_torch.agent import trace_context

        try:
            line, _, _ = payload.partition(b"\r\n")
            parts = line.decode("latin-1").split(" ", 2)
        except Exception:
            return None
        headers = parse_http_headers(payload)
        ids = trace_context.extract(headers)
        if payload.startswith(b"HTTP/1.") or \
                payload.startswith(b"HTTP/2 "):
            # isascii() is load-bearing: str.isdigit() accepts Unicode
            # digits int() rejects (b'\xb3' -> '³'.isdigit() is True),
            # and a mutated status line must not raise out of parse()
            # (found by the registry fuzz)
            if len(parts) < 2 or not (parts[1][:3].isascii()
                                      and parts[1][:3].isdigit()):
                return None
            return L7Record(
                self.proto, MSG_RESPONSE,
                status=int(parts[1][:3]),
                resp_len=http_body_len(payload, headers),
                version=parts[0][5:],
                trace_id=ids["trace_id"], span_id=ids["span_id"],
                x_request_id=ids["x_request_id"])
        if len(parts) < 3 or not parts[2].startswith("HTTP/"):
            return None
        path = parts[1].split("?", 1)[0]
        return L7Record(
            self.proto, MSG_REQUEST,
            endpoint=f"{parts[0]} {path}",
            req_len=http_body_len(payload, headers),
            req_type=parts[0],
            domain=headers.get("host", ""),
            resource=parts[1],
            version=parts[2][5:].strip(),
            user_agent=headers.get("user-agent", ""),
            referer=headers.get("referer", ""),
            trace_id=ids["trace_id"], span_id=ids["span_id"],
            x_request_id=ids["x_request_id"],
            client_ip=ids["client_ip"])


class DnsParser:
    """DNS over UDP (reference: protocol_logs/dns.rs)."""

    proto: ClassVar[int] = L7_DNS

    def check(self, payload: bytes) -> bool:
        if len(payload) < 12:
            return False
        qd = struct.unpack_from(">H", payload, 4)[0]
        return 1 <= qd <= 4

    def parse(self, payload: bytes) -> Optional[L7Record]:
        if len(payload) < 12:
            return None
        flags = struct.unpack_from(">H", payload, 2)[0]
        is_resp = bool(flags & 0x8000)
        rcode = flags & 0x000F
        # parse the first question name
        labels = []
        off = 12
        try:
            while off < len(payload):
                ln = payload[off]
                if ln == 0 or ln >= 0xC0:
                    break
                labels.append(payload[off + 1:off + 1 + ln]
                              .decode("latin-1"))
                off += 1 + ln
        except IndexError:
            return None
        name = ".".join(labels)
        if is_resp:
            return L7Record(self.proto, MSG_RESPONSE, endpoint=name,
                            status=rcode, resp_len=len(payload))
        return L7Record(self.proto, MSG_REQUEST, endpoint=name,
                        req_len=len(payload))


class RedisParser:
    """RESP protocol (reference: protocol_logs/sql/redis.rs)."""

    proto: ClassVar[int] = L7_REDIS

    def check(self, payload: bytes) -> bool:
        return len(payload) > 2 and payload[:1] in b"*+-:$"

    def parse(self, payload: bytes) -> Optional[L7Record]:
        head = payload[:1]
        if head == b"*":
            # array of bulk strings: first element is the command
            m = re.match(rb"\*\d+\r\n\$\d+\r\n([A-Za-z]+)", payload)
            cmd = m.group(1).decode().upper() if m else ""
            return L7Record(self.proto, MSG_REQUEST, endpoint=cmd,
                            req_len=len(payload))
        if head == b"-":
            return L7Record(self.proto, MSG_RESPONSE, status=1,
                            resp_len=len(payload))
        if head in (b"+", b":", b"$"):
            return L7Record(self.proto, MSG_RESPONSE, status=0,
                            resp_len=len(payload))
        return None


class MysqlParser:
    """MySQL client/server packets (reference: protocol_logs/sql/mysql.rs).
    Command packets: 3-byte length + seq + command byte; COM_QUERY=3."""

    proto: ClassVar[int] = L7_MYSQL
    _VERBS = re.compile(rb"^\s*(SELECT|INSERT|UPDATE|DELETE|CREATE|DROP|"
                        rb"ALTER|BEGIN|COMMIT|SET|SHOW)", re.IGNORECASE)

    def check(self, payload: bytes) -> bool:
        if len(payload) < 5:
            return False
        ln = int.from_bytes(payload[:3], "little")
        return ln + 4 == len(payload) and payload[3] in (0, 1)

    def parse(self, payload: bytes) -> Optional[L7Record]:
        if len(payload) < 5:
            return None
        cmd = payload[4]
        if payload[3] == 0 and cmd == 3:        # COM_QUERY request
            m = self._VERBS.match(payload[5:])
            verb = m.group(1).decode().upper() if m else "QUERY"
            return L7Record(self.proto, MSG_REQUEST, endpoint=verb,
                            req_len=len(payload))
        if payload[3] == 1:                      # first response packet
            status = 1 if cmd == 0xFF else 0     # ERR header
            return L7Record(self.proto, MSG_RESPONSE, status=status,
                            resp_len=len(payload))
        return None


PARSERS: List = [HttpParser(), DnsParser(), MysqlParser(), RedisParser()]

# the extended set (TLS, HTTP/2+gRPC, Kafka, PostgreSQL, MongoDB, Dubbo,
# MQTT, AMQP, NATS, OpenWire, FastCGI, SofaRPC) registers behind the four
# core parsers; deferred import because l7_ext imports this module's types
def _register_extended() -> None:
    from deepflow_tpu_torch.agent import l7_ext

    l7_ext.register_extended(PARSERS)


_register_extended()


def register_parser(parser, prepend: bool = False) -> None:
    """Plug in a custom protocol parser (the role of the reference's
    Wasm/so plugin hooks, agent/src/plugin/wasm/ — here a plain object
    with .proto, .check(payload) and .parse(payload)->L7Record, plus an
    optional .transports tuple of ip protocols it applies to).
    `prepend` lets a plugin shadow a built-in whose check() is greedy."""
    for attr in ("proto", "check", "parse"):
        if not hasattr(parser, attr):
            raise TypeError(f"parser lacks .{attr}")
    if prepend:
        PARSERS.insert(0, parser)
    else:
        PARSERS.append(parser)


def parse_payload(payload: bytes, proto: Optional[int] = None,
                  port_src: Optional[int] = None,
                  port_dst: Optional[int] = None,
                  ts_ns: int = 0,
                  ip_src: int = 0, ip_dst: int = 0,
                  ip_version: int = 4) -> Optional[L7Record]:
    """Two-phase dispatch: first parser whose cheap check passes wins
    (reference: check_payload ordering in l7_protocol_log.rs). Transport
    context, when provided, gates ambiguous parsers: DNS only on UDP or
    port 53 (byte patterns alone misfire on e.g. TLS records), and the
    byte-oriented TCP protocols never match UDP payloads.

    A parser with `wants_ctx = True` (the .so plugin adapter) receives
    the full dispatch context — the reference's parse_ctx carries
    ips/ports/time and plugins legitimately gate on them."""
    for p in PARSERS:
        if proto is not None:
            if p.proto == L7_DNS:
                if proto != 17 and 53 not in (port_src, port_dst):
                    continue
            elif proto not in getattr(p, "transports", (6,)):
                continue
        if getattr(p, "wants_ctx", False):
            ctx = (proto, port_src or 0, port_dst or 0, ts_ns,
                   ip_src, ip_dst, ip_version)
            if p.check(payload, *ctx):
                rec = p.parse(payload, *ctx)
                if rec is not None:
                    return rec
        elif p.check(payload):
            rec = p.parse(payload)
            if rec is not None:
                return rec
    return None


_DETAIL_FIELDS = ("trace_id", "span_id", "req_type", "domain",
                  "resource", "version", "user_agent", "referer",
                  "client_ip")


def _session_detail(req: Optional[L7Record],
                    resp: Optional[L7Record]) -> dict:
    """Merged string detail: the request's value wins (trace context
    and request headers live on the request); the response fills gaps
    (server-stamped trace ids). x_request_id keeps both directions —
    the reference's x_request_id_0/_1 pair is how proxy-injected ids
    correlate across hops."""
    out = {f: getattr(req, f, "") or getattr(resp, f, "")
           for f in _DETAIL_FIELDS}
    out["x_request_id_0"] = getattr(req, "x_request_id", "")
    out["x_request_id_1"] = getattr(resp, "x_request_id", "")
    return out


class SessionAggregator:
    """Merge request+response halves per (flow, stream) within a time
    window (reference: protocol_logs/parser.rs SessionAggregator :737).
    Emits merged L7Records with round-trip time filled in."""

    def __init__(self, window_ns: int = 60 * 1_000_000_000) -> None:
        self.window_ns = window_ns
        self._pending: dict = {}
        # offer() runs on the capture thread, expire() on the tick loop
        self._lock = threading.Lock()
        self.merged = 0
        self.unpaired = 0

    def offer(self, flow_key: tuple, rec: L7Record,
              ts_ns: int) -> Optional[dict]:
        """Returns a merged session dict when a pair completes. Pipelined
        requests on one connection queue FIFO, so response k pairs with
        request k (HTTP/1.1 pipelining order)."""
        key = (flow_key, rec.proto)
        if rec.msg_type == MSG_REQUEST:
            with self._lock:
                self._pending.setdefault(key, []).append((rec, ts_ns))
            return None
        with self._lock:
            queue = self._pending.get(key)
            req = queue.pop(0) if queue else None
            if queue is not None and not queue:
                del self._pending[key]
        if req is None:
            self.unpaired += 1
            return {"proto": rec.proto, "endpoint": rec.endpoint,
                    "status": rec.status, "rrt_us": 0,
                    "req_len": 0, "resp_len": rec.resp_len,
                    **_session_detail(None, rec)}
        req_rec, req_ts = req
        self.merged += 1
        return {
            "proto": rec.proto,
            "endpoint": req_rec.endpoint or rec.endpoint,
            "status": rec.status,
            "rrt_us": max(ts_ns - req_ts, 0) // 1000,
            "req_len": req_rec.req_len,
            "resp_len": rec.resp_len,
            **_session_detail(req_rec, rec),
        }

    def expire(self, now_ns: int) -> int:
        """Drop requests that never saw a response within the window."""
        dropped = 0
        with self._lock:
            for k in list(self._pending):
                queue = self._pending[k]
                keep = [(r, ts) for r, ts in queue
                        if now_ns - ts <= self.window_ns]
                dropped += len(queue) - len(keep)
                if keep:
                    self._pending[k] = keep
                else:
                    del self._pending[k]
        self.unpaired += dropped
        return dropped
