"""Extended L7 protocol parsers: TLS, HTTP/2+gRPC, Kafka, PostgreSQL,
MongoDB, Dubbo, MQTT, AMQP, NATS, OpenWire, FastCGI, SofaRPC.

Reference: agent/src/flow_generator/protocol_logs/{tls.rs, http.rs (+
plugins/http2 HPACK), mq/{kafka.rs, mqtt.rs, amqp.rs, openwire.rs,
nats.rs}, sql/{postgresql.rs, mongo.rs}, rpc/{dubbo.rs, sofa_rpc.rs,
fastcgi.rs}} — each a check_payload/parse_payload pair over the same
two-phase contract as l7.py. Protocol ids follow the reference
L7Protocol enum (agent/crates/public/src/l7_protocol.rs:36-73).

All parsers here are TCP-transported; they register into l7.PARSERS via
register_extended() (called from l7 import time), ordered so magic-byte
protocols (TLS, Dubbo, AMQP, OpenWire) check before the heuristic ones.

The port's own copy of the JAX package's `agent/l7_ext.py` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

from collections import OrderedDict, deque
import re
import struct
from typing import ClassVar, Dict, List, Optional, Tuple

from deepflow_tpu_torch.agent.l7 import (MSG_REQUEST, MSG_RESPONSE, L7Record)
from deepflow_tpu_torch.agent.sql_obfuscate import obfuscate_sql, sql_verb
from deepflow_tpu_torch.utils.text import parse_int

L7_HTTP2 = 21
L7_DUBBO = 40
L7_GRPC = 41
L7_SOFARPC = 43
L7_FASTCGI = 44
L7_POSTGRESQL = 61
L7_MONGODB = 81
L7_KAFKA = 100
L7_MQTT = 101
L7_AMQP = 102
L7_OPENWIRE = 103
L7_NATS = 104
L7_TLS = 121


# ---------------------------------------------------------------------------
# TLS (reference: protocol_logs/tls.rs)
# ---------------------------------------------------------------------------

class TlsParser:
    """TLS record layer + ClientHello/ServerHello handshake headers.
    endpoint = SNI server name (requests); status carries the alert
    level on alert records."""

    proto: ClassVar[int] = L7_TLS

    def check(self, payload: bytes) -> bool:
        if len(payload) < 6 or payload[0] not in (0x14, 0x15, 0x16, 0x17):
            return False
        if payload[1] != 0x03 or payload[2] > 0x04:
            return False
        rec_len = struct.unpack_from(">H", payload, 3)[0]
        return 0 < rec_len <= (1 << 14) + 256

    def _sni(self, hello: bytes) -> str:
        """Walk ClientHello to the server_name extension (type 0)."""
        try:
            off = 34                                  # version + random
            off += 1 + hello[off]                     # session id
            cs_len = struct.unpack_from(">H", hello, off)[0]
            off += 2 + cs_len                         # cipher suites
            off += 1 + hello[off]                     # compression methods
            if off + 2 > len(hello):
                return ""
            ext_len = struct.unpack_from(">H", hello, off)[0]
            off += 2
            end = min(off + ext_len, len(hello))
            while off + 4 <= end:
                etype, elen = struct.unpack_from(">HH", hello, off)
                off += 4
                if etype == 0 and off + 5 <= end:     # server_name
                    name_len = struct.unpack_from(">H", hello, off + 3)[0]
                    return hello[off + 5:off + 5 + name_len] \
                        .decode("latin-1")
                off += elen
        except (IndexError, struct.error):
            pass
        return ""

    def parse(self, payload: bytes) -> Optional[L7Record]:
        rtype = payload[0]
        if rtype == 0x15 and len(payload) >= 7:        # alert
            return L7Record(self.proto, MSG_RESPONSE, endpoint="alert",
                            status=payload[5], resp_len=len(payload))
        if rtype == 0x17:                              # application data
            return None                                # not a log event
        if rtype != 0x16 or len(payload) < 9:
            return None
        hs_type = payload[5]
        body = payload[9:]
        if hs_type == 1:                               # ClientHello
            return L7Record(self.proto, MSG_REQUEST,
                            endpoint=self._sni(body),
                            req_len=len(payload))
        if hs_type == 2:                               # ServerHello
            return L7Record(self.proto, MSG_RESPONSE, status=0,
                            resp_len=len(payload))
        return None


# ---------------------------------------------------------------------------
# HTTP/2 + gRPC (reference: protocol_logs/http.rs:503 + plugins/http2)
# ---------------------------------------------------------------------------

# RFC 7541 Appendix B: the COMPLETE Huffman code table — (code, bits)
# for every byte 0..255 plus EOS(256). Spec constants, verified against
# the RFC Appendix C.4 test vectors (tests/test_l7_ext.py); with the
# full table no header value ever falls back to a hex placeholder.
_HUFF_TABLE = (
    (0x1ff8, 13), (0x7fffd8, 23), (0xfffffe2, 28), (0xfffffe3, 28),
    (0xfffffe4, 28), (0xfffffe5, 28), (0xfffffe6, 28), (0xfffffe7, 28),
    (0xfffffe8, 28), (0xffffea, 24), (0x3ffffffc, 30), (0xfffffe9, 28),
    (0xfffffea, 28), (0x3ffffffd, 30), (0xfffffeb, 28), (0xfffffec, 28),
    (0xfffffed, 28), (0xfffffee, 28), (0xfffffef, 28), (0xffffff0, 28),
    (0xffffff1, 28), (0xffffff2, 28), (0x3ffffffe, 30), (0xffffff3, 28),
    (0xffffff4, 28), (0xffffff5, 28), (0xffffff6, 28), (0xffffff7, 28),
    (0xffffff8, 28), (0xffffff9, 28), (0xffffffa, 28), (0xffffffb, 28),
    (0x14, 6), (0x3f8, 10), (0x3f9, 10), (0xffa, 12),
    (0x1ff9, 13), (0x15, 6), (0xf8, 8), (0x7fa, 11),
    (0x3fa, 10), (0x3fb, 10), (0xf9, 8), (0x7fb, 11),
    (0xfa, 8), (0x16, 6), (0x17, 6), (0x18, 6),
    (0x0, 5), (0x1, 5), (0x2, 5), (0x19, 6),
    (0x1a, 6), (0x1b, 6), (0x1c, 6), (0x1d, 6),
    (0x1e, 6), (0x1f, 6), (0x5c, 7), (0xfb, 8),
    (0x7ffc, 15), (0x20, 6), (0xffb, 12), (0x3fc, 10),
    (0x1ffa, 13), (0x21, 6), (0x5d, 7), (0x5e, 7),
    (0x5f, 7), (0x60, 7), (0x61, 7), (0x62, 7),
    (0x63, 7), (0x64, 7), (0x65, 7), (0x66, 7),
    (0x67, 7), (0x68, 7), (0x69, 7), (0x6a, 7),
    (0x6b, 7), (0x6c, 7), (0x6d, 7), (0x6e, 7),
    (0x6f, 7), (0x70, 7), (0x71, 7), (0x72, 7),
    (0xfc, 8), (0x73, 7), (0xfd, 8), (0x1ffb, 13),
    (0x7fff0, 19), (0x1ffc, 13), (0x3ffc, 14), (0x22, 6),
    (0x7ffd, 15), (0x3, 5), (0x23, 6), (0x4, 5),
    (0x24, 6), (0x5, 5), (0x25, 6), (0x26, 6),
    (0x27, 6), (0x6, 5), (0x74, 7), (0x75, 7),
    (0x28, 6), (0x29, 6), (0x2a, 6), (0x7, 5),
    (0x2b, 6), (0x76, 7), (0x2c, 6), (0x8, 5),
    (0x9, 5), (0x2d, 6), (0x77, 7), (0x78, 7),
    (0x79, 7), (0x7a, 7), (0x7b, 7), (0x7ffe, 15),
    (0x7fc, 11), (0x3ffd, 14), (0x1ffd, 13), (0xffffffc, 28),
    (0xfffe6, 20), (0x3fffd2, 22), (0xfffe7, 20), (0xfffe8, 20),
    (0x3fffd3, 22), (0x3fffd4, 22), (0x3fffd5, 22), (0x7fffd9, 23),
    (0x3fffd6, 22), (0x7fffda, 23), (0x7fffdb, 23), (0x7fffdc, 23),
    (0x7fffdd, 23), (0x7fffde, 23), (0xffffeb, 24), (0x7fffdf, 23),
    (0xffffec, 24), (0xffffed, 24), (0x3fffd7, 22), (0x7fffe0, 23),
    (0xffffee, 24), (0x7fffe1, 23), (0x7fffe2, 23), (0x7fffe3, 23),
    (0x7fffe4, 23), (0x1fffdc, 21), (0x3fffd8, 22), (0x7fffe5, 23),
    (0x3fffd9, 22), (0x7fffe6, 23), (0x7fffe7, 23), (0xffffef, 24),
    (0x3fffda, 22), (0x1fffdd, 21), (0xfffe9, 20), (0x3fffdb, 22),
    (0x3fffdc, 22), (0x7fffe8, 23), (0x7fffe9, 23), (0x1fffde, 21),
    (0x7fffea, 23), (0x3fffdd, 22), (0x3fffde, 22), (0xfffff0, 24),
    (0x1fffdf, 21), (0x3fffdf, 22), (0x7fffeb, 23), (0x7fffec, 23),
    (0x1fffe0, 21), (0x1fffe1, 21), (0x3fffe0, 22), (0x1fffe2, 21),
    (0x7fffed, 23), (0x3fffe1, 22), (0x7fffee, 23), (0x7fffef, 23),
    (0xfffea, 20), (0x3fffe2, 22), (0x3fffe3, 22), (0x3fffe4, 22),
    (0x7ffff0, 23), (0x3fffe5, 22), (0x3fffe6, 22), (0x7ffff1, 23),
    (0x3ffffe0, 26), (0x3ffffe1, 26), (0xfffeb, 20), (0x7fff1, 19),
    (0x3fffe7, 22), (0x7ffff2, 23), (0x3fffe8, 22), (0x1ffffec, 25),
    (0x3ffffe2, 26), (0x3ffffe3, 26), (0x3ffffe4, 26), (0x7ffffde, 27),
    (0x7ffffdf, 27), (0x3ffffe5, 26), (0xfffff1, 24), (0x1ffffed, 25),
    (0x7fff2, 19), (0x1fffe3, 21), (0x3ffffe6, 26), (0x7ffffe0, 27),
    (0x7ffffe1, 27), (0x3ffffe7, 26), (0x7ffffe2, 27), (0xfffff2, 24),
    (0x1fffe4, 21), (0x1fffe5, 21), (0x3ffffe8, 26), (0x3ffffe9, 26),
    (0xffffffd, 28), (0x7ffffe3, 27), (0x7ffffe4, 27), (0x7ffffe5, 27),
    (0xfffec, 20), (0xfffff3, 24), (0xfffed, 20), (0x1fffe6, 21),
    (0x3fffe9, 22), (0x1fffe7, 21), (0x1fffe8, 21), (0x7ffff3, 23),
    (0x3fffea, 22), (0x3fffeb, 22), (0x1ffffee, 25), (0x1ffffef, 25),
    (0xfffff4, 24), (0xfffff5, 24), (0x3ffffea, 26), (0x7ffff4, 23),
    (0x3ffffeb, 26), (0x7ffffe6, 27), (0x3ffffec, 26), (0x3ffffed, 26),
    (0x7ffffe7, 27), (0x7ffffe8, 27), (0x7ffffe9, 27), (0x7ffffea, 27),
    (0x7ffffeb, 27), (0xffffffe, 28), (0x7ffffec, 27), (0x7ffffed, 27),
    (0x7ffffee, 27), (0x7ffffef, 27), (0x7fffff0, 27), (0x3ffffee, 26),
    (0x3fffffff, 30),
)

_HUFF_BY_LEN: Dict[int, Dict[int, int]] = {}
for _sym, (_code, _bits) in enumerate(_HUFF_TABLE):
    _HUFF_BY_LEN.setdefault(_bits, {})[_code] = _sym
_HUFF_LENS = tuple(sorted(_HUFF_BY_LEN))
_EOS = 256


def huffman_decode(data: bytes) -> Optional[str]:
    """HPACK Huffman string decode (RFC 7541 §5.2); None on EOS in the
    stream or non-ones padding — both are coding errors."""
    out = []
    acc = 0
    nbits = 0
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= 5:
            matched = False
            for ln in _HUFF_LENS:
                if ln > nbits:
                    break
                code = (acc >> (nbits - ln)) & ((1 << ln) - 1)
                sym = _HUFF_BY_LEN[ln].get(code)
                if sym is not None:
                    if sym == _EOS:       # explicit EOS is an error
                        return None
                    out.append(chr(sym))
                    nbits -= ln
                    acc &= (1 << nbits) - 1
                    matched = True
                    break
            if not matched:
                break
    # trailing bits must be all-ones padding (EOS prefix), < 8 of them
    if nbits > 7 or (nbits and (acc & ((1 << nbits) - 1))
                     != (1 << nbits) - 1):
        return None
    return "".join(out)


# HPACK static table entries used for request/response reconstruction
# (RFC 7541 Appendix A; indices 1-61)
_HPACK_STATIC = {
    1: (":authority", ""), 2: (":method", "GET"), 3: (":method", "POST"),
    4: (":path", "/"), 5: (":path", "/index.html"), 6: (":scheme", "http"),
    7: (":scheme", "https"), 8: (":status", "200"), 9: (":status", "204"),
    10: (":status", "206"), 11: (":status", "304"), 12: (":status", "400"),
    13: (":status", "404"), 14: (":status", "500"),
    15: ("accept-charset", ""), 16: ("accept-encoding", "gzip, deflate"),
    17: ("accept-language", ""), 18: ("accept-ranges", ""),
    19: ("accept", ""), 20: ("access-control-allow-origin", ""),
    21: ("age", ""), 22: ("allow", ""), 23: ("authorization", ""),
    24: ("cache-control", ""), 25: ("content-disposition", ""),
    26: ("content-encoding", ""), 27: ("content-language", ""),
    28: ("content-length", ""), 29: ("content-location", ""),
    30: ("content-range", ""), 31: ("content-type", ""), 32: ("cookie", ""),
    33: ("date", ""), 34: ("etag", ""), 35: ("expect", ""),
    36: ("expires", ""), 37: ("from", ""), 38: ("host", ""),
    39: ("if-match", ""), 40: ("if-modified-since", ""),
    41: ("if-none-match", ""), 42: ("if-range", ""),
    43: ("if-unmodified-since", ""), 44: ("last-modified", ""),
    45: ("link", ""), 46: ("location", ""), 47: ("max-forwards", ""),
    48: ("proxy-authenticate", ""), 49: ("proxy-authorization", ""),
    50: ("range", ""), 51: ("referer", ""), 52: ("refresh", ""),
    53: ("retry-after", ""), 54: ("server", ""), 55: ("set-cookie", ""),
    56: ("strict-transport-security", ""), 57: ("transfer-encoding", ""),
    58: ("user-agent", ""), 59: ("vary", ""), 60: ("via", ""),
    61: ("www-authenticate", ""),
}

_H2_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"


def _hpack_int(data: bytes, off: int, prefix: int) -> Tuple[int, int]:
    """Decode an HPACK prefix integer; returns (value, next_offset)."""
    mask = (1 << prefix) - 1
    v = data[off] & mask
    off += 1
    if v < mask:
        return v, off
    shift = 0
    while off < len(data):
        b = data[off]
        off += 1
        v += (b & 0x7F) << shift
        shift += 7
        if not (b & 0x80):
            break
    return v, off


def _hpack_str(data: bytes, off: int) -> Tuple[str, int]:
    huff = bool(data[off] & 0x80)
    ln, off = _hpack_int(data, off, 7)
    raw = data[off:off + ln]
    off += ln
    if huff:
        s = huffman_decode(raw)
        return (s if s is not None else raw.hex()), off
    return raw.decode("latin-1", "replace"), off


class HpackDecoder:
    """RFC 7541-complete HPACK decoder: static table + a real dynamic
    table with size-based eviction (§4.2; entry cost name+value+32).
    One instance per connection DIRECTION — HPACK state is per sender.
    The reference's http2 plugin carries equivalent per-session table
    state (agent/plugins/http2)."""

    _HARD_MAX = 1 << 16

    def __init__(self, max_size: int = 4096) -> None:
        self._dyn: "deque[Tuple[str, str]]" = deque()
        self._size = 0
        self._max = max_size

    def _entry(self, idx: int) -> Tuple[str, str]:
        if idx in _HPACK_STATIC:
            return _HPACK_STATIC[idx]
        d = idx - 62
        if 0 <= d < len(self._dyn):
            return self._dyn[d]          # newest-first (§2.3.2)
        return ("", "")

    def _add(self, name: str, val: str) -> None:
        self._dyn.appendleft((name, val))
        self._size += len(name) + len(val) + 32
        self._evict()

    def _evict(self) -> None:
        while self._size > self._max and self._dyn:
            n, v = self._dyn.pop()
            self._size -= len(n) + len(v) + 32

    def decode(self, block: bytes,
               max_headers: int = 64) -> List[Tuple[str, str]]:
        """Decode one header block. The WHOLE block is always consumed —
        a stateful decoder that stopped early (header cap) would let its
        dynamic table silently diverge from the sender's; past the cap,
        fields still process for their table side effects and are just
        not reported. A name index pointing at a missing dynamic entry
        (evicted here / lost packet) keeps WIRE SYNC: only the value
        string follows on the wire, so only the value is read and the
        name stays empty — never re-interpret the value as a name."""
        out: List[Tuple[str, str]] = []
        off = 0
        try:
            while off < len(block):
                b = block[off]
                if b & 0x80:                      # indexed field
                    idx, off = _hpack_int(block, off, 7)
                    if len(out) < max_headers:
                        out.append(self._entry(idx))
                elif b & 0x40:                    # literal, incremental idx
                    idx, off = _hpack_int(block, off, 6)
                    if idx:
                        name = self._entry(idx)[0]
                    else:
                        name, off = _hpack_str(block, off)
                    val, off = _hpack_str(block, off)
                    self._add(name, val)
                    if len(out) < max_headers:
                        out.append((name, val))
                elif b & 0x20:                    # dynamic table size upd
                    sz, off = _hpack_int(block, off, 5)
                    self._max = min(sz, self._HARD_MAX)
                    self._evict()
                else:                             # literal, no indexing
                    idx, off = _hpack_int(block, off, 4)
                    if idx:
                        name = self._entry(idx)[0]
                    else:
                        name, off = _hpack_str(block, off)
                    val, off = _hpack_str(block, off)
                    if len(out) < max_headers:
                        out.append((name, val))
        except (IndexError, struct.error):
            pass
        return out


def hpack_headers(block: bytes, max_headers: int = 64) -> List[Tuple[str, str]]:
    """Stateless HPACK decode: a fresh table per block. Incremental
    entries still resolve WITHIN the block; cross-frame references need
    the per-connection decoder (Http2Parser keeps one per direction)."""
    return HpackDecoder().decode(block, max_headers)


class Http2Parser:
    """HTTP/2 frames; HEADERS blocks decode via HPACK with a REAL
    per-connection-direction dynamic table (LRU of HpackDecoders keyed
    by the dispatch 4-tuple — cross-packet indexed references resolve).
    gRPC calls (content-type application/grpc*) report as
    L7Protocol.Grpc like the reference."""

    proto: ClassVar[int] = L7_HTTP2
    wants_ctx: ClassVar[bool] = True

    _FRAME_HEADERS = 0x1
    _MAX_CONNS = 512

    def __init__(self) -> None:
        self._conns: "OrderedDict[tuple, HpackDecoder]" = OrderedDict()

    def _decoder(self, key) -> HpackDecoder:
        if key is None:
            return HpackDecoder()        # ctx-less callers: stateless
        d = self._conns.get(key)
        if d is None:
            d = HpackDecoder()
            self._conns[key] = d
            while len(self._conns) > self._MAX_CONNS:
                self._conns.popitem(last=False)
        else:
            self._conns.move_to_end(key)
        return d

    def check(self, payload: bytes, proto=None, port_src: int = 0,
              port_dst: int = 0, ts_ns: int = 0, ip_src: int = 0,
              ip_dst: int = 0, ip_version: int = 4) -> bool:
        if payload.startswith(_H2_PREFACE):
            return True
        if len(payload) < 9:
            return False
        ln = int.from_bytes(payload[:3], "big")
        ftype = payload[3]
        # plausible first frame: SETTINGS(4)/HEADERS(1)/WINDOW_UPDATE(8)
        return ftype in (0x1, 0x4, 0x8) and ln <= 1 << 14 and \
            9 + ln <= len(payload) + (1 << 14)

    def parse(self, payload: bytes, proto=None, port_src: int = 0,
              port_dst: int = 0, ts_ns: int = 0, ip_src: int = 0,
              ip_dst: int = 0,
              ip_version: int = 4) -> Optional[L7Record]:
        # direction-scoped HPACK state: the sender's table
        key = ((ip_src, ip_dst, port_src, port_dst)
               if (ip_src or ip_dst or port_src or port_dst) else None)
        dec = self._decoder(key)
        off = 0
        if payload.startswith(_H2_PREFACE):
            off = len(_H2_PREFACE)
        # EVERY headers frame in the payload must be decoded — returning
        # at the first record would skip later frames' incremental-index
        # entries and silently desync the connection's dynamic table
        # from the sender's; the first record found is reported.
        rec: Optional[L7Record] = None
        while off + 9 <= len(payload):
            ln = int.from_bytes(payload[off:off + 3], "big")
            ftype = payload[off + 3]
            flags = payload[off + 4]
            body = payload[off + 9:off + 9 + ln]
            off += 9 + ln
            if ftype != self._FRAME_HEADERS:
                continue
            if flags & 0x8:                        # PADDED
                body = body[1:len(body) - body[0]] if body else body
            if flags & 0x20:                       # PRIORITY
                body = body[5:]
            # first occurrence wins on duplicates — the same proxy-chain
            # semantics parse_http_headers documents for HTTP/1, so one
            # request yields the same client_ip/trace id on either version
            hdrs: dict = {}
            for hk, hv in dec.decode(body):
                hdrs.setdefault(hk, hv)
            if rec is not None:
                continue                           # state only
            from deepflow_tpu_torch.agent import trace_context
            ids = trace_context.extract(hdrs)
            status = hdrs.get(":status")
            if status is not None:
                code = parse_int(status)
                rec = L7Record(self.proto, MSG_RESPONSE, status=code,
                               resp_len=len(payload), version="2",
                               trace_id=ids["trace_id"],
                               span_id=ids["span_id"],
                               x_request_id=ids["x_request_id"])
                continue
            method = hdrs.get(":method")
            if method is not None:
                full_path = hdrs.get(":path", "")
                path = full_path.split("?", 1)[0]
                proto_ = self.proto
                if hdrs.get("content-type", "").startswith(
                        "application/grpc"):
                    proto_ = L7_GRPC
                rec = L7Record(proto_, MSG_REQUEST,
                               endpoint=f"{method} {path}",
                               req_len=len(payload),
                               req_type=method,
                               domain=hdrs.get(":authority", ""),
                               resource=full_path, version="2",
                               user_agent=hdrs.get("user-agent", ""),
                               referer=hdrs.get("referer", ""),
                               trace_id=ids["trace_id"],
                               span_id=ids["span_id"],
                               x_request_id=ids["x_request_id"],
                               client_ip=ids["client_ip"])
        return rec


# ---------------------------------------------------------------------------
# Kafka (reference: protocol_logs/mq/kafka.rs)
# ---------------------------------------------------------------------------

_KAFKA_APIS = {
    0: "Produce", 1: "Fetch", 2: "ListOffsets", 3: "Metadata",
    8: "OffsetCommit", 9: "OffsetFetch", 10: "FindCoordinator",
    11: "JoinGroup", 12: "Heartbeat", 13: "LeaveGroup", 14: "SyncGroup",
    15: "DescribeGroups", 16: "ListGroups", 17: "SaslHandshake",
    18: "ApiVersions", 19: "CreateTopics", 20: "DeleteTopics",
}


class KafkaParser:
    """Kafka request/response headers. Requests carry api_key + client_id;
    responses are matched FIFO per flow (correlation id is recorded as
    status 0 — error codes live per-partition in the body)."""

    proto: ClassVar[int] = L7_KAFKA
    _MAX_API = 67

    def check(self, payload: bytes) -> bool:
        if len(payload) < 12:
            return False
        ln = struct.unpack_from(">i", payload)[0]
        if not (8 <= ln <= 1 << 24):
            return False
        api_key, api_ver = struct.unpack_from(">hh", payload, 4)
        if 0 <= api_key <= self._MAX_API and 0 <= api_ver <= 20:
            return True
        # response: length + correlation id only — accept when the frame
        # length matches the payload exactly (strong signal)
        return ln + 4 == len(payload)

    def parse(self, payload: bytes) -> Optional[L7Record]:
        ln = struct.unpack_from(">i", payload)[0]
        api_key, api_ver = struct.unpack_from(">hh", payload, 4)
        if 0 <= api_key <= self._MAX_API and 0 <= api_ver <= 20 \
                and len(payload) >= 14:
            client_len = struct.unpack_from(">h", payload, 12)[0]
            client = ""
            if 0 < client_len <= 255 and 14 + client_len <= len(payload):
                client = payload[14:14 + client_len].decode("latin-1",
                                                            "replace")
            api = _KAFKA_APIS.get(api_key, f"Api{api_key}")
            ep = f"{api}" + (f" {client}" if client else "")
            return L7Record(self.proto, MSG_REQUEST, endpoint=ep,
                            req_len=len(payload))
        if ln + 4 == len(payload):
            return L7Record(self.proto, MSG_RESPONSE, status=0,
                            resp_len=len(payload))
        return None


# ---------------------------------------------------------------------------
# PostgreSQL (reference: protocol_logs/sql/postgresql.rs)
# ---------------------------------------------------------------------------

class PostgresParser:
    """PostgreSQL extended/simple protocol messages. Query statements are
    obfuscated (sql_obfuscate.py) before becoming the endpoint."""

    proto: ClassVar[int] = L7_POSTGRESQL
    _REQ = frozenset(b"QPBEDCFfSX")
    _RESP = frozenset(b"RSKZTDCEINV123nst")

    def check(self, payload: bytes) -> bool:
        if len(payload) < 5:
            return False
        t = payload[0]
        if t not in self._REQ and t not in self._RESP:
            # startup: int32 len + protocol version 3.0
            if len(payload) >= 8:
                ln, ver = struct.unpack_from(">ii", payload)
                return ln == len(payload) and ver == 0x0003_0000
            return False
        ln = struct.unpack_from(">i", payload, 1)[0]
        return 4 <= ln <= (1 << 24)

    def parse(self, payload: bytes) -> Optional[L7Record]:
        t = payload[0:1]
        if t == b"Q" and len(payload) > 5:            # simple query
            stmt = payload[5:].rstrip(b"\x00")
            return L7Record(
                self.proto, MSG_REQUEST,
                endpoint=f"{sql_verb(stmt)} {obfuscate_sql(stmt)}"[:128],
                req_len=len(payload))
        if t == b"P" and len(payload) > 5:            # Parse (prepared)
            body = payload[5:]
            nul = body.find(b"\x00")                  # statement name
            stmt = body[nul + 1:body.find(b"\x00", nul + 1)] \
                if nul >= 0 else b""
            return L7Record(
                self.proto, MSG_REQUEST,
                endpoint=f"{sql_verb(stmt)} {obfuscate_sql(stmt)}"[:128],
                req_len=len(payload))
        if t in (b"B", b"E", b"D", b"C", b"F", b"S", b"X"):
            return L7Record(self.proto, MSG_REQUEST, endpoint="",
                            req_len=len(payload))
        if t in (b"T", b"Z", b"K", b"R", b"I", b"n", b"s", b"1", b"2",
                 b"3", b"V"):
            return L7Record(self.proto, MSG_RESPONSE, status=0,
                            resp_len=len(payload))
        if len(payload) >= 8 and \
                struct.unpack_from(">i", payload, 0)[0] == len(payload):
            return L7Record(self.proto, MSG_REQUEST, endpoint="startup",
                            req_len=len(payload))
        return None


class PostgresErrorParser:
    """ErrorResponse ('E') conflicts with Execute ('E' request); split so
    server->client error frames rank as responses with status=1. The
    session layer orients by msg_type, so a dedicated parser keyed on the
    severity field keeps the two apart."""

    proto: ClassVar[int] = L7_POSTGRESQL

    def check(self, payload: bytes) -> bool:
        return len(payload) > 6 and payload[0:1] == b"E" and \
            payload[5:6] == b"S"  # severity field marker

    def parse(self, payload: bytes) -> Optional[L7Record]:
        sev_end = payload.find(b"\x00", 6)
        severity = payload[6:sev_end].decode("latin-1", "replace") \
            if sev_end > 0 else ""
        status = 1 if severity in ("ERROR", "FATAL", "PANIC") else 0
        return L7Record(self.proto, MSG_RESPONSE, endpoint=severity,
                        status=status, resp_len=len(payload))


# ---------------------------------------------------------------------------
# MongoDB (reference: protocol_logs/sql/mongo.rs)
# ---------------------------------------------------------------------------

class MongoParser:
    """Mongo wire protocol: OP_MSG (2013) / OP_QUERY (2004) / OP_REPLY.
    endpoint = the command name (first BSON key of section 0)."""

    proto: ClassVar[int] = L7_MONGODB
    _OPS = {1: "OP_REPLY", 2004: "OP_QUERY", 2005: "OP_GET_MORE",
            2010: "OP_COMMAND", 2011: "OP_COMMANDREPLY", 2013: "OP_MSG"}

    def check(self, payload: bytes) -> bool:
        if len(payload) < 16:
            return False
        msg_len, _req, _resp, opcode = struct.unpack_from("<iiii", payload)
        return 16 <= msg_len <= (1 << 25) and opcode in self._OPS

    @staticmethod
    def _first_bson_key(doc: bytes) -> str:
        if len(doc) < 5:
            return ""
        etype = doc[4]
        if etype == 0:
            return ""
        end = doc.find(b"\x00", 5)
        return doc[5:end].decode("latin-1", "replace") if end > 0 else ""

    def parse(self, payload: bytes) -> Optional[L7Record]:
        _len, _req, resp_to, opcode = struct.unpack_from("<iiii", payload)
        is_resp = resp_to != 0 or opcode in (1, 2011)
        cmd = ""
        if opcode == 2013 and len(payload) >= 21:     # OP_MSG
            # flagBits u32 then section kind 0 + BSON
            if payload[20] == 0:
                cmd = self._first_bson_key(payload[21:])
        elif opcode == 2004:                          # OP_QUERY
            # flags u32, then cstring collection name
            end = payload.find(b"\x00", 20)
            if end > 0:
                cmd = payload[20:end].decode("latin-1", "replace")
        if is_resp:
            return L7Record(self.proto, MSG_RESPONSE, endpoint=cmd,
                            status=0, resp_len=len(payload))
        return L7Record(self.proto, MSG_REQUEST, endpoint=cmd,
                        req_len=len(payload))


# ---------------------------------------------------------------------------
# Dubbo (reference: protocol_logs/rpc/dubbo.rs)
# ---------------------------------------------------------------------------

class DubboParser:
    """Dubbo framed protocol (magic 0xdabb). Hessian2-serialized request
    bodies open with small strings: dubbo version, service path, service
    version, method — parsed as the length-prefixed run the reference's
    hessian walker reads."""

    proto: ClassVar[int] = L7_DUBBO

    def check(self, payload: bytes) -> bool:
        return len(payload) >= 16 and payload[:2] == b"\xda\xbb"

    @staticmethod
    def _hessian_strings(body: bytes, limit: int = 4) -> List[str]:
        out: List[str] = []
        off = 0
        while off < len(body) and len(out) < limit:
            b = body[off]
            if b <= 0x1F:                   # short utf8 string
                s = body[off + 1:off + 1 + b]
                if len(s) < b:
                    break
                out.append(s.decode("utf-8", "replace"))
                off += 1 + b
            elif 0x30 <= b <= 0x33 and off + 1 < len(body):  # medium str
                ln = ((b - 0x30) << 8) + body[off + 1]
                s = body[off + 2:off + 2 + ln]
                if len(s) < ln:
                    break
                out.append(s.decode("utf-8", "replace"))
                off += 2 + ln
            else:
                break
        return out

    def parse(self, payload: bytes) -> Optional[L7Record]:
        flags, status = payload[2], payload[3]
        is_req = bool(flags & 0x80)
        is_event = bool(flags & 0x20)
        if is_event:
            return None                       # heartbeats aren't log rows
        if is_req:
            strings = self._hessian_strings(payload[16:])
            ep = ""
            if len(strings) >= 4:
                ep = f"{strings[1]}.{strings[3]}"      # service.method
            elif len(strings) >= 2:
                ep = strings[1]
            return L7Record(self.proto, MSG_REQUEST, endpoint=ep,
                            req_len=len(payload))
        # response: status 20 = OK (reference maps others to error)
        return L7Record(self.proto, MSG_RESPONSE,
                        status=0 if status == 20 else 1,
                        resp_len=len(payload))


# ---------------------------------------------------------------------------
# MQTT (reference: protocol_logs/mq/mqtt.rs)
# ---------------------------------------------------------------------------

class MqttParser:
    """MQTT 3.1/3.1.1/5 control packets. endpoint = topic (PUBLISH) or
    client id (CONNECT)."""

    proto: ClassVar[int] = L7_MQTT
    _REQ_TYPES = {1: "CONNECT", 3: "PUBLISH", 8: "SUBSCRIBE",
                  10: "UNSUBSCRIBE", 12: "PINGREQ", 14: "DISCONNECT"}
    _RESP_TYPES = {2: "CONNACK", 4: "PUBACK", 9: "SUBACK",
                   11: "UNSUBACK", 13: "PINGRESP"}

    @staticmethod
    def _remaining_len(payload: bytes) -> Tuple[int, int]:
        """(value, header_len) of the MQTT varint; (-1, 0) on overflow."""
        v = 0
        for i in range(1, min(5, len(payload))):
            b = payload[i]
            v |= (b & 0x7F) << (7 * (i - 1))
            if not (b & 0x80):
                return v, i + 1
        return -1, 0

    def check(self, payload: bytes) -> bool:
        if len(payload) < 2:
            return False
        ptype = payload[0] >> 4
        if ptype == 0 or ptype == 15:
            return False
        rl, hl = self._remaining_len(payload)
        if rl < 0 or hl + rl != len(payload):
            return False
        if ptype == 1:                        # CONNECT: protocol name
            return payload[hl + 2:hl + 6] in (b"MQTT", b"MQIs")
        return True

    def parse(self, payload: bytes) -> Optional[L7Record]:
        ptype = payload[0] >> 4
        rl, hl = self._remaining_len(payload)
        if ptype == 1:                         # CONNECT
            name_len = struct.unpack_from(">H", payload, hl)[0]
            off = hl + 2 + name_len + 4        # + version + flags + keepal
            cid = ""
            if off + 2 <= len(payload):
                cid_len = struct.unpack_from(">H", payload, off)[0]
                cid = payload[off + 2:off + 2 + cid_len] \
                    .decode("latin-1", "replace")
            return L7Record(self.proto, MSG_REQUEST, endpoint=cid,
                            req_len=len(payload))
        if ptype == 3:                         # PUBLISH
            tlen = struct.unpack_from(">H", payload, hl)[0]
            topic = payload[hl + 2:hl + 2 + tlen].decode("latin-1",
                                                         "replace")
            return L7Record(self.proto, MSG_REQUEST, endpoint=topic,
                            req_len=len(payload))
        if ptype == 2:                         # CONNACK: return code
            code = payload[hl + 1] if hl + 1 < len(payload) else 0
            return L7Record(self.proto, MSG_RESPONSE, status=code,
                            resp_len=len(payload))
        if ptype in self._RESP_TYPES:
            return L7Record(self.proto, MSG_RESPONSE, status=0,
                            resp_len=len(payload))
        if ptype in self._REQ_TYPES:
            return L7Record(self.proto, MSG_REQUEST,
                            endpoint=self._REQ_TYPES[ptype],
                            req_len=len(payload))
        return None


# ---------------------------------------------------------------------------
# AMQP 0-9-1 (reference: protocol_logs/mq/amqp.rs)
# ---------------------------------------------------------------------------

_AMQP_METHODS = {
    (10, 10): "connection.start", (10, 11): "connection.start-ok",
    (10, 30): "connection.tune", (10, 31): "connection.tune-ok",
    (10, 40): "connection.open", (10, 41): "connection.open-ok",
    (10, 50): "connection.close", (10, 51): "connection.close-ok",
    (20, 10): "channel.open", (20, 11): "channel.open-ok",
    (20, 40): "channel.close", (20, 41): "channel.close-ok",
    (40, 10): "exchange.declare", (40, 11): "exchange.declare-ok",
    (50, 10): "queue.declare", (50, 11): "queue.declare-ok",
    (50, 20): "queue.bind", (50, 21): "queue.bind-ok",
    (60, 10): "basic.qos", (60, 11): "basic.qos-ok",
    (60, 20): "basic.consume", (60, 21): "basic.consume-ok",
    (60, 40): "basic.publish", (60, 50): "basic.return",
    (60, 60): "basic.deliver", (60, 70): "basic.get",
    (60, 71): "basic.get-ok", (60, 80): "basic.ack",
}


class AmqpParser:
    proto: ClassVar[int] = L7_AMQP

    def check(self, payload: bytes) -> bool:
        if payload.startswith(b"AMQP\x00"):
            return True
        if len(payload) < 8 or payload[0] not in (1, 2, 3, 8):
            return False
        size = struct.unpack_from(">I", payload, 3)[0]
        end = 7 + size
        return end < len(payload) + 1 and size < (1 << 24) and \
            (end >= len(payload) or payload[end] == 0xCE)

    def parse(self, payload: bytes) -> Optional[L7Record]:
        if payload.startswith(b"AMQP\x00"):
            return L7Record(self.proto, MSG_REQUEST,
                            endpoint="protocol-header",
                            req_len=len(payload))
        ftype = payload[0]
        if ftype != 1:                         # content header/body frames
            return None
        cls_id, meth_id = struct.unpack_from(">HH", payload, 7)
        name = _AMQP_METHODS.get((cls_id, meth_id),
                                 f"{cls_id}.{meth_id}")
        # -ok/deliver/return frames travel server->client
        is_resp = name.endswith("-ok") or name in ("basic.deliver",
                                                   "basic.return")
        if is_resp:
            return L7Record(self.proto, MSG_RESPONSE, endpoint=name,
                            status=0, resp_len=len(payload))
        return L7Record(self.proto, MSG_REQUEST, endpoint=name,
                        req_len=len(payload))


# ---------------------------------------------------------------------------
# NATS (reference: protocol_logs/mq/nats.rs)
# ---------------------------------------------------------------------------

class NatsParser:
    proto: ClassVar[int] = L7_NATS
    _REQ = (b"PUB ", b"SUB ", b"UNSUB ", b"CONNECT ", b"HPUB ")
    _RESP = (b"MSG ", b"HMSG ", b"INFO ", b"+OK", b"-ERR", b"PONG")

    def check(self, payload: bytes) -> bool:
        return payload.startswith(self._REQ + self._RESP + (b"PING",))

    def parse(self, payload: bytes) -> Optional[L7Record]:
        line, _, _ = payload.partition(b"\r\n")
        parts = line.decode("latin-1", "replace").split(" ")
        verb = parts[0]
        if verb in ("PUB", "HPUB", "SUB", "UNSUB"):
            subject = parts[1] if len(parts) > 1 else ""
            return L7Record(self.proto, MSG_REQUEST,
                            endpoint=f"{verb} {subject}",
                            req_len=len(payload))
        if verb in ("CONNECT", "PING"):
            return L7Record(self.proto, MSG_REQUEST, endpoint=verb,
                            req_len=len(payload))
        if verb in ("MSG", "HMSG"):
            subject = parts[1] if len(parts) > 1 else ""
            return L7Record(self.proto, MSG_RESPONSE,
                            endpoint=f"MSG {subject}",
                            resp_len=len(payload))
        if verb == "-ERR":
            return L7Record(self.proto, MSG_RESPONSE, status=1,
                            resp_len=len(payload))
        return L7Record(self.proto, MSG_RESPONSE, status=0,
                        resp_len=len(payload))


# ---------------------------------------------------------------------------
# OpenWire / ActiveMQ (reference: protocol_logs/mq/openwire.rs)
# ---------------------------------------------------------------------------

class OpenWireParser:
    """Length-prefixed OpenWire commands; WIREFORMAT_INFO carries the
    ActiveMQ magic. Producer/consumer data types from the OpenWire v12
    command ids the reference handles."""

    proto: ClassVar[int] = L7_OPENWIRE
    _TYPES = {1: "WireFormatInfo", 2: "BrokerInfo", 3: "ConnectionInfo",
              4: "SessionInfo", 5: "ConsumerInfo", 6: "ProducerInfo",
              23: "Message", 24: "ActiveMQBytesMessage",
              25: "ActiveMQMapMessage", 27: "ActiveMQTextMessage",
              30: "Response", 31: "ExceptionResponse",
              10: "KeepAliveInfo", 11: "ShutdownInfo"}

    def check(self, payload: bytes) -> bool:
        if len(payload) < 5:
            return False
        ln = struct.unpack_from(">I", payload)[0]
        dtype = payload[4]
        if dtype == 1:
            return payload[5:24].find(b"ActiveMQ") >= 0
        # whole-command frames: the length prefix must match exactly,
        # else HTTP/2 frame headers (00 00 xx type ...) false-positive
        return dtype in self._TYPES and ln + 4 == len(payload) \
            and ln < (1 << 24)

    def parse(self, payload: bytes) -> Optional[L7Record]:
        dtype = payload[4]
        name = self._TYPES.get(dtype, f"type{dtype}")
        if dtype in (30, 31):
            return L7Record(self.proto, MSG_RESPONSE, endpoint=name,
                            status=0 if dtype == 30 else 1,
                            resp_len=len(payload))
        return L7Record(self.proto, MSG_REQUEST, endpoint=name,
                        req_len=len(payload))


# ---------------------------------------------------------------------------
# FastCGI (reference: protocol_logs/rpc/fastcgi.rs)
# ---------------------------------------------------------------------------

class FastCgiParser:
    """FastCGI records. PARAMS carry the CGI environment; endpoint is
    REQUEST_METHOD + SCRIPT_NAME like the reference's http-over-fcgi
    reconstruction."""

    proto: ClassVar[int] = L7_FASTCGI
    _BEGIN, _PARAMS, _STDIN, _STDOUT, _END = 1, 4, 5, 6, 3

    def check(self, payload: bytes) -> bool:
        return len(payload) >= 8 and payload[0] == 1 and \
            1 <= payload[1] <= 11

    @staticmethod
    def _params(body: bytes) -> Dict[str, str]:
        out: Dict[str, str] = {}
        off = 0
        try:
            while off < len(body) and len(out) < 64:
                nl = body[off]
                if nl >> 7:
                    nl = struct.unpack_from(">I", body, off)[0] & 0x7FFFFFFF
                    off += 4
                else:
                    off += 1
                vl = body[off]
                if vl >> 7:
                    vl = struct.unpack_from(">I", body, off)[0] & 0x7FFFFFFF
                    off += 4
                else:
                    off += 1
                name = body[off:off + nl].decode("latin-1", "replace")
                off += nl
                out[name] = body[off:off + vl].decode("latin-1", "replace")
                off += vl
        except (IndexError, struct.error):
            pass
        return out

    def parse(self, payload: bytes) -> Optional[L7Record]:
        off = 0
        params: Dict[str, str] = {}
        saw_stdout = saw_end = False
        while off + 8 <= len(payload):
            rtype = payload[off + 1]
            clen = struct.unpack_from(">H", payload, off + 4)[0]
            plen = payload[off + 6]
            body = payload[off + 8:off + 8 + clen]
            off += 8 + clen + plen
            if rtype == self._PARAMS and clen:
                params.update(self._params(body))
            elif rtype == self._STDOUT and clen:
                saw_stdout = True
                m = re.search(rb"Status:\s*(\d{3})", body)
                status = int(m.group(1)) if m else 200
                return L7Record(self.proto, MSG_RESPONSE, status=status,
                                resp_len=len(payload))
            elif rtype == self._END:
                saw_end = True
        if params:
            ep = f"{params.get('REQUEST_METHOD', '')} " \
                 f"{params.get('SCRIPT_NAME', params.get('REQUEST_URI', ''))}"
            return L7Record(self.proto, MSG_REQUEST, endpoint=ep.strip(),
                            req_len=len(payload))
        if saw_stdout or saw_end:
            return L7Record(self.proto, MSG_RESPONSE, status=0,
                            resp_len=len(payload))
        return L7Record(self.proto, MSG_REQUEST, endpoint="",
                        req_len=len(payload))


# ---------------------------------------------------------------------------
# SofaRPC / bolt (reference: protocol_logs/rpc/sofa_rpc.rs)
# ---------------------------------------------------------------------------

class SofaRpcParser:
    """Bolt v1 frames. endpoint = header service + sofa method name,
    pulled from the classname/header region the reference reads."""

    proto: ClassVar[int] = L7_SOFARPC

    def check(self, payload: bytes) -> bool:
        # bolt v1: request headers are 22 bytes, response headers 20
        if len(payload) < 20 or payload[0] != 1:
            return False
        return payload[1] in (0, 1, 2)                 # resp/req/req-oneway

    def parse(self, payload: bytes) -> Optional[L7Record]:
        ptype = payload[1]
        if ptype in (1, 2):                            # request
            class_len, header_len = struct.unpack_from(">HH", payload, 14)
            content_len = struct.unpack_from(">I", payload, 18)[0]
            if 22 + class_len + header_len > len(payload) or \
                    content_len > (1 << 24):
                return None
            off = 22 + class_len
            header = payload[off:off + header_len]
            kv = {}
            parts = header.split(b"\x00")
            for i in range(0, len(parts) - 1, 2):
                kv[parts[i].decode("latin-1", "replace")] = \
                    parts[i + 1].decode("latin-1", "replace")
            service = kv.get("sofa_head_target_service", "")
            method = kv.get("sofa_head_method_name", "")
            ep = f"{service}.{method}" if service or method else \
                payload[22:22 + class_len].decode("latin-1", "replace")
            return L7Record(self.proto, MSG_REQUEST, endpoint=ep,
                            req_len=len(payload))
        # response: resp status u16 at offset 10 (0 = success)
        status = struct.unpack_from(">H", payload, 10)[0]
        return L7Record(self.proto, MSG_RESPONSE,
                        status=0 if status == 0 else 1,
                        resp_len=len(payload))


EXTENDED_PARSERS: List = [
    # magic-byte protocols first: their checks can't false-positive
    TlsParser(), DubboParser(), OpenWireParser(), SofaRpcParser(),
    Http2Parser(), MongoParser(), AmqpParser(), NatsParser(),
    MqttParser(), FastCgiParser(), PostgresErrorParser(), PostgresParser(),
    KafkaParser(),
]


def register_extended(parsers_list: List) -> None:
    """Append the extended set to an l7.PARSERS-style registry, keeping
    the four original parsers (HTTP/1, DNS, MySQL, Redis) in front: their
    checks are the cheapest and their traffic the most common."""
    known = {type(p) for p in parsers_list}
    for p in EXTENDED_PARSERS:
        if type(p) not in known:
            parsers_list.append(p)


# ---------------------------------------------------------------------------
# Oracle TNS (reference: protocol_logs/sql/oracle.rs — whose OSS build
# stubs the parse out to an enterprise crate; this is a clean-room
# parser of the PUBLIC TNS wire format, so the open build here covers
# more than the reference's open build does)
# ---------------------------------------------------------------------------

L7_ORACLE = 62

# TNS packet types (public protocol)
_TNS_CONNECT = 1
_TNS_ACCEPT = 2
_TNS_REFUSE = 4
_TNS_REDIRECT = 5
_TNS_DATA = 6
_TNS_MARKER = 12

# TTI data ids seen at the start of DATA payloads (oracle.rs:72 names
# 0x03 user-OCI-function); call ids for the common statement path
_OCI_CALLS = {
    0x02: "OPEN", 0x03: "QUERY", 0x04: "EXECUTE", 0x05: "FETCH",
    0x08: "CLOSE", 0x09: "DISCONNECT", 0x0c: "AUTOCOMMIT",
    0x3b: "VERSION", 0x5e: "QUERY", 0x60: "LOB_OP", 0x76: "AUTH",
    0x73: "AUTH_SESSION",
}


class OracleParser:
    """TNS framing + the session-visible verbs.

    CONNECT extracts SERVICE_NAME from the connect descriptor as the
    endpoint; ACCEPT/REFUSE close the handshake (REFUSE carries the
    refusal reason string); DATA packets report the OCI function when
    the payload opens with the user-OCI data id, with embedded SQL text
    obfuscated through the shared sql_obfuscate pass."""

    proto: ClassVar[int] = L7_ORACLE
    _MAX_LEN = 1 << 16

    def check(self, payload: bytes) -> bool:
        if len(payload) < 8:
            return False
        ln = struct.unpack_from(">H", payload)[0]
        ptype = payload[4]
        if ptype not in (_TNS_CONNECT, _TNS_ACCEPT, _TNS_REFUSE,
                         _TNS_REDIRECT, _TNS_DATA, _TNS_MARKER):
            return False
        if not (8 <= ln <= self._MAX_LEN):
            return False
        # CONNECT must carry a descriptor; DATA needs the 2-byte flags
        if ptype == _TNS_CONNECT:
            return len(payload) >= 34 and b"(" in payload[8:]
        # other types: the frame length must be plausible vs the capture
        return ln <= len(payload) + self._MAX_LEN // 2

    @staticmethod
    def _descriptor_field(text: bytes, key: bytes) -> str:
        i = text.find(key + b"=")
        if i < 0:
            return ""
        j = i + len(key) + 1
        end = j
        while end < len(text) and text[end:end + 1] not in (b")", b"("):
            end += 1
        return text[j:end].decode("latin-1", "replace").strip()

    def parse(self, payload: bytes) -> Optional[L7Record]:
        ptype = payload[4]
        if ptype == _TNS_CONNECT:
            svc = self._descriptor_field(payload[8:], b"SERVICE_NAME") \
                or self._descriptor_field(payload[8:], b"SID")
            return L7Record(self.proto, MSG_REQUEST,
                            endpoint=f"CONNECT {svc}".strip(),
                            req_len=len(payload))
        if ptype == _TNS_ACCEPT:
            return L7Record(self.proto, MSG_RESPONSE, status=0,
                            resp_len=len(payload))
        if ptype == _TNS_REFUSE:
            reason = self._descriptor_field(payload[8:], b"ERR")
            code = parse_int(reason, default=1)
            return L7Record(self.proto, MSG_RESPONSE, status=code,
                            endpoint="REFUSED", resp_len=len(payload))
        if ptype != _TNS_DATA or len(payload) < 11:
            return None                    # markers/redirects: not log events
        data = payload[10:]                # skip 2-byte data flags
        if not data:
            return None
        data_id = data[0]
        if data_id == 0x03 and len(data) >= 2:     # user OCI function
            call = _OCI_CALLS.get(data[1], f"CALL_{data[1]:02x}")
            # statement text rides in the TTI payload surrounded by
            # binary TTC fields and bind data: bound the slice at the
            # first non-printable byte BEFORE obfuscating, so control
            # bytes and out-of-band bind values (PII) can never leak
            # into the endpoint
            tail = data[2:]
            end = 0
            while end < len(tail) and 0x20 <= tail[end] < 0x7F:
                end += 1
            text = tail[:end]
            verb = sql_verb(text)
            sql = obfuscate_sql(text) if verb else ""
            endpoint = (f"{call} {sql}".strip() if sql else call)[:128]
            return L7Record(self.proto, MSG_REQUEST, endpoint=endpoint,
                            req_len=len(payload))
        if data_id == 0x04 and len(data) >= 5:     # return status
            # sequence# then a u16 return code in the common layout
            code = struct.unpack_from(">H", data, 3)[0]
            return L7Record(self.proto, MSG_RESPONSE, status=code,
                            resp_len=len(payload))
        return None


# registered last: the TNS check is structural (type byte + frame
# length) rather than magic-byte, so every stronger check goes first
EXTENDED_PARSERS.append(OracleParser())
