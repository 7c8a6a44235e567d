"""Firehose frame format, wire-compatible with the DeepFlow agent sender.

Layout (reference: server/libs/datatype/droplet-message.go:124-190 and
agent/src/sender/uniform_sender.rs:83-175):

    BaseHeader:  | frame_size u32 BE | msg_type u8 |        (5 bytes)
    FlowHeader:  | version u32 LE | sequence u64 LE | vtap_id u16 LE | (14 bytes)
    payload:     length-prefixed protobuf records (see codec.py)

frame_size includes the BaseHeader itself. FlowHeader is present only for
vtap-typed messages (TAGGEDFLOW / PROTOCOLLOG / METRICS / ...).
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass
from typing import Iterator, Optional

MESSAGE_FRAME_SIZE_MAX = 512_000           # droplet-message.go:127
MESSAGE_HEADER_LEN = 5
FLOW_HEADER_LEN = 14

# Bit 30 of FlowHeader.version marks a sender-ring RETRANSMIT (the
# uniform sender's reconnect replay): delivery of frames sent
# just before a connection died is unknowable without acks, so the ring
# re-sends them flagged and the receiver dedups flagged frames whose
# sequence it has already dispatched. Reference agents never set the
# bit (their version constant keeps it clear), so unflagged streams
# keep the plain restart-reset sequence semantics.
FLOW_HEADER_RETRANSMIT = 1 << 30

_VERSION_U32 = struct.Struct("<I")


def set_retransmit(frame: bytes) -> bytes:
    """Set FLOW_HEADER_RETRANSMIT in an already-encoded frame's
    FlowHeader version word. Lives HERE, beside `_FLOW`, because it
    patches that struct's byte layout (u32 LE at the head of the flow
    header) — idempotent, so a frame surviving several reconnects is
    patched once."""
    v, = _VERSION_U32.unpack_from(frame, MESSAGE_HEADER_LEN)
    return (frame[:MESSAGE_HEADER_LEN]
            + _VERSION_U32.pack(v | FLOW_HEADER_RETRANSMIT)
            + frame[MESSAGE_HEADER_LEN + _VERSION_U32.size:])

_BASE = struct.Struct(">IB")               # frame_size BE, type
_FLOW = struct.Struct("<IQH")              # version, sequence, vtap_id LE


class MessageType(enum.IntEnum):
    """Wire message type ids (reference: libs/datatype/droplet-message.go:35-53)."""

    COMPRESS = 0
    SYSLOG = 1
    STATSD = 2
    METRICS = 3
    TAGGEDFLOW = 4
    PROTOCOLLOG = 5
    OPENTELEMETRY = 6
    PROMETHEUS = 7
    TELEGRAF = 8
    PACKETSEQUENCE = 9
    DFSTATS = 10
    OPENTELEMETRY_COMPRESSED = 11
    RAW_PCAP = 12
    PROFILE = 13
    PROC_EVENT = 14
    ALARM_EVENT = 15
    # Extension beyond the reference id space (reference stops at 15):
    # planar column batches, the columnar fast wire format
    # (wire/columnar_wire.py). Decode is a memcpy, not a
    # protobuf walk, the same escape hatch the reference takes with its
    # raw little-endian simple_codec.go writers for Documents.
    COLUMNAR_FLOW = 16

    @property
    def has_flow_header(self) -> bool:
        # HEADER_TYPE_LT_VTAP set (reference: droplet-message.go:97-115 —
        # COMPRESS/SYSLOG/STATSD are the only header-less types)
        return self in (
            MessageType.METRICS,
            MessageType.TAGGEDFLOW,
            MessageType.PROTOCOLLOG,
            MessageType.OPENTELEMETRY,
            MessageType.PROMETHEUS,
            MessageType.TELEGRAF,
            MessageType.PACKETSEQUENCE,
            MessageType.DFSTATS,
            MessageType.OPENTELEMETRY_COMPRESSED,
            MessageType.RAW_PCAP,
            MessageType.PROFILE,
            MessageType.PROC_EVENT,
            MessageType.ALARM_EVENT,
            MessageType.COLUMNAR_FLOW,
        )


@dataclass
class BaseHeader:
    frame_size: int
    msg_type: MessageType

    def encode(self) -> bytes:
        return _BASE.pack(self.frame_size, int(self.msg_type))

    @classmethod
    def decode(cls, buf: bytes) -> "BaseHeader":
        size, t = _BASE.unpack_from(buf)
        if size > MESSAGE_FRAME_SIZE_MAX:
            raise ValueError(f"frame size {size} exceeds max {MESSAGE_FRAME_SIZE_MAX}")
        try:
            mt = MessageType(t)
        except ValueError:
            raise ValueError(f"unknown message type {t}") from None
        min_size = MESSAGE_HEADER_LEN + (FLOW_HEADER_LEN if mt.has_flow_header else 0)
        if size < min_size:
            raise ValueError(
                f"frame size {size} below minimum {min_size} for type {mt.name}")
        return cls(frame_size=size, msg_type=mt)


@dataclass
class FlowHeader:
    version: int = 20220117
    sequence: int = 0
    vtap_id: int = 0

    def encode(self) -> bytes:
        return _FLOW.pack(self.version, self.sequence, self.vtap_id)

    @classmethod
    def decode(cls, buf: bytes) -> "FlowHeader":
        v, s, vid = _FLOW.unpack_from(buf)
        return cls(version=v, sequence=s, vtap_id=vid)


def encode_frame(msg_type: MessageType, payload: bytes,
                 flow_header: Optional[FlowHeader] = None) -> bytes:
    """Build one wire frame; payload is the already-packed record batch."""
    fh = b""
    if msg_type.has_flow_header:
        fh = (flow_header or FlowHeader()).encode()
    size = MESSAGE_HEADER_LEN + len(fh) + len(payload)
    if size > MESSAGE_FRAME_SIZE_MAX:
        raise ValueError(f"frame too large: {size}")
    return BaseHeader(size, msg_type).encode() + fh + payload


@dataclass
class Frame:
    msg_type: MessageType
    flow_header: Optional[FlowHeader]
    payload: bytes


class FrameReader:
    """Incremental frame parser over a TCP byte stream.

    Feed arbitrary chunks; yields complete frames. Mirrors the reference's
    "collect frame_size bytes, then decode" TCP loop
    (server/libs/receiver/receiver.go ProcessTCPConnection).
    """

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, chunk: bytes) -> Iterator[Frame]:
        self._buf.extend(chunk)
        while True:
            if len(self._buf) < MESSAGE_HEADER_LEN:
                return
            base = BaseHeader.decode(bytes(self._buf[:MESSAGE_HEADER_LEN]))
            if len(self._buf) < base.frame_size:
                return
            body = bytes(self._buf[MESSAGE_HEADER_LEN:base.frame_size])
            del self._buf[:base.frame_size]
            fh = None
            if base.msg_type.has_flow_header:
                fh = FlowHeader.decode(body[:FLOW_HEADER_LEN])
                body = body[FLOW_HEADER_LEN:]
            yield Frame(msg_type=base.msg_type, flow_header=fh, payload=body)
