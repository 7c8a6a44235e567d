"""Batched protobuf record packing inside a frame payload.

The agent packs N records per frame, each as `| pb_len u32 LE | pb bytes |`
(reference: server/libs/codec/simple_codec.go WritePB/ReadPB). The decoders
of decode/columnar.py read records through `iter_pb_records`.
"""

from __future__ import annotations

import struct
from typing import Iterable, Iterator

_LEN = struct.Struct("<I")


def pack_pb_records(records: Iterable[bytes]) -> bytes:
    """Length-prefix and concatenate serialized protobuf records."""
    parts = []
    for r in records:
        parts.append(_LEN.pack(len(r)))
        parts.append(r)
    return b"".join(parts)


def iter_pb_records(payload: bytes) -> Iterator[bytes]:
    """Yield raw protobuf record bytes from a frame payload."""
    off = 0
    n = len(payload)
    while off + 4 <= n:
        (size,) = _LEN.unpack_from(payload, off)
        off += 4
        if off + size > n:
            raise ValueError(f"truncated record at offset {off}: need {size}")
        yield payload[off:off + size]
        off += size
    if off != n:
        raise ValueError(f"trailing garbage: {n - off} bytes")
