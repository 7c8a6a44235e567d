"""Minimal pure-Python snappy block-format decompressor.

Prometheus remote-write mandates snappy compression; no snappy binding
is vendored in this environment, and the block format is small enough
to implement directly (varint uncompressed length, then a stream of
literal/copy tags). Decompress handles the full tag set; compress emits
a valid all-literal stream (remote-read responses must be snappy-framed,
ratio is irrelevant at those sizes).
"""

from __future__ import annotations


class SnappyError(ValueError):
    pass


def decompress(data: bytes) -> bytes:
    if not data:
        raise SnappyError("empty input")
    # uncompressed length varint
    ulen = 0
    shift = 0
    pos = 0
    while True:
        if pos >= len(data) or shift > 32:
            raise SnappyError("bad length varint")
        b = data[pos]
        pos += 1
        ulen |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                       # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if pos + extra > n:
                    raise SnappyError("truncated literal length")
                length = int.from_bytes(data[pos:pos + extra], "little") + 1
                pos += extra
            if pos + length > n:
                raise SnappyError("truncated literal")
            out += data[pos:pos + length]
            pos += length
            continue
        if kind == 1:                       # copy, 1-byte offset
            length = ((tag >> 2) & 0x7) + 4
            if pos >= n:
                raise SnappyError("truncated copy1")
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:                     # copy, 2-byte offset
            length = (tag >> 2) + 1
            if pos + 2 > n:
                raise SnappyError("truncated copy2")
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:                               # copy, 4-byte offset
            length = (tag >> 2) + 1
            if pos + 4 > n:
                raise SnappyError("truncated copy4")
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise SnappyError("bad copy offset")
        # overlapping copies are legal (RLE-style): byte-at-a-time when
        # the ranges overlap, slice otherwise
        start = len(out) - offset
        if offset >= length:
            out += out[start:start + length]
        else:
            for i in range(length):
                out.append(out[start + i])
    if len(out) != ulen:
        raise SnappyError(f"length mismatch: {len(out)} != {ulen}")
    return bytes(out)


def compress(data: bytes) -> bytes:
    """Minimal VALID snappy block stream: the uncompressed-length varint
    followed by all-literal tags (ratio 1.0, but every decoder accepts
    it). Needed by remote-read responses; remote-write ingest only ever
    decompresses."""
    out = bytearray()
    n = len(data)
    while True:            # length varint
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            break
    pos = 0
    while pos < len(data):
        chunk = data[pos:pos + 65536]
        L = len(chunk) - 1
        if L < 60:
            out.append(L << 2)
        elif L < 1 << 8:
            out.append(60 << 2)
            out.append(L)
        else:
            out.append(61 << 2)
            out += L.to_bytes(2, "little")
        out += chunk
        pos += len(chunk)
    return bytes(out)
