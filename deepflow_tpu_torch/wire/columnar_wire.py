"""Planar columnar wire format: the flow firehose's fast path.

The protobuf TaggedFlow stream (wire/protos/flow_log.proto) stays the
contract for unmodified reference agents; an agent that already holds its
flushed flows as column arrays ships whole column planes instead, as the
reference's simple_codec.go writes Documents as raw little-endian scalars
(server/libs/codec/simple_codec.go WriteU32/WriteU64). Encode is one
concatenation of planes, decode one np.frombuffer per column. The bytes
are the JAX package's, frame for frame.

Frame payload layout (all little-endian, inside a COLUMNAR_FLOW frame):

    u32 magic 'DFCL'  | u16 version | u16 n_cols | u32 schema_hash
    u32 n_rows        | per-column planes, schema order

Each plane is n_rows * itemsize bytes at the column's schema dtype width
(4 for u32/i32 — int32 travels as its two's-complement uint32 image,
as the protobuf decoder's int32 columns hold it -- 8 for the
u64 identity columns). The schema_hash covers dtypes, so both ends agree
on every plane's width and offset.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from deepflow_tpu_torch.batch.schema import L4_SCHEMA, Schema

MAGIC = 0x4C434644  # b"DFCL" little-endian
VERSION = 2         # v2: mixed 4/8-byte planes (v1 was u32-only)

_HEADER = struct.Struct("<IHHII")
HEADER_LEN = _HEADER.size


def schema_hash(schema: Schema) -> int:
    """Stable 32-bit id of (name, dtype) pairs: both ends must agree on
    the plane order, so the hash travels in every frame and a mismatch is
    a decode error, not silent column transposition."""
    text = ";".join(f"{n}:{np.dtype(d).str}" for n, d in schema.columns)
    return zlib.crc32(text.encode()) & 0xFFFFFFFF


def encode_columnar(cols: Dict[str, np.ndarray],
                    schema: Schema = L4_SCHEMA) -> bytes:
    """Pack equal-length column arrays into one planar payload."""
    n = len(next(iter(cols.values())))
    parts = [_HEADER.pack(MAGIC, VERSION, len(schema.columns),
                          schema_hash(schema), n)]
    for name, dt in schema.columns:
        col = np.asarray(cols[name])
        if len(col) != n:
            raise ValueError(f"ragged column {name}: {len(col)} != {n}")
        parts.append(np.ascontiguousarray(
            col.astype(dt, copy=False)).tobytes())
    return b"".join(parts)


def _checked_n_rows(payload: bytes, schema: Schema) -> Optional[int]:
    """Validate the frame header against the schema; None = reject
    (the ONE place the frame-validity rules live — both decoders and
    any future one must agree on what a valid frame is)."""
    try:
        magic, version, n_cols, shash, n_rows = _HEADER.unpack_from(payload)
        if (magic != MAGIC or version != VERSION
                or n_cols != len(schema.columns)
                or shash != schema_hash(schema)):
            return None
        if len(payload) < HEADER_LEN + schema.row_bytes() * n_rows:
            return None
    except struct.error:
        return None
    return n_rows


def decode_columnar(payload: bytes, schema: Schema = L4_SCHEMA
                    ) -> Tuple[Dict[str, np.ndarray], int]:
    """Planar payload -> columns dict. Returns (cols, bad_record_count)
    as the protobuf decoders count them; a malformed payload
    loses the whole frame (there is no per-record resync in a planar
    layout), reported as one bad record."""
    n_rows = _checked_n_rows(payload, schema)
    if n_rows is None:
        return {n: np.empty(0, d) for n, d in schema.columns}, 1
    cols: Dict[str, np.ndarray] = {}
    off = HEADER_LEN
    for name, dt in schema.columns:
        dt = np.dtype(dt)
        cols[name] = np.frombuffer(payload, dt, count=n_rows, offset=off)
        off += dt.itemsize * n_rows
    return cols, 0


def decode_columnar_plane(payload: bytes, schema: Schema = L4_SCHEMA
                          ) -> Tuple[np.ndarray, int]:
    """Planar payload -> ONE (n_cols, n_rows) uint32 matrix VIEW (plus
    bad_record_count, same contract as decode_columnar). Valid only
    for schemas whose columns are all 4-byte (SKETCH_L4_SCHEMA is);
    the body already IS that matrix, so this is a free reshape.
    Signed columns ride bitcast in the u32 view."""
    ncols = len(schema.columns)
    if any(np.dtype(dt).itemsize != 4 for _, dt in schema.columns):
        raise ValueError(f"schema {schema.name} is not all-4-byte")
    n_rows = _checked_n_rows(payload, schema)
    if n_rows is None:
        return np.empty((ncols, 0), np.uint32), 1
    plane = np.frombuffer(payload, np.uint32, count=ncols * n_rows,
                          offset=HEADER_LEN).reshape(ncols, n_rows)
    return plane, 0
