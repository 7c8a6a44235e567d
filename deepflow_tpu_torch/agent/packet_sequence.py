"""Packet-sequence blocks: the server-side decode of per-packet TCP
headers batched per flow (MESSAGE_TYPE_PACKETSEQUENCE).

A copy of the JAX package's `agent/packet_sequence.py` decode half:
`decode_blocks` (the envelope, l4_packet.go DecodePacketSequence
semantics) and `decode_entries` (the batch content). The collector that
builds blocks on the agent is not ported.

Envelope, little-endian: u32 block_size (the 16-byte head plus the
batch, not the size field), u64 flow_id, u64 packet_count<<56 |
end_time_us, batch bytes; BLOCK_HEAD_SIZE=16.

Batch content, little-endian, 20 bytes per packet:
    u32 delta_us     offset from the block's first packet
    u32 tcp_seq
    u32 tcp_ack
    u16 tcp_window
    u16 payload_len
    u8  tcp_flags
    u8  direction    the flow's canonical orientation bit (0 = packet
                     travels lower-(ip,port)-first)
    u16 reserved     0
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["BLOCK_HEAD_SIZE", "ENTRY_SIZE", "decode_blocks",
           "decode_entries"]

BLOCK_HEAD_SIZE = 16
ENTRY_SIZE = 20


def decode_blocks(payload: bytes, vtap_id: int
                  ) -> Tuple[List[dict], int]:
    """Server-side envelope decode (l4_packet.go DecodePacketSequence
    semantics): returns (rows, bad_blocks). Each row carries the raw
    batch bytes; StartTime follows the reference's 5s-bound estimate."""
    rows: List[dict] = []
    bad = 0
    off = 0
    n = len(payload)
    while off + 4 <= n:
        (block_size,) = struct.unpack_from("<I", payload, off)
        off += 4
        # block_size counts the 16B head + batch (NOT the size field)
        if block_size <= BLOCK_HEAD_SIZE or off + block_size > n:
            # malformed: the reference errors per block; count + stop
            # (offsets beyond this are unreliable)
            bad += 1
            break
        flow_id, et_count = struct.unpack_from("<QQ", payload, off)
        batch = payload[off + BLOCK_HEAD_SIZE:off + block_size]
        off += block_size
        end_us = et_count & ((1 << 56) - 1)
        rows.append({
            "flow_id": flow_id,
            "vtap_id": vtap_id,
            "packet_count": et_count >> 56,
            "end_time_us": end_us,
            "start_time_us": max(0, end_us - 5_000_000),
            "batch": batch,
        })
    return rows, bad


def decode_entries(batch: bytes) -> Dict[str, np.ndarray]:
    """Decode the open batch-content format back to columns (the
    consumer-side of the spec in the module docstring)."""
    a = np.frombuffer(batch, np.uint32).reshape(-1, 5)
    return {
        "delta_us": a[:, 0].copy(),
        "tcp_seq": a[:, 1].copy(),
        "tcp_ack": a[:, 2].copy(),
        "tcp_window": (a[:, 3] & 0xFFFF).astype(np.uint32),
        "payload_len": (a[:, 3] >> 16).astype(np.uint32),
        "tcp_flags": (a[:, 4] & 0xFF).astype(np.uint32),
        "direction": ((a[:, 4] >> 8) & 1).astype(np.uint32),
    }
