"""Packet-sequence collection: per-packet TCP headers batched per flow.

Reference: the packet-sequence feature
(agent/src/flow_generator/packet_sequence/, MESSAGE_TYPE_PACKETSEQUENCE,
ingester flow_log/log_data/l4_packet.go) records every TCP packet's
seq/ack/flags/window per flow for fine-grained retransmission and
ordering diagnosis — the data ClickHouse stores in `l4_packet` rows of
(flow_id, packet_count, packet_batch). The OSS reference ships the
full SERVER side but stubs the agent-side block builder to an
enterprise crate (agent/plugins/packet_sequence_block/src/lib.rs is
`unimplemented!()`), exactly like the Oracle parser. As with Oracle,
this module is a clean-room implementation of the capability: the wire
ENVELOPE matches the server's decoder byte-for-byte (l4_packet.go
DecodePacketSequence: u32 block_size, u64 flow_id,
u64 packet_count<<56 | end_time_us, batch bytes; BLOCK_HEAD_SIZE=16),
while the batch CONTENT uses the documented open format below (the
enterprise format is private; any consumer reads the spec here).

Batch content, little-endian, 20 bytes per packet:
    u32 delta_us     offset from the block's first packet
    u32 tcp_seq
    u32 tcp_ack
    u16 tcp_window
    u16 payload_len
    u8  tcp_flags
    u8  direction    the flow's CANONICAL orientation bit (0 = packet
                     travels lower-(ip,port)-first) — stable for the
                     flow's lifetime even under mid-stream capture; the
                     l4_flow_log row with the same flow_id records
                     which canonical side initiated
    u16 reserved     0

Vectorized collection: one numpy pass per capture batch packs all TCP
packets' entries at once (np column stack -> tobytes), then a python
loop only over the FLOWS touched in the batch appends slices — the
per-packet work stays columnar like the rest of the agent.

The port's own copy of the JAX package's `agent/packet_sequence.py` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["BLOCK_HEAD_SIZE", "ENTRY_SIZE", "FLUSH_AGE_S",
           "MAX_PACKETS_PER_BLOCK", "PacketSequenceCollector",
           "decode_blocks", "decode_entries"]

BLOCK_HEAD_SIZE = 16
ENTRY_SIZE = 20
# flush triggers (reference: "sequence packet defaults to a maximum of
# 5s timeout sending"). The envelope's packet count rides the top 8
# bits of the endtime word, so a block holds at most 255 packets.
FLUSH_AGE_S = 5.0
MAX_PACKETS_PER_BLOCK = 255


class _FlowBuf:
    __slots__ = ("buf", "count", "first_us", "last_us")

    def __init__(self, first_us: int) -> None:
        self.buf = bytearray()
        self.count = 0
        self.first_us = first_us
        self.last_us = first_us


class PacketSequenceCollector:
    """Accumulates per-flow packet entries; emits wire blocks."""

    def __init__(self) -> None:
        self._flows: Dict[int, _FlowBuf] = {}
        self.packets_in = 0
        self.blocks_out = 0

    def observe(self, flow_ids: np.ndarray, ts_ns: np.ndarray,
                seq: np.ndarray, ack: np.ndarray, flags: np.ndarray,
                win: np.ndarray, payload_len: np.ndarray,
                direction: np.ndarray) -> List[bytes]:
        """Fold one batch of TCP packets (parallel arrays). Returns any
        blocks that hit the per-block packet cap while appending."""
        n = len(flow_ids)
        if n == 0:
            return []
        self.packets_in += n
        ts_us = (ts_ns.astype(np.uint64) // np.uint64(1000))
        # pack every entry in one columnar pass; delta_us is patched per
        # flow below (base = the flow's first packet time)
        out: List[bytes] = []
        order = np.argsort(flow_ids, kind="stable")
        fid_sorted = flow_ids[order]
        bounds = np.flatnonzero(np.r_[True, fid_sorted[1:]
                                      != fid_sorted[:-1]])
        entry = np.zeros((n, 5), np.uint32)
        entry[:, 1] = seq.astype(np.uint32)
        entry[:, 2] = ack.astype(np.uint32)
        entry[:, 3] = ((payload_len.astype(np.uint32) & 0xFFFF) << 16) \
            | (win.astype(np.uint32) & 0xFFFF)
        entry[:, 4] = (flags.astype(np.uint32) & 0xFF) \
            | ((direction.astype(np.uint32) & 1) << 8)
        for gi, start in enumerate(bounds):
            end = bounds[gi + 1] if gi + 1 < len(bounds) else n
            idx = order[start:end]
            fid = int(fid_sorted[start])
            t_us = ts_us[idx]
            pos = 0
            while pos < len(idx):
                fb = self._flows.get(fid)
                if fb is None:
                    fb = self._flows[fid] = _FlowBuf(int(t_us[pos]))
                take = idx[pos:pos + MAX_PACKETS_PER_BLOCK - fb.count]
                tt = t_us[pos:pos + len(take)]
                fb.last_us = max(fb.last_us, int(tt.max()))
                e = entry[take].copy()
                # clamp reordered packets (timestamps before the flow's
                # first recorded packet) to delta 0 instead of letting
                # the unsigned subtraction wrap to ~71 minutes
                d = tt.astype(np.int64) - fb.first_us
                e[:, 0] = np.maximum(d, 0).astype(np.uint32)
                fb.buf += e.tobytes()
                fb.count += len(take)
                pos += len(take)
                if fb.count >= MAX_PACKETS_PER_BLOCK:
                    out.append(self._emit(fid))
        return out

    def _emit(self, fid: int) -> bytes:
        fb = self._flows.pop(fid)
        self.blocks_out += 1
        head = struct.pack(
            "<IQQ", BLOCK_HEAD_SIZE + len(fb.buf), fid,
            ((fb.count & 0xFF) << 56) | (fb.last_us & ((1 << 56) - 1)))
        return head + bytes(fb.buf)

    def flush(self, now_ns: Optional[int] = None,
              force: bool = False) -> List[bytes]:
        """Emit blocks for flows older than the 5s budget (all flows
        when force)."""
        now_us = (now_ns if now_ns is not None
                  else time.time_ns()) // 1000
        due = [fid for fid, fb in self._flows.items()
               if force or now_us - fb.first_us >= FLUSH_AGE_S * 1e6]
        return [self._emit(fid) for fid in due]

    def counters(self) -> dict:
        return {"packets_in": self.packets_in,
                "blocks_out": self.blocks_out,
                "open_flows": len(self._flows)}


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
