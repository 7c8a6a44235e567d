"""UniformSender: framed record batches -> an ingester's TCP firehose.

A copy of the JAX package's `agent/sender.py` (reference:
agent/src/sender/uniform_sender.rs): one sender per message type,
batching records under BaseHeader+FlowHeader frames with a per-type
sequence counter over a reconnecting TCP connection. The port's
`runtime/stats.StatsShipper` ships DFSTATS through it.

Every encoded frame enters a bounded retransmit ring keyed by the
sequence counter; frames buffer there while disconnected (reconnects
back off exponentially with deterministic jitter) and drain in sequence
order once the socket returns. Frames whose sendall succeeded stay in
the ring, marked sent, until capacity evicts them: on a reconnect the
whole ring is re-sent, flagged, and the receiver's per-vtap sequence
dedup (`rx_duplicate`) suppresses the ones that did land. The only
counted loss is ring overflow shedding a frame that never made it out
(`retransmit_shed`, in records). `sent_records` counts acceptance (wire
or ring).
"""

from __future__ import annotations

import random
import socket
import threading
import time
from typing import List, Optional

from deepflow_tpu_torch.runtime.faults import (FAULT_SENDER_DISCONNECT,
                                               default_faults)
from deepflow_tpu_torch.wire.codec import pack_pb_records
from deepflow_tpu_torch.wire.framing import (MESSAGE_FRAME_SIZE_MAX,
                                             FlowHeader, MessageType,
                                             encode_frame, set_retransmit)

# keep payloads comfortably under the wire max
_BATCH_BYTES = MESSAGE_FRAME_SIZE_MAX - 4096


class _RingEntry:
    """One framed batch awaiting (re)transmit confirmation by eviction."""

    __slots__ = ("seq", "frame", "records")

    def __init__(self, seq: int, frame: bytes, records: int) -> None:
        self.seq = seq
        self.frame = frame
        self.records = records


class UniformSender:
    """One message type, one connection, sequenced frames."""

    def __init__(self, msg_type: MessageType, addr: str, vtap_id: int = 0,
                 reconnect_interval: float = 2.0,
                 reconnect_cap: float = 30.0,
                 ring_frames: int = 256,
                 ring_bytes: int = 8 << 20) -> None:
        self.msg_type = msg_type
        host, _, port = addr.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.vtap_id = vtap_id
        # reconnect_interval is now the BACKOFF BASE: attempt N waits
        # base * 2^N (capped), with deterministic jitter so a fleet of
        # senders doesn't thunder the recovering ingester in lockstep
        self.reconnect_interval = reconnect_interval
        self.reconnect_cap = reconnect_cap
        self._rng = random.Random(f"{msg_type}:{addr}:{vtap_id}")
        self._attempts = 0
        self._next_attempt = 0.0
        self._sock: Optional[socket.socket] = None
        self._seq = 0
        self._lock = threading.Lock()
        self._faults = default_faults()
        # retransmit ring: bounded by frames AND bytes; holds unsent
        # frames (buffered while down) plus recently-sent ones whose
        # delivery a dead connection left unknown. Sent entries are
        # always a contiguous PREFIX (appends land unsent on the right,
        # the pump marks left-to-right, a reconnect resets the prefix),
        # so `_sent_prefix` makes the healthy-path pump and the pending
        # count O(new entries) instead of O(ring).
        self._ring: List[_RingEntry] = []
        self._sent_prefix = 0
        self._ring_byte_size = 0
        self.ring_frames = max(1, ring_frames)
        self.ring_bytes = max(1 << 16, ring_bytes)
        self.sent_frames = 0
        self.sent_records = 0          # records accepted (wire or ring)
        self.dropped_records = 0       # oversize payloads, never ringed
        self.retransmit_shed = 0       # ring evicted a never-sent frame
        self.retransmitted_frames = 0  # ring re-sends after reconnect
        self.disconnects = 0           # connection deaths (incl. chaos)

    def set_target(self, addr: str) -> None:
        """Re-point at a different ingester (controller rebalancing)."""
        host, _, port = addr.rpartition(":")
        with self._lock:
            if (host or "127.0.0.1", int(port)) == (self.host, self.port):
                return
            self.host, self.port = host or "127.0.0.1", int(port)
            self._close_socket_locked()
            self._attempts = 0
            self._next_attempt = 0.0

    def _close_socket_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self.disconnects += 1

    def _connect_locked(self) -> bool:
        if self._sock is not None:
            return True
        # monotonic: a backwards NTP step on wall clock would wedge the
        # dial-out far past the backoff cap
        now = time.monotonic()
        if now < self._next_attempt:
            return False
        try:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=5)
        except OSError:
            delay = min(self.reconnect_cap,
                        self.reconnect_interval * (2 ** self._attempts))
            delay *= 1.0 + 0.25 * self._rng.random()
            self._attempts = min(self._attempts + 1, 32)
            self._next_attempt = now + delay
            return False
        self._attempts = 0
        self._next_attempt = 0.0
        return True

    # -- ring --------------------------------------------------------------
    def _ring_push_locked(self, entry: _RingEntry) -> None:
        self._ring.append(entry)
        self._ring_byte_size += len(entry.frame)
        while (len(self._ring) > self.ring_frames
               or self._ring_byte_size > self.ring_bytes):
            old = self._ring.pop(0)
            self._ring_byte_size -= len(old.frame)
            if self._sent_prefix > 0:
                self._sent_prefix -= 1   # evicting a sent entry: free
            else:
                # the ONLY sender-side loss class left: a frame that
                # never reached the wire fell off the bounded ring
                self.retransmit_shed += old.records

    def _pump_ring_locked(self) -> int:
        """Send every unsent ring entry (the suffix past _sent_prefix)
        in sequence order; on a fresh reconnect the caller first resets
        the prefix for re-send. Returns records newly written."""
        if not self._connect_locked():
            return 0
        wrote = 0
        while self._sent_prefix < len(self._ring):
            entry = self._ring[self._sent_prefix]
            if self._faults.enabled and self._faults.should_fire(
                    FAULT_SENDER_DISCONNECT, key=self.msg_type.name):
                # chaos: the connection dies at a frame boundary — the
                # deterministic shape of an ingester restart
                self._close_socket_locked()
                return wrote
            try:
                self._sock.sendall(entry.frame)
            except OSError:
                self._close_socket_locked()
                return wrote
            self._sent_prefix += 1
            self.sent_frames += 1
            wrote += entry.records
        return wrote

    def _transmit_locked(self, entries: List[_RingEntry]) -> int:
        for e in entries:
            self._ring_push_locked(e)
        was_down = self._sock is None
        if was_down and self._connect_locked():
            # reconnect: delivery of everything sent on the dead
            # connection is unknown — re-send it all, FLAGGED, so the
            # receiver's seq dedup suppresses what already landed while
            # a real agent restart (unflagged) still reads as a reset
            flagable = self.msg_type.has_flow_header
            for i in range(self._sent_prefix):
                if flagable:   # headerless types have no seq to dedup
                    self._ring[i].frame = set_retransmit(
                        self._ring[i].frame)
                self.retransmitted_frames += 1
            self._sent_prefix = 0
        return self._pump_ring_locked()

    # -- send API ------------------------------------------------------------
    def send(self, records: List[bytes]) -> int:
        """Frame + transmit; returns records from THIS call that were
        accepted (wire or retransmit ring) — always len(records).
        Returning wire-written-now instead would over-report a
        reconnecting tick by the whole replayed backlog and zero the
        ticks that buffered (per-tick telemetry in agent/trident.py
        sums these)."""
        if not records:
            return 0
        entries: List[_RingEntry] = []
        with self._lock:
            batch: List[bytes] = []
            size = 0
            for rec in records + [None]:
                if rec is not None and size + len(rec) + 4 < _BATCH_BYTES:
                    batch.append(rec)
                    size += len(rec) + 4
                    continue
                if batch:
                    self._seq += 1
                    frame = encode_frame(
                        self.msg_type, pack_pb_records(batch),
                        FlowHeader(sequence=self._seq,
                                   vtap_id=self.vtap_id))
                    entries.append(
                        _RingEntry(self._seq, frame, len(batch)))
                batch, size = ([rec], len(rec) + 4) if rec is not None \
                    else ([], 0)
            self.sent_records += len(records)
            self._transmit_locked(entries)
            return len(records)

    def send_columns(self, cols, schema) -> int:
        """Send column arrays as planar COLUMNAR_FLOW payloads (the
        TPU-native wire mode: no per-row protobuf serialization on the
        agent, no varint walk on the server — wire/columnar_wire.py).
        Chunks rows so each frame stays under the wire max. Returns rows
        accepted."""
        from deepflow_tpu_torch.wire import columnar_wire

        n = len(next(iter(cols.values())))
        if n == 0:
            return 0
        rows_per_frame = max(1, (_BATCH_BYTES - columnar_wire.HEADER_LEN)
                             // schema.row_bytes())
        sent = 0
        for lo in range(0, n, rows_per_frame):
            hi = min(lo + rows_per_frame, n)
            chunk = {k: v[lo:hi] for k, v in cols.items()}
            if self.send_raw(columnar_wire.encode_columnar(chunk, schema),
                             records=hi - lo):
                sent += hi - lo
        return sent

    def send_raw_batch(self, payloads: List[bytes]) -> int:
        """Concatenate self-delimited payloads (packet-sequence blocks:
        each leads with its own u32 size) into as few raw frames as fit
        under the frame budget; returns payloads accepted."""
        sent = 0
        batch: List[bytes] = []
        size = 0
        for p in payloads + [None]:
            if p is not None and size + len(p) < _BATCH_BYTES:
                batch.append(p)
                size += len(p)
                continue
            if batch and self.send_raw(b"".join(batch),
                                       records=len(batch)):
                sent += len(batch)
            batch, size = (([p], len(p)) if p is not None else ([], 0))
        return sent

    def send_raw(self, payload: bytes, records: int = 1) -> bool:
        """Frame one raw payload as-is (streams whose frame body is a
        single message — OTel exports, influx text — rather than a
        length-prefixed record batch). Returns True when the frame was
        accepted (wire or retransmit ring); only an oversize payload is
        refused (counted `dropped_records`)."""
        if len(payload) >= _BATCH_BYTES:
            self.dropped_records += records
            return False
        with self._lock:
            self._seq += 1
            frame = encode_frame(self.msg_type, payload,
                                 FlowHeader(sequence=self._seq,
                                            vtap_id=self.vtap_id))
            self.sent_records += records
            self._transmit_locked(
                [_RingEntry(self._seq, frame, records)])
            return True

    def pending_frames(self) -> int:
        """Frames buffered in the ring awaiting (re)transmit."""
        with self._lock:
            return len(self._ring) - self._sent_prefix

    def flush(self, timeout: float = 0.0) -> int:
        """Pump the ring now (and until `timeout` if the connection is
        down), without new records — shutdown/test drain aid. Returns
        unsent frames remaining."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                self._transmit_locked([])
                left = len(self._ring) - self._sent_prefix
            if left == 0 or time.monotonic() >= deadline:
                return left
            time.sleep(0.05)

    def close(self) -> None:
        with self._lock:
            # one last pump so an ALREADY-HEALTHY connection drains the
            # ring; never dial out from close (a dead target would
            # block shutdown on the connect timeout)
            if self._sock is not None:
                self._pump_ring_locked()
            # whatever is still unsent becomes loss the moment we stop
            # trying — book it, or `sent_records` quietly exceeds
            # delivered + counted loss (the invariant this PR is for)
            for e in self._ring[self._sent_prefix:]:
                self.retransmit_shed += e.records
            self._ring.clear()
            self._sent_prefix = 0
            self._ring_byte_size = 0
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def counters(self) -> dict:
        with self._lock:
            pending = len(self._ring) - self._sent_prefix
        return {"sent_frames": self.sent_frames,
                "sent_records": self.sent_records,
                "dropped_records": self.dropped_records,
                "retransmit_shed": self.retransmit_shed,
                "retransmitted_frames": self.retransmitted_frames,
                "disconnects": self.disconnects,
                "ring_pending_frames": pending}
