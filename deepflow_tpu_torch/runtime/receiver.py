"""Firehose receiver: TCP/UDP listener -> per-type keyed queues.

The framework's network front door, speaking the agent sender's exact wire
format (reference: server/libs/receiver/receiver.go — one port, TCP framing
by BaseHeader.FrameSize, UDP one-frame-per-datagram, demux of MESSAGE_TYPE_*
to registered multi-queues hashed by vtap_id, per-vtap sequence/status
tracking :215-296). Threaded rather than asyncio: the work unit is a whole
frame (up to 512 kB), so per-connection reader threads feeding overwrite
queues carry line rate without an event loop in the hot path.
"""

from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from deepflow_tpu_torch.runtime.faults import (FAULT_RECEIVER_TRUNCATE,
                                         default_faults)
from deepflow_tpu_torch.runtime.queues import MultiQueue
from deepflow_tpu_torch.runtime.stats import StatsRegistry
from deepflow_tpu_torch.runtime.supervisor import default_supervisor
from deepflow_tpu_torch.runtime.tracing import default_tracer
from deepflow_tpu_torch.wire.framing import (
    FLOW_HEADER_RETRANSMIT,
    MESSAGE_HEADER_LEN,
    MESSAGE_FRAME_SIZE_MAX,
    Frame,
    FrameReader,
    MessageType,
)

DEFAULT_PORT = 30033  # reference default ingester data port


# dedup belt on top of the retransmit flag: a flagged frame further
# than this below last_seq cannot be one of OUR ring's replays (the
# sender ring holds <= 256 frames) — it is another sender sharing this
# (vtap, type) status. Suppressing it would be silent loss; delivering
# it merely miscounts gaps, which senders sharing a vtap id already do.
SEQ_DEDUP_WINDOW = 4096


@dataclass
class VtapStatus:
    """Per-(vtap, message type) liveness + sequence-gap + duplicate
    accounting (reference: receiver.go:215-296; dedup is ours — the
    sender's at-least-once retransmit ring needs it)."""

    vtap_id: int
    msg_type: int
    last_seq: int = 0
    last_ts: float = 0.0
    rx_frames: int = 0
    rx_dropped: int = 0   # frames lost upstream, inferred from seq gaps
    rx_invalid: int = 0
    rx_duplicate: int = 0  # sender-ring retransmits, suppressed

    def observe(self, seq: int, now: float,
                retransmit: bool = False) -> bool:
        """Track one frame's sequence; False = duplicate (suppress
        before dispatch so at-least-once never double-counts sketches).

        `retransmit` is the frame's FLOW_HEADER_RETRANSMIT bit: the
        sender's ring replay marks frames whose earlier delivery a dead
        connection left unknown. A FLAGGED frame at seq <= last_seq was
        already dispatched here — duplicate. An UNFLAGGED frame going
        backwards reads as an agent restart that reset
        its counter — reset tracking without booking phantom drops."""
        self.last_ts = now
        if self.rx_frames > 0 and seq <= self.last_seq:
            if retransmit:
                if self.last_seq - seq < SEQ_DEDUP_WINDOW:
                    self.rx_duplicate += 1
                    return False
                # flagged but outside the window: a DIFFERENT sender
                # sharing this vtap id replaying its ring. Deliver
                # (suppressing a frame we never dispatched is silent
                # loss) WITHOUT regressing last_seq — resetting it to
                # the foreign sequence would book the other sender's
                # next in-order frame as a ~window-sized phantom gap
                self.rx_frames += 1
                return True
            # unflagged: agent restarted — reset without counting drops
        elif self.rx_frames > 0 and seq > self.last_seq + 1:
            self.rx_dropped += seq - self.last_seq - 1
        self.last_seq = seq
        self.rx_frames += 1
        return True


class Receiver:
    """Listens on one port (TCP + UDP), demuxes frames to handler queues."""

    def __init__(self, port: int = DEFAULT_PORT, host: str = "127.0.0.1",
                 stats: Optional[StatsRegistry] = None) -> None:
        self.host = host
        self.port = port
        self._handlers: Dict[MessageType, MultiQueue] = {}
        self._status: Dict[Tuple[int, int], VtapStatus] = {}
        self._status_lock = threading.Lock()
        self._threads: list = []   # supervisor ThreadHandles
        # guards _threads: the accept loop prunes/appends per connection
        # while close() drains the list from another thread
        self._threads_lock = threading.Lock()
        self._tcp_sock: Optional[socket.socket] = None
        self._udp_sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self.rx_frames = 0
        self.rx_bytes = 0
        self.rx_errors = 0
        self.no_handler = 0
        self._tracer = default_tracer()
        if stats is not None:
            stats.register("receiver", self.counters)

    def register_handler(self, msg_type: MessageType,
                         queues: MultiQueue) -> None:
        """Route frames of msg_type into `queues`, hashed by vtap_id
        (reference: receiver.go RegistHandler)."""
        self._handlers[msg_type] = queues

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._tcp_sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._tcp_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._tcp_sock.bind((self.host, self.port))
        self._tcp_sock.listen(64)
        self._tcp_sock.settimeout(0.2)
        # With port=0 the kernel picks the TCP port; UDP must follow it so
        # both speak on the same number (the reference listens on one port).
        actual_port = self._tcp_sock.getsockname()[1]

        self._udp_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._udp_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._udp_sock.bind((self.host, actual_port))
        self._udp_sock.settimeout(0.2)
        # UDP datagrams up to the max frame need a big kernel buffer
        self._udp_sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                  8 * MESSAGE_FRAME_SIZE_MAX)

        # supervised: an unexpected crash in a listener loop restarts it
        # with backoff while the sockets stay bound (a raising handler
        # must not silence the firehose); per-connection readers below
        # are restart=False — a dead socket is normal churn, only the
        # crash capture matters
        sup = default_supervisor()
        for target, name in ((self._accept_loop, "recv-tcp-accept"),
                             (self._udp_loop, "recv-udp")):
            t = sup.spawn(name, target)
            with self._threads_lock:
                self._threads.append(t)

    def quiesce(self, idle_s: float = 0.2, deadline_s: float = 2.0) -> bool:
        """Drain-ladder rung 1: stop NEW connections (close the TCP
        listener; established readers and the UDP loop stay live) and
        wait — bounded — until the firehose has been idle for `idle_s`.
        Bytes an agent already wrote sit in kernel buffers; close()ing
        the readers immediately would guillotine them into silent loss.
        Returns True when idle was reached (False: still receiving at
        the deadline — a live sender can't be drained forever)."""
        if self._tcp_sock is not None:
            try:
                # accept() raises OSError -> the accept loop returns;
                # per-connection sockets are separate and keep reading
                self._tcp_sock.close()
            except OSError:
                pass
        deadline = time.monotonic() + deadline_s
        last, last_t = self.rx_frames, time.monotonic()
        while time.monotonic() < deadline:
            time.sleep(0.05)
            if self.rx_frames != last:
                last, last_t = self.rx_frames, time.monotonic()
            elif time.monotonic() - last_t >= idle_s:
                return True
        return False

    def close(self) -> None:
        self._stop.set()
        with self._threads_lock:
            threads = list(self._threads)
            self._threads.clear()
        for t in threads:
            t.stop()
            t.join(timeout=2)
        for s in (self._tcp_sock, self._udp_sock):
            if s is not None:
                s.close()

    @property
    def bound_port(self) -> int:
        """Actual port (useful when constructed with port=0 in tests)."""
        assert self._tcp_sock is not None
        return self._tcp_sock.getsockname()[1]

    # -- data path ---------------------------------------------------------
    def _accept_loop(self) -> None:
        sup = default_supervisor()
        while not self._stop.is_set():
            sup.beat()
            try:
                conn, addr = self._tcp_sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = sup.spawn(f"recv-tcp-{addr[0]}:{addr[1]}",
                          lambda c=conn, a=addr: self._tcp_conn_loop(c, a),
                          restart=False)
            # Prune threads of closed connections so a churning agent fleet
            # doesn't grow the list unboundedly; under the lock so a racing
            # close() never iterates a half-rebuilt list.
            with self._threads_lock:
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)

    def _tcp_conn_loop(self, conn: socket.socket, addr) -> None:
        reader = FrameReader()
        conn.settimeout(0.2)
        sup = default_supervisor()
        faults = default_faults()
        with conn:
            while not self._stop.is_set():
                sup.beat()
                try:
                    chunk = conn.recv(1 << 16)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not chunk:
                    return
                if faults.enabled:   # chaos: tear the stream mid-frame
                    chunk = faults.maybe_truncate(
                        FAULT_RECEIVER_TRUNCATE, chunk,
                        key=f"{addr[0]}:{addr[1]}")
                try:
                    for frame in reader.feed(chunk):
                        self._dispatch(frame, len(frame.payload))
                except ValueError:
                    self.rx_errors += 1
                    return  # framing lost; drop the connection

    def _udp_loop(self) -> None:
        sup = default_supervisor()
        while not self._stop.is_set():
            sup.beat()
            try:
                datagram, _ = self._udp_sock.recvfrom(MESSAGE_FRAME_SIZE_MAX)
            except socket.timeout:
                continue
            except OSError:
                return
            reader = FrameReader()  # one datagram = one frame
            try:
                for frame in reader.feed(datagram):
                    self._dispatch(frame, len(frame.payload))
            except ValueError:
                self.rx_errors += 1

    def _dispatch(self, frame: Frame, nbytes: int) -> None:
        self.rx_frames += 1
        self.rx_bytes += nbytes
        # flight recorder: frame-level batch_id is where batch causality
        # STARTS (decode spans anchor to the first frame's id). The
        # whole block is guarded so the disabled path adds one attribute
        # load + branch, no allocations.
        tracer = self._tracer
        tracing = tracer.enabled
        if tracing:
            t0 = time.perf_counter()
            frame.trace_batch_id = tracer.next_batch()
        vtap = 0
        if frame.flow_header is not None:
            vtap = frame.flow_header.vtap_id
            if not self._track(frame, vtap):
                # sender-ring retransmit of a frame already dispatched:
                # suppressed here so at-least-once delivery never
                # double-counts sketches (counted rx_duplicate)
                return
        handler = self._handlers.get(frame.msg_type)
        if handler is None:
            self.no_handler += 1
            return
        handler.put(vtap, frame)
        if tracing:
            # rows stays 0: a frame's record count is unknown until
            # decode, and payload BYTES under a ROWS column would read
            # as 65k records next to the other stages' record counts
            tracer.observe("receiver", time.perf_counter() - t0,
                           stream=frame.msg_type.name,
                           batch_id=frame.trace_batch_id)

    def _track(self, frame: Frame, vtap: int) -> bool:
        key = (vtap, int(frame.msg_type))
        with self._status_lock:
            st = self._status.get(key)
            if st is None:
                st = self._status[key] = VtapStatus(vtap, int(frame.msg_type))
            # plain in-memory sequence arithmetic on state guarded by
            # this lock
            return st.observe(
                frame.flow_header.sequence, time.time(),
                retransmit=bool(frame.flow_header.version
                                & FLOW_HEADER_RETRANSMIT))

    # -- introspection -----------------------------------------------------
    def status(self) -> Dict[Tuple[int, int], VtapStatus]:
        with self._status_lock:
            return dict(self._status)

    def counters(self) -> dict:
        # snapshot under the lock (like status()): a scrape racing a
        # new-vtap insert must not see the dict resize mid-iteration
        with self._status_lock:
            statuses = list(self._status.values())
        return {
            "rx_frames": self.rx_frames,
            "rx_bytes": self.rx_bytes,
            "rx_errors": self.rx_errors,
            "no_handler": self.no_handler,
            "seq_dropped": sum(s.rx_dropped for s in statuses),
            "rx_duplicate": sum(s.rx_duplicate for s in statuses),
            "vtaps": len(statuses),
        }
