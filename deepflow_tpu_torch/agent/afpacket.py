"""AF_PACKET live capture source: the recv_engine for real interfaces.

Reference: agent/src/dispatcher/recv_engine/af_packet/ — a TPACKET_V2
mmap ring delivering raw frames to the dispatcher. Python's stdlib
exposes AF_PACKET/SOCK_RAW directly on Linux, so the capture source here
is a raw socket drained in batches: recv up to `batch_size` frames (or
until `poll_ms` passes with none), stamp kernel-adjacent timestamps, and
hand the batch to `Agent.feed` — the same (frames, timestamps_ns)
contract the pcap replay source and the synthetic generators speak.

The mmap ring's zero-copy advantage matters at line rate on many-core
hosts; this framework's hot path is the batched columnar decode + TPU
sketches, and a per-batch recv loop on one core sustains the agent's
design envelope (the flow map itself merges >1M pkts/s/core). Requires
CAP_NET_RAW (root), like every capture backend.

The port's own copy of the JAX package's `agent/afpacket.py` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

import mmap
import select
import socket
import struct
import threading
import time
from typing import List, Optional, Tuple

ETH_P_ALL = 0x0003

# linux/if_packet.h ABI constants
SOL_PACKET = 263
PACKET_RX_RING = 5
PACKET_VERSION = 10
PACKET_STATISTICS = 6
TPACKET_V3 = 2
TP_STATUS_USER = 1
TP_STATUS_KERNEL = 0


class AfPacketSource:
    """Batched live capture off one interface (or all, iface=None)."""

    def __init__(self, iface: Optional[str] = None,
                 batch_size: int = 4096, poll_ms: float = 50.0,
                 snaplen: int = 65535, prepare=None) -> None:
        if not hasattr(socket, "AF_PACKET"):
            raise OSError("AF_PACKET requires Linux")
        self.iface = iface
        self.batch_size = batch_size
        self.poll_ms = poll_ms
        self.snaplen = snaplen
        self._sock = socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                                   socket.htons(ETH_P_ALL))
        try:
            if prepare is not None:
                # e.g. bpf.BpfFilter.attach_socket: the filter must be
                # on the socket BEFORE bind, or pre-attach packets
                # reach userspace unfiltered
                prepare(self._sock)
            if iface:
                self._sock.bind((iface, 0))
            self._sock.settimeout(poll_ms / 1e3)
        except OSError:
            self._sock.close()     # no fd leak on bad interface names
            raise
        self.frames_captured = 0
        self.errors = 0

    def fileno(self) -> int:
        return self._sock.fileno()

    def read_batch(self) -> Tuple[List[bytes], List[int]]:
        """One capture batch: up to batch_size frames; returns as soon as
        the poll window passes with the batch non-empty (or empty on a
        quiet interface). Timestamps are host-clock ns at dequeue —
        within the 1s flow-tick resolution of everything downstream."""
        frames: List[bytes] = []
        stamps: List[int] = []
        deadline = time.monotonic() + self.poll_ms / 1e3
        while len(frames) < self.batch_size:
            try:
                data = self._sock.recv(self.snaplen)
            except socket.timeout:
                break
            except OSError:
                # a dead socket must be visible, not a quiet interface:
                # count it so CaptureLoop backs off and counters show it
                self.errors += 1
                break
            frames.append(data)
            stamps.append(time.time_ns())
            if time.monotonic() > deadline:
                break
        self.frames_captured += len(frames)
        return frames, stamps

    def statistics(self) -> Tuple[int, int]:
        """(packets, drops) from PACKET_STATISTICS (tpacket_stats):
        the kernel's loss counter, so the recv path's drops are visible
        too, not just the ring's."""
        raw = self._sock.getsockopt(SOL_PACKET, PACKET_STATISTICS, 8)
        pkts, drops = struct.unpack("II", raw)
        return pkts, drops

    def close(self) -> None:
        self._sock.close()


class TpacketV3Source:
    """TPACKET_V3 mmap ring capture: the reference recv_engine's real
    mode (agent/src/dispatcher/recv_engine/af_packet/tpacket.rs), built
    on nothing but setsockopt + mmap.

    The kernel fills fixed-size BLOCKS of packets and flips each block's
    status word to TP_STATUS_USER when it retires (full, or the
    retire-timeout fires) — one poll() wakeup harvests a whole block of
    frames with zero per-packet syscalls, vs recv()'s one syscall (and
    two copies) per frame. Frames carry KERNEL timestamps (tp_sec/nsec),
    not dequeue-time host stamps. Layout walked here
    (linux/if_packet.h): tpacket_block_desc{version, offset_to_priv,
    tpacket_hdr_v1{block_status, num_pkts, offset_to_first_pkt, ...}},
    packets chained by tpacket3_hdr.tp_next_offset with the frame bytes
    at tp_mac."""

    def __init__(self, iface: Optional[str] = None,
                 block_size: int = 1 << 20, block_count: int = 8,
                 frame_size: int = 1 << 11, retire_ms: int = 60,
                 batch_size: int = 8192, poll_ms: float = 50.0,
                 prepare=None) -> None:
        if not hasattr(socket, "AF_PACKET"):
            raise OSError("AF_PACKET requires Linux")
        if block_size % mmap.PAGESIZE or block_size % frame_size:
            raise ValueError("block_size must be a multiple of the page "
                             "size and of frame_size")
        self.iface = iface
        self.batch_size = batch_size
        self.poll_ms = poll_ms
        self._blocks = block_count
        self._block_size = block_size
        self._sock = socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                                   socket.htons(ETH_P_ALL))
        try:
            if prepare is not None:
                prepare(self._sock)   # filter before bind (see raw src)
            self._sock.setsockopt(SOL_PACKET, PACKET_VERSION, TPACKET_V3)
            req = struct.pack(
                "IIIIIII", block_size, block_count, frame_size,
                block_size // frame_size * block_count, retire_ms, 0, 0)
            self._sock.setsockopt(SOL_PACKET, PACKET_RX_RING, req)
            self._map = mmap.mmap(self._sock.fileno(),
                                  block_size * block_count)
            if iface:
                self._sock.bind((iface, 0))
        except OSError:
            self._sock.close()
            raise
        self._mv = memoryview(self._map)
        self._next_block = 0
        self.frames_captured = 0
        self.blocks_harvested = 0
        self.errors = 0

    def fileno(self) -> int:
        return self._sock.fileno()

    def _harvest_block(self, b: int, frames: List[bytes],
                       stamps: List[int]) -> bool:
        """If block b belongs to userspace, copy its frames out and hand
        it back to the kernel. Returns whether the block was ready."""
        base = b * self._block_size
        mv = self._mv
        status = struct.unpack_from("I", mv, base + 8)[0]
        if not status & TP_STATUS_USER:
            return False
        num_pkts = struct.unpack_from("I", mv, base + 12)[0]
        off = struct.unpack_from("I", mv, base + 16)[0]
        pkt = base + off
        for _ in range(num_pkts):
            (nxt, sec, nsec, snaplen) = struct.unpack_from("IIII", mv, pkt)
            mac = struct.unpack_from("H", mv, pkt + 24)[0]
            frames.append(bytes(mv[pkt + mac:pkt + mac + snaplen]))
            stamps.append(sec * 1_000_000_000 + nsec)
            if nxt == 0:
                break
            pkt += nxt
        # release: the status store is the hand-back point (the kernel
        # pairs it with its own barriers; CPython's struct write is a
        # plain aligned u32 store)
        struct.pack_into("I", mv, base + 8, TP_STATUS_KERNEL)
        self.blocks_harvested += 1
        return True

    def read_batch(self) -> Tuple[List[bytes], List[int]]:
        """Harvest every retired block, polling up to poll_ms when none
        is ready. Same (frames, timestamps_ns) contract as
        AfPacketSource.read_batch, with kernel timestamps."""
        frames: List[bytes] = []
        stamps: List[int] = []
        waited = False
        try:
            # drain retired blocks in ring order, advancing the cursor
            # past EVERY harvested block (a cursor that re-checks a
            # just-released block would collapse the usable ring to one
            # block); poll once when nothing is ready yet
            while len(frames) < self.batch_size:
                if self._harvest_block(self._next_block, frames, stamps):
                    self._next_block = \
                        (self._next_block + 1) % self._blocks
                    continue
                if frames or waited:
                    break
                waited = True
                r, _, _ = select.select([self._sock], [], [],
                                        self.poll_ms / 1e3)
                if not r:
                    break
        except OSError:
            self.errors += 1
        self.frames_captured += len(frames)
        return frames, stamps

    def statistics(self) -> Tuple[int, int]:
        """(packets, drops) from PACKET_STATISTICS — the kernel's own
        loss counter for this ring (tp_packets, tp_drops; freeze_q_cnt
        is read and discarded)."""
        raw = self._sock.getsockopt(SOL_PACKET, PACKET_STATISTICS, 12)
        pkts, drops, _ = struct.unpack("III", raw)
        return pkts, drops

    def close(self) -> None:
        self._mv.release()
        self._map.close()
        self._sock.close()


class CaptureLoop:
    """Drives an AfPacketSource (or any .read_batch() source) into an
    Agent from a daemon thread — the dispatcher's recv loop."""

    def __init__(self, source, agent, stats=None) -> None:
        self.source = source
        self.agent = agent
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.batches = 0
        self.packets = 0
        self.failed: Optional[str] = None
        if stats is not None:
            stats.register("capture", self.counters)

    def start(self) -> None:
        # supervised: crash capture +
        # deadman beats; a source failure still STOPS the loop (normal
        # return, no restart) with the failure recorded in counters
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        self._thread = default_supervisor().spawn(
            "capture-loop", self._run)

    def _run(self) -> None:
        import numpy as np

        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        sup = default_supervisor()
        errors_seen = 0
        while not self._stop.is_set():
            sup.beat()
            try:
                frames, stamps = self.source.read_batch()
            except Exception as e:
                # a capture source that throws (malformed pcap, iface
                # torn down) must not leave a zombie agent that LOOKS
                # alive but captures nothing: record the failure where
                # counters/DFSTATS surface it, then stop this loop
                import logging
                logging.getLogger(__name__).exception(
                    "capture source failed; capture stopped")
                self.failed = f"{type(e).__name__}: {e}"
                return
            if not frames:
                # if the empty batch came from a socket error (not a
                # quiet interface), back off instead of busy-spinning
                errs = getattr(self.source, "errors", 0)
                if errs > errors_seen:
                    errors_seen = errs
                    self._stop.wait(0.2)
                continue
            self.batches += 1
            self.packets += self.agent.feed(
                frames, np.asarray(stamps, np.uint64))

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.stop()
            self._thread.join(timeout=2)
        self.source.close()
        bpf = getattr(self.source, "bpf", None)
        if bpf is not None:
            bpf.close()      # program + map fds owned per attachment

    def counters(self) -> dict:
        c = {"batches": self.batches, "packets": self.packets,
             "failed": self.failed or ""}
        bpf = getattr(self.source, "bpf", None)
        if bpf is not None:
            # kernel-side filter verdicts (agent/bpf.py BpfFilter)
            c.update(bpf.counters())
        for attr in ("frames_captured", "errors"):
            if hasattr(self.source, attr):
                c[f"capture_{attr}" if attr == "errors" else attr] = \
                    getattr(self.source, attr)
        return c
