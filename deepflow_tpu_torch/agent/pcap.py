"""pcap-file frame source: fixture replay for the capture agent.

Plays the recv_engine role for recorded traffic (reference:
agent/src/dispatcher/recv_engine/ is the live AF_PACKET/DPDK ring; its
test suite replays captured fixtures from agent/resources/test/ the same
way). A classic libpcap file — both microsecond (0xa1b2c3d4) and
nanosecond (0xa1b23c4d) flavors, either endianness — is read without any
external dependency, batched, and fed to `Agent.feed` as
(frames, timestamps_ns) capture batches, exactly what the live capture
callable produces.

`write_pcap` is the inverse, used to build fixtures in tests and to dump
agent-side captures a stock wireshark/tcpdump can open.

The port's own copy of the JAX package's `agent/pcap.py` (host code; the
port imports nothing of that package).
"""

from __future__ import annotations

import struct
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

MAGIC_US = 0xA1B2C3D4      # microsecond timestamps
MAGIC_NS = 0xA1B23C4D      # nanosecond timestamps
LINKTYPE_ETHERNET = 1

_FILE_HDR = struct.Struct("<IHHiIII")   # magic, vmaj, vmin, tz, sig, snap, lt
_REC_HDR_LEN = 16


class PcapFormatError(ValueError):
    pass


def read_pcap(path: str) -> Iterator[Tuple[int, bytes]]:
    """Yield (timestamp_ns, frame_bytes) from a classic pcap file.

    Supports us/ns magic in either byte order; requires Ethernet link
    type (what the packet decoder speaks). Truncated trailing records are
    dropped silently, like a capture cut mid-write.
    """
    with open(path, "rb") as f:
        head = f.read(_FILE_HDR.size)
        if len(head) < _FILE_HDR.size:
            raise PcapFormatError("short pcap file header")
        magic_le = struct.unpack("<I", head[:4])[0]
        magic_be = struct.unpack(">I", head[:4])[0]
        if magic_le in (MAGIC_US, MAGIC_NS):
            endian, magic = "<", magic_le
        elif magic_be in (MAGIC_US, MAGIC_NS):
            endian, magic = ">", magic_be
        else:
            raise PcapFormatError(f"not a pcap file: magic {magic_le:#x}")
        ns_scale = 1 if magic == MAGIC_NS else 1000
        _, _, _, _, _, snaplen, linktype = struct.unpack(
            endian + "IHHiIII", head)
        if linktype != LINKTYPE_ETHERNET:
            raise PcapFormatError(f"unsupported linktype {linktype} "
                                  "(only Ethernet)")
        # a corrupt record header must not drive a multi-GiB read; cap at
        # the file's own snaplen (or 256 KiB for degenerate headers), like
        # libpcap readers do
        max_len = min(snaplen or (1 << 18), 1 << 18)
        rec = struct.Struct(endian + "IIII")
        while True:
            rh = f.read(_REC_HDR_LEN)
            if len(rh) < _REC_HDR_LEN:
                return
            ts_sec, ts_frac, incl_len, _orig_len = rec.unpack(rh)
            if incl_len > max_len:
                raise PcapFormatError(
                    f"record length {incl_len} exceeds snaplen {max_len}")
            data = f.read(incl_len)
            if len(data) < incl_len:
                return  # truncated tail
            yield ts_sec * 1_000_000_000 + ts_frac * ns_scale, data


def write_pcap(path: str, frames: Sequence[bytes],
               timestamps_ns: Optional[Sequence[int]] = None,
               nanosecond: bool = True) -> int:
    """Write Ethernet frames as a classic pcap file; returns frames
    written. Default nanosecond flavor keeps agent timestamps exact."""
    if timestamps_ns is None:
        timestamps_ns = [i * 1_000_000 for i in range(len(frames))]
    w = PcapWriter(path, nanosecond=nanosecond)
    try:
        return w.write(frames, timestamps_ns)
    finally:
        w.close()


class PcapWriter:
    """Streaming pcap writer (the PCAP policy-action sink and write_pcap's
    engine): header once, records appended as they arrive."""

    def __init__(self, path: str, nanosecond: bool = True) -> None:
        self.path = path
        self._div = 1 if nanosecond else 1000
        self._f = open(path, "wb")
        self._f.write(_FILE_HDR.pack(MAGIC_NS if nanosecond else MAGIC_US,
                                     2, 4, 0, 0, 1 << 18,
                                     LINKTYPE_ETHERNET))
        self.frames_written = 0

    def write(self, frames: Sequence[bytes],
              timestamps_ns: Sequence[int]) -> int:
        if len(frames) != len(timestamps_ns):
            raise ValueError(f"{len(frames)} frames vs "
                             f"{len(timestamps_ns)} timestamps")
        for frame, ts in zip(frames, timestamps_ns):
            ts = int(ts)
            self._f.write(struct.pack("<IIII", ts // 1_000_000_000,
                                      (ts % 1_000_000_000) // self._div,
                                      len(frame), len(frame)))
            self._f.write(frame)
        self.frames_written += len(frames)
        return len(frames)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class PcapFrameSource:
    """Batched replay source with the capture-callable contract.

    `batches(n)` yields (frames, timestamps_ns) capture batches sized for
    the vectorized decoder; `feed_agent(agent)` drives a full replay and
    returns total valid packets — the e2e fixture-replay entry point.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self.frames_read = 0
        self._batch_iter: Optional[Iterator] = None

    def batches(self, batch_size: int = 4096
                ) -> Iterator[Tuple[List[bytes], np.ndarray]]:
        frames: List[bytes] = []
        stamps: List[int] = []
        for ts, frame in read_pcap(self.path):
            frames.append(frame)
            stamps.append(ts)
            if len(frames) >= batch_size:
                self.frames_read += len(frames)
                yield frames, np.asarray(stamps, np.uint64)
                frames, stamps = [], []
        if frames:
            self.frames_read += len(frames)
            yield frames, np.asarray(stamps, np.uint64)

    def feed_agent(self, agent, batch_size: int = 4096) -> int:
        valid = 0
        for frames, stamps in self.batches(batch_size):
            valid += agent.feed(frames, stamps)
        return valid

    # live capture-source contract (afpacket.CaptureLoop drives replay
    # files exactly like an interface; empty batch = EOF, loop idles)
    def read_batch(self) -> Tuple[List[bytes], List[int]]:
        if self._batch_iter is None:
            self._batch_iter = self.batches()
        try:
            frames, stamps = next(self._batch_iter)
            return frames, list(stamps)
        except StopIteration:
            time.sleep(0.05)   # EOF: don't let CaptureLoop busy-spin
            return [], []

    def close(self) -> None:
        self._batch_iter = None
