"""Disk-spill queues: overflow past a watermark lands in CRC-framed
segment files instead of overwriting the oldest frames.

An `OverwriteQueue` replaces its oldest frames the moment a consumer
falls behind. An armed `SpillQueue` diverts the put-path overflow to
bounded segment files (`spill-<seq>.seg`, each record `u32 len | u32
crc32 | frame bytes`, the frame in its own wire encoding through
`wire/framing.py`) and puts it back through a supervised drain thread
once the ring has headroom again. The only loss left is the eviction of
the oldest segment past the disk byte budget (`spill_evicted`, counted)
and failed segment writes (`spill_write_errors`; their records count
into `spill_evicted` too). Segments left on disk by a kill or a crash
replay when the next process arms the same directory: closed segments
are fsynced when they roll, so a kill loses at most the open segment,
and a torn tail is found by the CRC framing and skipped, never
mis-decoded. The files are byte for byte those of the JAX package's
spill, so either package replays the other's segments.

Ordering: replayed frames re-enter the ring behind live traffic (the
ring never blocks on disk), so a drained backlog arrives late but
intact. `close(spill_remaining=True)` (the Ingester's drain ladder)
parks whatever never drained in segments for the next start; a drain
stopped mid-segment leaves that segment on disk, so a restart replays it
whole: at least once, with at most one segment of duplicates.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from deepflow_tpu_torch.runtime.faults import FAULT_SPILL_WRITE, default_faults
from deepflow_tpu_torch.runtime.queues import MultiQueue, OverwriteQueue
from deepflow_tpu_torch.wire.framing import Frame, FrameReader, encode_frame

__all__ = ["SegmentStore", "SpillQueue", "SpillGroup", "SpillWriteError",
           "encode_frame_blob", "decode_frame_blob"]


class SpillWriteError(OSError):
    """A segment write failed mid-batch. `written` = records durably
    framed before the failure — the caller books only the remainder as
    loss, because the written prefix WILL replay (the failed segment is
    rolled so later appends never write past a torn record)."""

    def __init__(self, written: int) -> None:
        super().__init__(f"segment write failed after {written} records")
        self.written = written

_REC = struct.Struct("<II")            # record length, crc32(payload)
_SEG_PREFIX = "spill-"
_SEG_SUFFIX = ".seg"


def encode_frame_blob(frame: Frame) -> bytes:
    """Serialize a receiver Frame back into its own wire encoding — the
    one format every replay path already knows how to parse."""
    return encode_frame(frame.msg_type, frame.payload, frame.flow_header)


def decode_frame_blob(blob: bytes) -> Frame:
    for frame in FrameReader().feed(blob):
        return frame
    raise ValueError("blob is not a complete wire frame")


class SegmentStore:
    """Bounded, CRC-framed, append-only segment files in one directory.

    Writer side appends records to the open (newest) segment, rolling —
    fsync, close, open next — at `segment_bytes`. Reader side consumes
    whole segments oldest-first. Over `budget_bytes` the OLDEST closed
    segment is evicted; its record count is returned so the caller can
    book the loss. All methods are safe under concurrent producers and
    one drain thread (`_io_lock`)."""

    def __init__(self, directory: str, name: str = "spill",
                 segment_bytes: int = 1 << 20,
                 budget_bytes: int = 64 << 20) -> None:
        self.directory = directory
        self.name = name
        self.segment_bytes = max(4096, int(segment_bytes))
        self.budget_bytes = max(self.segment_bytes, int(budget_bytes))
        self._io_lock = threading.Lock()
        self._open_path: Optional[str] = None
        self._open_f = None
        # the segment take_oldest handed out but hasn't deleted yet:
        # budget eviction must skip it, or the same records get booked
        # BOTH replayed and evicted (and the unlink under the reader
        # reads as a phantom torn segment)
        self._draining: Optional[str] = None
        self._faults = default_faults()
        os.makedirs(directory, exist_ok=True)
        # running ledger so the producer-path budget check never has to
        # listdir/stat the directory: path -> bytes, path -> records
        # (record counts unknown for segments inherited from a previous
        # process — eviction falls back to a one-off scan for those)
        self._sizes: Dict[str, int] = {}
        self._counts: Dict[str, int] = {}
        for n in self._segment_names():
            p = os.path.join(directory, n)
            try:
                self._sizes[p] = os.path.getsize(p)
            except OSError:
                pass
        seqs = [self._seq_of(n) for n in self._segment_names()]
        self._next_seq = (max(seqs) + 1) if seqs else 0

    # -- naming ------------------------------------------------------------
    @staticmethod
    def _seq_of(fname: str) -> int:
        return int(fname[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])

    def _segment_names(self) -> List[str]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        out = []
        for n in names:
            if not (n.startswith(_SEG_PREFIX) and n.endswith(_SEG_SUFFIX)):
                continue
            stem = n[len(_SEG_PREFIX):-len(_SEG_SUFFIX)]
            if stem.isdigit():
                out.append(n)
        return sorted(out)

    # -- write path --------------------------------------------------------
    def append(self, blobs: Sequence[bytes]) -> Tuple[int, int]:
        """Write records to the open segment (rolling as needed).
        Returns (records_written, records_evicted_for_budget). Raises on
        write failure — including the FAULT_SPILL_WRITE chaos site — with
        nothing partially booked; the caller owns loss accounting."""
        with self._io_lock:
            if self._faults.enabled:
                self._faults.maybe_raise(FAULT_SPILL_WRITE, key=self.name)
            durable = 0    # this batch's records in rolled (fsync'd) segments
            in_open = 0    # this batch's records in the still-open segment
            try:
                for blob in blobs:
                    f = self._open_for_append_locked()
                    f.write(_REC.pack(len(blob), zlib.crc32(blob)))
                    f.write(blob)
                    in_open += 1
                    self._sizes[self._open_path] = f.tell()
                    self._counts[self._open_path] = \
                        self._counts.get(self._open_path, 0) + 1
                    if f.tell() >= self.segment_bytes:
                        self._roll_locked()
                        durable += in_open
                        in_open = 0
                if self._open_f is not None:
                    self._open_f.flush()
            except Exception:
                raise SpillWriteError(
                    durable + self._recover_open_locked(in_open)) from None
            evicted = self._enforce_budget_locked()
            return durable + in_open, evicted

    def _recover_open_locked(self, batch_in_open: int) -> int:
        """After a failed write: close the open segment (the fd must
        not leak toward EMFILE), RESCAN it for the intact record count
        — writes are buffered, so Python-level write() success is not
        durability (ENOSPC often only surfaces at a later flush) —
        correct the ledger to what is really on disk, and return how
        many of THIS batch's records survived. Counting optimistically
        here would book records as spilled (replayable) that replay can
        never recover: uncounted loss."""
        path = self._open_path
        if path is None:
            return 0
        prior = self._counts.get(path, 0) - batch_in_open
        try:
            # roll away from the torn tail so later appends never
            # write past it (replay stops at the CRC)
            self._roll_locked()
        except OSError:
            try:
                if self._open_f is not None:
                    self._open_f.close()
            except OSError:
                pass
            self._open_f = None
            self._open_path = None
        actual = len(read_segment(path)[0])
        self._counts[path] = actual
        try:
            self._sizes[path] = os.path.getsize(path)
        except OSError:
            self._sizes.pop(path, None)
        return max(0, actual - prior)

    def _open_for_append_locked(self):
        if self._open_f is None:
            path = os.path.join(
                self.directory,
                f"{_SEG_PREFIX}{self._next_seq:012d}{_SEG_SUFFIX}")
            self._next_seq += 1
            self._open_f = open(path, "ab")
            self._open_path = path
        return self._open_f

    def _roll_locked(self) -> None:
        """Close the open segment durably: flush + fsync, so only the
        open segment is ever at risk from a SIGKILL."""
        if self._open_f is None:
            return
        self._open_f.flush()
        os.fsync(self._open_f.fileno())
        self._open_f.close()
        self._open_f = None
        self._open_path = None

    def _enforce_budget_locked(self) -> int:
        evicted = 0
        while sum(self._sizes.values()) > self.budget_bytes:
            # never evict the open segment (the only home for the
            # freshest records — the budget floor is one segment) or
            # the one the drain thread is mid-replay on
            victims = sorted(p for p in self._sizes
                             if p not in (self._open_path,
                                          self._draining))
            if not victims:
                return evicted
            path = victims[0]
            count = self._counts.get(path)
            if count is None:      # inherited from a prior process
                count = len(read_segment(path)[0])
            evicted += count
            self._sizes.pop(path, None)
            self._counts.pop(path, None)
            try:
                os.unlink(path)
            except OSError:
                return evicted
        return evicted

    # -- read path ---------------------------------------------------------
    def take_oldest(self) -> Optional[Tuple[str, List[bytes], bool]]:
        """Read the oldest segment whole: (path, records, torn). Rolls
        the open segment first when it is the only one holding data, so
        a drain never starves behind the writer's open handle. Returns
        None when nothing is pending. Does NOT delete — the caller
        deletes after a complete re-inject, so a crash mid-drain replays
        the segment instead of losing it."""
        with self._io_lock:
            if not self._sizes:
                return None
            path = sorted(self._sizes)[0]
            if path == self._open_path:
                self._roll_locked()
            # mark before releasing the lock: budget eviction must not
            # unlink the file while the (lock-free) read below runs
            self._draining = path
        records, torn = read_segment(path)
        return path, records, torn

    def delete(self, path: str) -> None:
        with self._io_lock:
            self._sizes.pop(path, None)
            self._counts.pop(path, None)
            if self._draining == path:
                self._draining = None
            try:
                os.unlink(path)
            except OSError:
                pass

    def pending(self) -> Tuple[int, int]:
        """(segments on disk, total bytes)."""
        with self._io_lock:
            return len(self._sizes), sum(self._sizes.values())

    def close(self) -> None:
        """Durably close the open segment (graceful shutdown syncs
        everything; only a kill can lose the open segment)."""
        with self._io_lock:
            self._roll_locked()


def read_segment(path: str) -> Tuple[List[bytes], bool]:
    """Decode one segment file. Returns (records, torn): a torn tail —
    truncated header, short payload, or CRC mismatch, the SIGKILL
    shapes — stops the scan at the last intact record."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return [], True
    records: List[bytes] = []
    off = 0
    while off + _REC.size <= len(data):
        length, crc = _REC.unpack_from(data, off)
        off += _REC.size
        if off + length > len(data):
            return records, True           # torn mid-payload
        blob = data[off:off + length]
        if zlib.crc32(blob) != crc:
            return records, True           # torn / bit-rotted record
        records.append(blob)
        off += length
    return records, off != len(data)


class SpillQueue:
    """Arms disk spill on one OverwriteQueue and owns its drain thread.

    Put-path overflow past `watermark` (fraction of capacity) diverts
    to segment files; the supervised drain thread re-injects whole
    segments whenever the ring is below `low_watermark`, which also
    replays any segments a previous process left behind."""

    def __init__(self, queue: OverwriteQueue, directory: str,
                 encode: Callable[[Any], bytes] = encode_frame_blob,
                 decode: Callable[[bytes], Any] = decode_frame_blob,
                 segment_bytes: int = 1 << 20,
                 budget_bytes: int = 64 << 20,
                 watermark: float = 0.75,
                 low_watermark: float = 0.25,
                 reinject_batch: int = 128) -> None:
        self.queue = queue
        self.store = SegmentStore(directory, name=queue.name,
                                  segment_bytes=segment_bytes,
                                  budget_bytes=budget_bytes)
        self._encode = encode
        self._decode = decode
        self._mark = max(1, int(queue.capacity * watermark))
        self._low = max(0, int(queue.capacity * low_watermark))
        # clamped to the watermark so `mark - batch` (the re-inject
        # headroom test) can never go negative and wedge the drain
        self._reinject_batch = max(1, min(reinject_batch, self._mark))
        self._stop = threading.Event()
        self._handle = None
        # loss/flow accounting (all reachable via counters())
        self.spilled_records = 0      # records written to segments
        self.replayed = 0             # records re-injected into the ring
        self.spill_evicted = 0        # TRUE loss: budget eviction + failed writes
        self.spill_write_errors = 0   # append() raises (incl. chaos site)
        self.torn_segments = 0        # tails lost to a kill, detected by CRC
        self.decode_errors = 0        # replayed blob that no longer parses

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor

        self.queue.spill_arm(self._sink, self._mark)
        self._handle = default_supervisor().spawn(
            f"spill-drain-{self.queue.name}", self._drain_loop)

    def close(self, spill_remaining: bool = False) -> None:
        self._stop.set()
        if self._handle is not None:
            self._handle.stop()
            self._handle.join(timeout=5)
            self._handle = None
        self.queue.spill_disarm()
        if spill_remaining:
            left = self.queue.drain_remaining()
            if left:
                self._sink(left)
        self.store.close()

    # -- put-path sink (called by OverwriteQueue AFTER its lock) -----------
    def _sink(self, items: Sequence[Any]) -> None:
        blobs = []
        for item in items:
            try:
                blobs.append(self._encode(item))
            except Exception:
                self.spill_evicted += 1    # unserializable: counted loss
        if not blobs:
            return
        try:
            written, evicted = self.store.append(blobs)
            self.spilled_records += written
            self.spill_evicted += evicted
        except SpillWriteError as e:
            # disk full / EIO / FAULT_SPILL_WRITE: the undurable
            # remainder is counted loss — bounded and visible, never an
            # exception into the producer (a receiver dispatch thread);
            # the durable prefix will replay and is counted spilled
            self.spill_write_errors += 1
            self.spilled_records += e.written
            self.spill_evicted += len(blobs) - e.written
        except Exception:
            self.spill_write_errors += 1
            self.spill_evicted += len(blobs)

    # -- drain -------------------------------------------------------------
    def _drain_loop(self) -> None:
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor

        sup = default_supervisor()
        while not self._stop.is_set():
            sup.beat()
            if len(self.queue) > self._low:
                self._stop.wait(0.05)
                continue
            got = self.store.take_oldest()
            if got is None:
                self._stop.wait(0.05)
                continue
            path, blobs, torn = got
            if torn:
                self.torn_segments += 1
            items = []
            for b in blobs:
                try:
                    items.append(self._decode(b))
                except Exception:
                    self.decode_errors += 1
            i = 0
            while i < len(items):
                sup.beat()   # sustained overload parks us HERE for long
                if self._stop.is_set():
                    # mid-segment stop: leave the file for the next
                    # start (at-least-once; <=1 segment of duplicates)
                    return
                if len(self.queue) > self._mark - self._reinject_batch:
                    self._stop.wait(0.02)
                    continue
                chunk = items[i:i + self._reinject_batch]
                self.queue.reinject(chunk)
                self.replayed += len(chunk)
                i += len(chunk)
            self.store.delete(path)

    # -- observability -----------------------------------------------------
    def counters(self) -> dict:
        segments, seg_bytes = self.store.pending()
        return {
            "spilled_records": self.spilled_records,
            "replayed": self.replayed,
            "spill_evicted": self.spill_evicted,
            "spill_write_errors": self.spill_write_errors,
            "torn_segments": self.torn_segments,
            "decode_errors": self.decode_errors,
            "pending_segments": segments,
            "pending_bytes": seg_bytes,
        }


class SpillGroup:
    """One SpillQueue per sub-queue of the ingest MultiQueues — the unit
    the Ingester arms, starts, drains and scrapes as a whole."""

    def __init__(self, queues: Dict[str, MultiQueue], directory: str,
                 segment_bytes: int = 1 << 20,
                 budget_bytes: int = 64 << 20,
                 watermark: float = 0.75) -> None:
        self.directory = directory
        self.spills: List[SpillQueue] = []
        for mq in queues.values():
            for q in mq.queues:
                self.spills.append(SpillQueue(
                    q, os.path.join(directory, q.name),
                    segment_bytes=segment_bytes,
                    budget_bytes=budget_bytes, watermark=watermark))

    def start(self) -> None:
        for s in self.spills:
            s.start()

    def close(self, spill_remaining: bool = False) -> None:
        for s in self.spills:
            s.close(spill_remaining=spill_remaining)

    def pending_segments(self) -> int:
        return sum(s.store.pending()[0] for s in self.spills)

    def per_queue(self) -> Dict[str, dict]:
        """The `spill` debug command's rows."""
        return {s.queue.name: s.counters() for s in self.spills}

    def counters(self) -> dict:
        agg: dict = {}
        for s in self.spills:
            for k, v in s.counters().items():
                agg[k] = agg.get(k, 0) + v
        return agg
