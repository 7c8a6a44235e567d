"""Fixed-size overwrite queues with drop accounting.

Between pipeline stages records move through bounded rings that
overwrite the oldest entry instead of blocking the producer; the loss is
deliberate and counted (`overwritten`). A lock + condvar ring with the
batch `gets` contract the decoders and the exporter's worker rely on.
With `trace_dwell` armed and the tracer on, the time the oldest item of
each drained batch spent parked lands in the tracer under one stage
(`queue.ingest.<stream>`, `queue.exporter.<name>`).

With a spill sink armed (`spill_arm`, runtime/spill.py), a put that would
push the ring past the watermark diverts the overflow to the sink (disk
segments) instead of overwriting, counted as `spilled`; the spill's drain
thread puts the items back through `reinject`, which bypasses the sink.
A debug tap (`tap`, `tap_take`) samples summaries of the next items put.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional, Sequence

from deepflow_tpu_torch.runtime.faults import FAULT_QUEUE_STALL, default_faults

_FAULTS = default_faults()


class OverwriteQueue:
    """Bounded ring; puts never block, overwriting the oldest on overflow."""

    def __init__(self, name: str, capacity: int) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.name = name
        self.capacity = capacity
        self._buf: List[Any] = [None] * capacity
        self._head = 0          # next slot to read
        self._size = 0
        self._ready = threading.Condition(threading.Lock())
        self._closed = False
        self.in_count = 0
        self.out_count = 0
        self.overwritten = 0
        self.closed_dropped = 0   # puts after close(): counted, not raised
        self.spilled = 0          # items diverted to the armed spill sink
        # the spill sink, called after the condvar is released
        self._spill_sink: Optional[Callable[[Sequence[Any]], None]] = None
        self._spill_mark = 0
        # debug tap: the next `_tap_left` puts record item summaries
        self._tap_left = 0
        self._tap_out: List[str] = []
        # dwell sampling (trace_dwell): per-slot put timestamps
        self._tracer = None
        self._dwell_stage = ""
        self._put_ts: Optional[List[float]] = None

    def __len__(self) -> int:
        with self._ready:
            return self._size

    def put(self, item: Any) -> None:
        self.puts((item,))

    def puts(self, items: Sequence[Any]) -> None:
        """Append a batch, overwriting the oldest entries when full. A
        closed queue counts the batch as `closed_dropped` instead of
        raising: producers race the close during shutdown."""
        tracer = self._tracer
        tracing = tracer is not None and tracer.enabled
        now = time.perf_counter() if tracing else 0.0
        overflow: Optional[Sequence[Any]] = None
        with self._ready:
            if self._closed:
                self.closed_dropped += len(items)
                return
            sink = self._spill_sink
            if sink is not None and \
                    self._size + len(items) > self._spill_mark:
                headroom = max(0, self._spill_mark - self._size)
                overflow = items[headroom:]
                items = items[:headroom]
                self.spilled += len(overflow)
            self._append_locked(items, tracing, now)
            if items:
                self._ready.notify_all()
        if overflow:
            # outside the condvar: the sink does disk I/O under its own
            # locks
            sink(overflow)

    def reinject(self, items: Sequence[Any]) -> None:
        """Put spilled items back without consulting the spill sink (the
        spill's drain thread; a sink-aware put would loop). Overflow
        falls back to counted overwrites; the drain checks headroom
        first."""
        tracer = self._tracer
        tracing = tracer is not None and tracer.enabled
        now = time.perf_counter() if tracing else 0.0
        with self._ready:
            if self._closed:
                self.closed_dropped += len(items)
                return
            self._append_locked(items, tracing, now)
            self._ready.notify_all()

    def _append_locked(self, items: Sequence[Any], tracing: bool,
                       now: float) -> None:
        """The ring append shared by puts and reinject: counted
        overwrites, dwell stamps, tap samples, `in_count`."""
        for item in items:
            tail = (self._head + self._size) % self.capacity
            if self._size == self.capacity:
                self._head = (self._head + 1) % self.capacity
                self.overwritten += 1
            else:
                self._size += 1
            self._buf[tail] = item
            if tracing:
                self._put_ts[tail] = now
            if self._tap_left > 0:
                self._tap_left -= 1
                self._tap_out.append(repr(item)[:240])
        self.in_count += len(items)

    def spill_arm(self, sink: Callable[[Sequence[Any]], None],
                  watermark: int) -> None:
        """Divert puts past `watermark` items to `sink`."""
        with self._ready:
            self._spill_sink = sink
            self._spill_mark = max(1, min(int(watermark), self.capacity))

    def spill_disarm(self) -> None:
        with self._ready:
            self._spill_sink = None

    def gets(self, max_items: int,
             timeout: Optional[float] = None) -> List[Any]:
        """Take up to max_items; block until one is there, the timeout
        passes, or the queue closes. [] only on timeout or closed and
        drained."""
        if _FAULTS.enabled:   # chaos: a stalled consumer
            _FAULTS.maybe_stall(FAULT_QUEUE_STALL, key=self.name)
        tracer = self._tracer
        dwell = None
        with self._ready:
            if self._size == 0 and not self._closed:
                self._ready.wait(timeout)
            n = min(self._size, max_items)
            if (n and tracer is not None and tracer.enabled
                    and self._put_ts is not None):
                # one observation per batch: the oldest item's dwell,
                # emitted after the condvar is released
                ts = self._put_ts[self._head]
                if ts > 0.0:
                    dwell = time.perf_counter() - ts
            out = []
            for _ in range(n):
                out.append(self._buf[self._head])
                self._buf[self._head] = None
                self._head = (self._head + 1) % self.capacity
            self._size -= n
            self.out_count += n
        if dwell is not None:
            tracer.observe(self._dwell_stage, dwell)
        return out

    def close(self) -> None:
        """Wake all readers; later puts are counted drops, gets drain
        what is left and then return []."""
        with self._ready:
            self._closed = True
            self._ready.notify_all()

    def drain_remaining(self) -> List[Any]:
        """Take everything parked in the ring at once (the shutdown
        spill: the drain ladder hands it to disk)."""
        with self._ready:
            out = []
            for _ in range(self._size):
                out.append(self._buf[self._head])
                self._buf[self._head] = None
                self._head = (self._head + 1) % self.capacity
            self._size = 0
            self.out_count += len(out)
            return out

    @property
    def closed(self) -> bool:
        return self._closed

    def trace_dwell(self, tracer, stage: str) -> None:
        """Arm dwell sampling into `tracer` under `stage`: one
        perf_counter per put batch and a float store per item, only
        while the tracer is enabled."""
        with self._ready:
            self._tracer = tracer
            self._dwell_stage = stage
            self._put_ts = [0.0] * self.capacity

    def tap(self, count: int) -> None:
        """Sample summaries of the next `count` items put."""
        with self._ready:
            self._tap_left = max(0, count)
            self._tap_out = []

    def tap_take(self) -> List[str]:
        """Collect (and clear) the sampled summaries."""
        with self._ready:
            out, self._tap_out = self._tap_out, []
            return out

    def counters(self) -> dict:
        with self._ready:
            return {"in": self.in_count, "out": self.out_count,
                    "overwritten": self.overwritten,
                    "closed_dropped": self.closed_dropped,
                    "spilled": self.spilled,
                    "pending": self._size}


class MultiQueue:
    """N OverwriteQueues addressed by a key (reference: FixedMultiQueue):
    a key always lands on one queue, so one source's stream stays
    ordered within a single consumer. The receiver keys by vtap_id."""

    def __init__(self, name: str, n_queues: int, capacity: int) -> None:
        self.name = name
        self.queues = [OverwriteQueue(f"{name}.{i}", capacity)
                       for i in range(n_queues)]

    def __len__(self) -> int:
        return sum(len(q) for q in self.queues)

    def put(self, key: int, item: Any) -> None:
        self.queues[key % len(self.queues)].put(item)

    def puts(self, key: int, items: Sequence[Any]) -> None:
        self.queues[key % len(self.queues)].puts(items)

    def gets(self, queue_index: int, max_items: int,
             timeout: Optional[float] = None) -> List[Any]:
        return self.queues[queue_index].gets(max_items, timeout)

    def close(self) -> None:
        for q in self.queues:
            q.close()

    def trace_dwell(self, tracer, stage: str) -> None:
        """Arm dwell sampling on every sub-queue under one stage."""
        for q in self.queues:
            q.trace_dwell(tracer, stage)

    def tap(self, count: int) -> None:
        """Arm every sub-queue to sample up to `count` items."""
        for q in self.queues:
            q.tap(count)

    def untap(self) -> None:
        """Disarm every sub-queue and drop what it sampled (an armed tap
        pays a repr on the put path)."""
        for q in self.queues:
            q.tap(0)

    def tap_take(self) -> List[str]:
        out: List[str] = []
        for q in self.queues:
            out.extend(q.tap_take())
        return out

    def counters(self) -> dict:
        agg: dict = {}
        for q in self.queues:
            for k, v in q.counters().items():
                agg[k] = agg.get(k, 0) + v
        return agg
