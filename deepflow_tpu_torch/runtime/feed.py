"""Overlapped host-to-device feed: a bounded window of dispatched groups.

The exporter's queue worker enqueues groups (cheap, back-pressured by a
bounded queue) instead of dispatching inline. A supervised feed thread
takes them up to `coalesce` at a time and calls the owner's
`process_group`, which copies each group to the device and dispatches
its program without waiting for it. At most `depth` dispatched groups
are in flight: before admitting another, the feed FENCES the oldest,
i.e. waits for its `torch.cuda.Event`, recorded on the compute stream
after the group's program. The fence is also what makes recycling a
staging buffer safe: the copy reads the host buffer asynchronously, and
a buffer goes back to its pool only after the fence of the program that
consumed the copy has retired. Host-path groups (a CPU device, degraded
mode) carry no fence (None).

Accounting contract:

- `pending()` counts every group item the feed still owes the device
  (queued + being processed + in flight), so a drain ladder that polls
  it never reads zero while rows are in the window;
- `drain()` is a barrier: when it returns True, everything enqueued
  before the call has been applied and fenced;
- a feed-thread crash is recovered on the supervisor's restart: the
  group that was mid-flight and everything in flight is counted lost
  through `on_restart`, never dropped silently.

Occupancy (runtime/profiler.py): every group's processing is a `feed`
span, every fence wait a `fence` span, and each fenced group a `device`
span ending at its fence's retirement (what `tpu_device_busy_fraction`
unions). With an `estimator` (the exporter's `BusyEstimator`) and a
group that lists its programs, the span's length is the device time of
those programs as gated samples measured it, never longer than the
group's dispatch -> fence interval; otherwise (the CPU) it is that
interval. The time the feed waited
for work with nothing in flight is the stall. With the process tracer
on, every 16th group sets the gauges `tpu_feed_overlap_efficiency` and
`tpu_feed_inflight`. None of it waits on the device: it timestamps the
fences the feed makes anyway.

State ownership: between `drain()` barriers the feed thread is the only
writer of the owner's device state; the window flush, checkpoint and
probe touch it only after a drain returned. So the owner's callbacks
never take the owner's state lock: the lock serializes producers
against the flush, the barrier serializes the flush against the feed.
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional, Tuple

from deepflow_tpu_torch.runtime.profiler import default_profiler
from deepflow_tpu_torch.runtime.supervisor import default_supervisor
from deepflow_tpu_torch.runtime.tracing import default_tracer

__all__ = ["DeviceFeed", "InFlight"]

_LOG = logging.getLogger(__name__)

# gauge cadence: every Nth group, the exporter's attribution cadence
_GAUGE_EVERY = 16


class InFlight(tuple):
    """(fence, rows, release, programs): one dispatched, unfenced group.
    `fence` is a `torch.cuda.Event` recorded after the group's program
    (None for a host-path group); `rows` the records it carried;
    `release` returns its staging buffers to their pool (or None);
    `programs` the keys of the programs it dispatched, for the
    device-time estimate."""

    __slots__ = ()

    def __new__(cls, fence: Any, rows: int,
                release: Optional[Callable[[], None]] = None,
                programs: tuple = ()):
        return tuple.__new__(cls, (fence, rows, release, tuple(programs)))

    @property
    def fence(self):
        return self[0]

    @property
    def rows(self) -> int:
        return self[1]

    @property
    def release(self):
        return self[2]

    @property
    def programs(self) -> tuple:
        return self[3]


class DeviceFeed:
    """The bounded queue, the supervised feed thread and the fence
    window. The owner supplies the device work through callbacks:

    - process_group(group) -> Optional[InFlight]: copy and dispatch a
      list of (item, batch_id) pairs; None when the group was absorbed
      on the host or an error it handled already counted it. Exceptions
      escaping it crash the feed thread into the supervisor on purpose:
      the restart and `on_restart` are the containment.
    - on_fence_error(exc, rows): an asynchronous device error surfaced
      at a fence; `rows` covers the failed group and every younger one
      in flight (they ran on the state the failed program left).
    - on_restart(rows): the supervisor restarted the feed thread after
      a crash; `rows` were in the window and are no longer trusted.
    """

    def __init__(self, name: str,
                 process_group: Callable[[List[Tuple[Any, int]]],
                                         Optional[InFlight]],
                 *, depth: int = 2, coalesce: int = 1,
                 on_fence_error: Optional[Callable[[BaseException, int],
                                                   None]] = None,
                 on_restart: Optional[Callable[[int], None]] = None,
                 estimator=None) -> None:
        self.name = name
        self._process_group = process_group
        self.depth = max(1, int(depth))
        self.coalesce = max(1, int(coalesce))
        self._on_fence_error = on_fence_error
        self._on_restart = on_restart
        self._estimator = estimator
        # bounded: a full queue back-pressures the enqueuing worker, so
        # overload lands in the exporter queue's counted drop-oldest
        cap = max(4, 2 * self.depth * self.coalesce)
        self._q: _queue.Queue = _queue.Queue(maxsize=cap)
        self._inflight: deque = deque()
        self._active: Optional[List[Tuple[Any, int]]] = None
        self._handle = None
        self._spawn_lock = threading.Lock()
        self._pending_lock = threading.Lock()
        self._queued_batches = 0
        self._active_batches = 0   # group inside process_group right now
        self.groups = 0
        self.batches = 0
        self.fences = 0
        self.fence_errors = 0
        self.crash_recoveries = 0
        self.fence_wait_s = 0.0
        # enqueue -> pull latency summed per item: the queue-dwell
        # signal the autotuner (runtime/autotune.py) reads
        self.queue_dwell_s = 0.0
        self.dwell_batches = 0
        self._closed = False
        self._tracer = default_tracer()
        self._prof = default_profiler()
        self._mark_t = time.perf_counter()
        self._mark_fence_s = 0.0

    # -- producer side -------------------------------------------------------
    def put(self, batch: Any, batch_id: int = -1) -> None:
        """Enqueue one item (blocks while the queue is full: that
        back-pressure is the bounded in-flight guarantee)."""
        self._ensure_started()
        with self._pending_lock:
            self._queued_batches += 1
        self._q.put(("batch", batch, batch_id, time.perf_counter()))

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Barrier: True once everything enqueued before this call has
        been applied and fenced; False if the feed thread did not get
        there within `timeout`."""
        if self._handle is None:
            return True        # nothing ever enqueued
        if self._closed and not self._handle.is_alive():
            return True        # close() already drained and stopped us
        done = threading.Event()
        self._q.put(("barrier", done))
        return done.wait(timeout)

    def pending(self) -> int:
        """Items the feed still owes the device: queued + active + in
        flight (drain() is the correctness barrier)."""
        with self._pending_lock:
            n = self._queued_batches + self._active_batches
        return n + len(self._inflight)

    def close(self, timeout: float = 10.0) -> None:
        """Stop the feed thread after it drains the queue and fences the
        window. Idempotent."""
        if self._handle is None or self._closed:
            self._closed = True
            return
        self._closed = True
        self._q.put(("stop",))
        self._handle.join(timeout=timeout)

    # -- feed thread ---------------------------------------------------------
    def _ensure_started(self) -> None:
        if self._handle is not None:
            return
        with self._spawn_lock:
            if self._handle is None:
                self._handle = default_supervisor().spawn(self.name,
                                                          self._run)

    def _run(self) -> None:
        sup = default_supervisor()
        if self._active is not None or self._inflight:
            self._recover_after_crash()
        while True:
            t0 = time.perf_counter()
            try:
                item = self._q.get(timeout=0.2)
            except _queue.Empty:
                sup.beat()
                continue
            if not self._inflight:
                # the device sat with an empty window until work arrived;
                # an idle pipeline (empty polls) accrues nothing
                self._prof.add_stall(time.perf_counter() - t0)
            sup.beat()
            if item[0] != "batch":
                if self._handle_control(item):
                    return
                continue
            now = time.perf_counter()
            self.queue_dwell_s += now - item[3]
            self.dwell_batches += 1
            group = [(item[1], item[2])]
            ctl = None
            while len(group) < self.coalesce:
                try:
                    nxt = self._q.get_nowait()
                except _queue.Empty:
                    break
                if nxt[0] == "batch":
                    self.queue_dwell_s += now - nxt[3]
                    self.dwell_batches += 1
                    group.append((nxt[1], nxt[2]))
                else:
                    ctl = nxt          # handled after the group applies
                    break
            self._apply_group(group)
            if ctl is not None and self._handle_control(ctl):
                return

    def _handle_control(self, item: tuple) -> bool:
        """Barrier or stop; True = the loop should exit."""
        self._fence_all()
        if item[0] == "barrier":
            item[1].set()
            return False
        return True                    # "stop": normal completion

    def _apply_group(self, group: List[Tuple[Any, int]]) -> None:
        # visible to pending() the whole time: queued -> active -> in
        # flight, the counts may overlap but never gap
        with self._pending_lock:
            self._queued_batches -= len(group)
            self._active_batches = len(group)
        self._active = group
        t0 = time.perf_counter()
        out = self._process_group(group)
        t1 = time.perf_counter()
        self._prof.record("feed", f"group[{len(group)}]", t1 - t0,
                          rows=sum(int(getattr(item, "valid", 0))
                                   for item, _ in group))
        self._active = None
        self.groups += 1
        self.batches += len(group)
        if out is not None:
            # the dispatch time rides beside the fence: [dispatch,
            # retirement] is the device interval the busy share unions
            self._inflight.append((out, t1))
            while len(self._inflight) > self.depth:
                self._fence_one(*self._inflight.popleft())
        with self._pending_lock:
            self._active_batches = 0
        self._maybe_gauges()

    def _fence_one(self, f: InFlight,
                   t_dispatch: Optional[float] = None) -> None:
        """Wait for one dispatched group to retire: the one blocking
        sync of the feed. An error here is an asynchronous device error:
        every younger group in flight ran on the state it left, so all
        of them are discarded and the loss reported once."""
        t0 = time.perf_counter()
        try:
            if f.fence is not None:
                f.fence.synchronize()
        except Exception as e:
            self.fence_wait_s += time.perf_counter() - t0
            self.fence_errors += 1
            if f.release is not None:
                f.release()
            extra = self._discard_inflight()
            if self._on_fence_error is not None:
                self._on_fence_error(e, f.rows + extra)
            return
        t1 = time.perf_counter()
        self.fence_wait_s += t1 - t0
        self.fences += 1
        self._prof.record("fence", "wait", t1 - t0, rows=f.rows)
        # released first: the release reads the group's own gated sample
        if f.release is not None:
            f.release()
        if t_dispatch is not None:
            dev_s = t1 - t_dispatch
            if (f.fence is not None and self._estimator is not None
                    and f.programs):
                dev_s = self._estimator.estimate(f.programs, dev_s)
            self._prof.record("device", "update", dev_s, rows=f.rows)

    def _fence_all(self) -> None:
        while self._inflight:
            self._fence_one(*self._inflight.popleft())

    def _discard_inflight(self) -> int:
        """Drop every outstanding group, swallowing its (expected)
        error; returns the rows they carried, for the caller to count."""
        rows = 0
        while self._inflight:
            f, _t = self._inflight.popleft()
            rows += f.rows
            try:
                if f.fence is not None:
                    f.fence.synchronize()
            except Exception:
                pass
            if f.release is not None:
                f.release()
        return rows

    def _recover_after_crash(self) -> None:
        """Restarted mid-group: the active group may or may not have
        reached the device and the state may be half-written either
        way, so everything in the window is counted lost and the owner
        restores its state."""
        group, self._active = self._active, None
        with self._pending_lock:
            self._active_batches = 0
        rows = sum(int(getattr(tb, "valid", 0)) for tb, _ in (group or []))
        rows += self._discard_inflight()
        self.crash_recoveries += 1
        _LOG.warning("%s: recovered after crash; %d rows in the window "
                     "counted lost", self.name, rows)
        if self._on_restart is not None:
            self._on_restart(rows)

    def _maybe_gauges(self) -> None:
        tr = self._tracer
        if not tr.enabled or self.groups % _GAUGE_EVERY:
            return
        now = time.perf_counter()
        wall = now - self._mark_t
        if wall > 0:
            # the share of feed wall time spent waiting on fences: ~1 =
            # the card is the bottleneck, ~0 = the host feed is
            tr.gauge("tpu_feed_overlap_efficiency",
                     min(1.0, max(0.0, (self.fence_wait_s
                                        - self._mark_fence_s) / wall)))
        tr.gauge("tpu_feed_inflight", float(len(self._inflight)))
        self._mark_t = now
        self._mark_fence_s = self.fence_wait_s

    def counters(self) -> dict:
        return {"feed_groups": self.groups, "feed_batches": self.batches,
                "feed_pending": self.pending(),
                "feed_fences": self.fences,
                "feed_fence_errors": self.fence_errors,
                "feed_fence_wait_s": round(self.fence_wait_s, 6),
                "feed_queue_dwell_s": round(self.queue_dwell_s, 6),
                "feed_queue_dwell_batches": self.dwell_batches,
                "feed_crash_recoveries": self.crash_recoveries}
