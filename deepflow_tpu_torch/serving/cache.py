"""In-process snapshot cache with staleness-bounded reads.

The read plane's only state: a bounded deque of the most recent
`runtime.snapbus.SketchSnapshot`s, fed push-style by the bus (the
subscriber callback appends a reference: it runs at window close under
the exporter's state lock and must stay O(1)).

Staleness contract (`max_staleness_s`): every read checks the newest
cached snapshot's age. A stale cache refreshes: it re-pulls the bus
(`refresh`: the in-process latest, else the disk store a companion or
earlier process wrote). It never syncs the device and never touches the
feed path; if nothing newer exists anywhere, the stale snapshot is
served with its age reported (`stale_served` counts it, the
`sketch_snapshot_staleness_s` gauge shows it).

A copy of the JAX package's `serving/cache.py` over the port's bus.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional

from deepflow_tpu_torch.runtime.snapbus import SketchSnapshot, SnapshotBus

__all__ = ["SnapshotCache"]


class SnapshotCache:
    """Subscribes to a SnapshotBus; serves recent snapshots to readers."""

    def __init__(self, bus: SnapshotBus, max_staleness_s: float = 5.0,
                 history: int = 128,
                 clock: Callable[[], float] = time.time) -> None:
        self.bus = bus
        self.max_staleness_s = float(max_staleness_s)
        self.history = int(history)
        self._clock = clock
        self._lock = threading.Lock()
        self._snaps: deque = deque(maxlen=self.history)
        self.reads = 0
        self.refreshes = 0
        self.stale_served = 0
        self._unsubscribe = bus.subscribe(self._on_snapshot)

    # -- bus side ----------------------------------------------------------
    def _on_snapshot(self, snap: SketchSnapshot) -> None:
        """Subscriber callback: runs at window close under the
        exporter's state lock — append a reference, nothing else."""
        with self._lock:
            self._snaps.append(snap)

    def close(self) -> None:
        self._unsubscribe()

    # -- read side ---------------------------------------------------------
    def refresh(self) -> Optional[SketchSnapshot]:
        """The sanctioned stale-cache recovery: re-pull the bus (its
        in-process latest, else its disk store). Never the device."""
        self.refreshes += 1
        snap = self.bus.latest()
        if snap is not None:
            with self._lock:
                last = self._snaps[-1] if self._snaps else None
                # disk re-reads mint fresh seqs for the SAME snapshot:
                # dedup on (step, wall_time) so a quiet bus polled every
                # read doesn't fill the deque with copies
                if last is None or (snap is not last
                                    and (snap.step, snap.wall_time)
                                    > (last.step, last.wall_time)):
                    self._snaps.append(snap)
        return snap

    def staleness_s(self) -> float:
        """Age of the newest snapshot; +inf when none exists yet."""
        with self._lock:
            snap = self._snaps[-1] if self._snaps else None
        if snap is None:
            return float("inf")
        return max(0.0, self._clock() - snap.wall_time)

    def latest(self) -> Optional[SketchSnapshot]:
        """Staleness-bounded read of the newest snapshot."""
        self.reads += 1
        with self._lock:
            snap = self._snaps[-1] if self._snaps else None
        now = self._clock()
        if snap is None or now - snap.wall_time > self.max_staleness_s:
            got = self.refresh()
            if got is not None and (snap is None or got.seq >= snap.seq):
                snap = got
            if snap is not None \
                    and now - snap.wall_time > self.max_staleness_s:
                # nothing fresher exists anywhere: serve it, count it
                self.stale_served += 1
        return snap

    def window_range(self, lo: Optional[float],
                     hi: Optional[float]) -> List[SketchSnapshot]:
        """Snapshots whose wall_time falls in [lo, hi) — the mapping
        from query time bounds to snapshot windows. None = unbounded.
        Ascending wall-time order; duplicate steps keep the newest seq
        (a checkpoint_now re-publish supersedes the cadence publish)."""
        self.reads += 1
        with self._lock:
            snaps = list(self._snaps)
        by_step: dict = {}
        for s in snaps:
            if lo is not None and s.wall_time < lo:
                continue
            if hi is not None and s.wall_time >= hi:
                continue
            prev = by_step.get(s.step)
            if prev is None or s.seq > prev.seq:
                by_step[s.step] = s
        return sorted(by_step.values(), key=lambda s: (s.wall_time, s.step))

    def counters(self) -> dict:
        with self._lock:
            cached = len(self._snaps)
            newest = self._snaps[-1].step if self._snaps else -1
        st = self.staleness_s()
        return {"cached": cached, "newest_step": newest,
                "reads": self.reads, "refreshes": self.refreshes,
                "stale_served": self.stale_served,
                "staleness_s": -1.0 if st == float("inf") else round(st, 3),
                "max_staleness_s": self.max_staleness_s}
