"""Disk watermark GC (reference: server/ingester/ckmonitor/monitor.go).

The reference watches system.disks and force-drops the oldest partitions
when free space crosses a threshold. Here the store owns its directory, so
the monitor bounds total store bytes: above the high watermark it drops the
globally-oldest partitions (across every table) until under the low one.
Each sweep also expires TTL partitions and runs one compaction pass per
table. The sweep thread runs under the supervisor; `counters()` is what
a host registers with its stats registry.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

from deepflow_tpu_torch.runtime.supervisor import default_supervisor
from deepflow_tpu_torch.store.db import Store


class DiskMonitor:
    def __init__(self, store: Store, max_bytes: int,
                 low_fraction: float = 0.8,
                 interval: float = 60.0) -> None:
        self.store = store
        self.max_bytes = max_bytes
        self.low_bytes = int(max_bytes * low_fraction)
        self.interval = interval
        self._stop = threading.Event()
        self._thread = None            # supervisor ThreadHandle
        self.partitions_dropped = 0
        self.segments_compacted = 0
        self.ttl_dropped = 0
        self.sweep_errors = 0
        self.last_sweep_error = ""

    def start(self) -> None:
        # supervised; beat_period_s lets the supervisor derive the
        # deadman policy from the sweep cadence (a 60s interval
        # legitimately outlives the default watchdog window)
        self._thread = default_supervisor().spawn(
            "ckmonitor", self._run, beat_period_s=self.interval)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.stop()
            self._thread.join(timeout=5)
            self._thread = None

    def check_once(self, now: Optional[float] = None) -> int:
        """TTL expiry + segment compaction + watermark GC; returns
        partitions dropped."""
        now = time.time() if now is None else now
        self.ttl_dropped += self.store.expire_all(now)
        # bound per-partition segment counts (ClickHouse background
        # merges' role): each sweep merges small segments and deletes
        # the previous sweep's superseded sources
        for db, tname in self.store.tables():
            try:
                self.segments_compacted += \
                    self.store.table(db, tname).compact()
            except (KeyError, OSError):
                # table dropped (runtime datasource del) or its
                # directory removed mid-compaction — the sweep thread
                # must survive either, or TTL/watermark GC dies with it
                continue
        dropped = 0
        used = self.store.disk_bytes()
        if used <= self.max_bytes:
            return dropped
        # oldest partitions first, across all tables; decrement the running
        # total per drop instead of re-walking every segment each iteration
        candidates: List[Tuple[int, Tuple[str, str]]] = []
        for db, tname in self.store.tables():
            try:
                t = self.store.table(db, tname)
            except KeyError:
                continue   # dropped by runtime datasource del mid-sweep
            candidates.extend((p, (db, tname)) for p in t.partitions())
        candidates.sort()
        for part, (db, tname) in candidates:
            if used <= self.low_bytes:
                break
            try:
                t = self.store.table(db, tname)
            except KeyError:
                continue
            used -= t.partition_bytes(part)
            t.drop_partition(part)
            dropped += 1
        self.partitions_dropped += dropped
        return dropped

    def _run(self) -> None:
        sup = default_supervisor()
        while not self._stop.wait(self.interval):
            sup.beat()
            try:
                self.check_once()
            except Exception as e:
                # retention GC must survive any single sweep error
                # (corrupt segment, racing table drop, transient IO) —
                # a dead monitor thread silently fills the disk. The
                # repr makes a climbing counter diagnosable over the
                # debug socket.
                self.sweep_errors += 1
                self.last_sweep_error = repr(e)

    def counters(self) -> dict:
        return {"partitions_dropped": self.partitions_dropped,
                "ttl_dropped": self.ttl_dropped,
                "segments_compacted": self.segments_compacted,
                "sweep_errors": self.sweep_errors,
                "disk_bytes": self.store.disk_bytes()}
