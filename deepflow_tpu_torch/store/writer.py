"""Batched asynchronous table writer.

Buffers columnar chunks for one table and writes them as one segment
append when the pending rows reach `batch_rows`, every `flush_interval`
seconds, and on `flush()`/`close()`: segment size tracks the configured
batch, not the arrival pattern. The flush loop is a supervised thread
(`runtime/supervisor.py`): a loop that crashes (a bad chunk, a disk
error) restarts with its pending chunks intact.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from deepflow_tpu_torch.runtime.stats import StatsRegistry
from deepflow_tpu_torch.runtime.supervisor import default_supervisor
from deepflow_tpu_torch.store.db import Table


class StoreWriter:
    """Buffers columnar chunks for one table; background flush thread."""

    def __init__(self, table: Table, batch_rows: int = 512_000,
                 flush_interval: float = 10.0,
                 stats: Optional[StatsRegistry] = None,
                 stats_name: Optional[str] = None) -> None:
        self.table = table
        self.batch_rows = batch_rows
        self.flush_interval = flush_interval
        self._pending: List[Dict[str, np.ndarray]] = []
        self._pending_rows = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._kick = threading.Event()  # threshold crossed: flush off-thread
        self._thread = None            # supervisor ThreadHandle
        self.flushes = 0
        if stats is not None:
            stats.register(stats_name or f"store.{table.schema.name}",
                           self.counters)

    def start(self) -> None:
        self._thread = default_supervisor().spawn(
            f"ckwriter-{self.table.schema.name}", self._run)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.stop()
            self._thread.join(timeout=5)
            self._thread = None
        self.flush()

    def put(self, cols: Dict[str, np.ndarray]) -> None:
        """Queue one columnar chunk; never blocks on IO. Crossing the
        batch threshold wakes the flush thread, or flushes inline when no
        flush thread runs (start() not called)."""
        n = self.table.schema.validate_chunk(cols)
        if n == 0:
            return
        with self._lock:
            self._pending.append(cols)
            self._pending_rows += n
            do_flush = self._pending_rows >= self.batch_rows
        if do_flush:
            if self._thread is not None:
                self._kick.set()
            else:
                self.flush()

    def flush(self) -> int:
        """Write every pending chunk as one append; returns its rows."""
        with self._lock:
            chunks, self._pending = self._pending, []
            self._pending_rows = 0
        if not chunks:
            return 0
        merged = {
            name: np.concatenate([np.asarray(c[name]) for c in chunks])
            for name in self.table.schema.column_names
        }
        rows = self.table.append(merged)
        self.flushes += 1
        return rows

    def _run(self) -> None:
        sup = default_supervisor()
        deadline = time.monotonic() + self.flush_interval
        while not self._stop.is_set():
            sup.beat()
            timeout = max(0.0, deadline - time.monotonic())
            if self._kick.wait(min(timeout, 0.5)):
                self._kick.clear()
                self.flush()
            elif time.monotonic() >= deadline:
                self.flush()
                deadline = time.monotonic() + self.flush_interval

    def counters(self) -> dict:
        with self._lock:
            pending = self._pending_rows
        c = self.table.counters()
        c.update({"flushes": self.flushes, "pending_rows": pending})
        return c
