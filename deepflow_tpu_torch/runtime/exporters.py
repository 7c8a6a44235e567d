"""The exporter contract, the registry that fans chunks out, and the
queue-worker base.

An exporter takes decoded columnar chunks from the ingester's decode
stage: `start`, `close`, `is_export_data(stream, cols)` (a cheap filter
before enqueue) and `put(stream, decoder_index, cols)`, which must not
block. `Exporters` is the registry the decoders call: each registered
exporter sits behind its own `CircuitBreaker`. `QueueWorkerExporter`
buffers chunks in its own drop-oldest `OverwriteQueue` (the loss
counted) and drains them on supervised worker threads into the
subclass's `process(chunks)`.

With `stats=` the exporter's counters register with a `StatsRegistry` as
`exporter.<name>`. Each drained batch's `process` call is the
always-on tracer stage `export` under the exporter's name, and
`counters()` carries the totals of every stage recorded under that name
(runtime/tracing.py). With the process tracer on, a chunk carries the
enqueuing thread's batch id across the queue, and the worker pins it.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Protocol, Sequence

import numpy as np

from deepflow_tpu_torch.runtime.breaker import BreakerConfig, CircuitBreaker
from deepflow_tpu_torch.runtime.faults import (FAULT_EXPORTER_PROCESS,
                                               FAULT_EXPORTER_RAISE,
                                               default_faults)
from deepflow_tpu_torch.runtime.queues import OverwriteQueue
from deepflow_tpu_torch.runtime.stats import StatsRegistry
from deepflow_tpu_torch.runtime.supervisor import default_supervisor
from deepflow_tpu_torch.runtime.tracing import default_tracer



class Exporter(Protocol):
    """The plugin contract (reference: exporters.go:35-48)."""

    def start(self) -> None: ...

    def close(self) -> None: ...

    def is_export_data(self, stream: str, cols: Dict[str, Any]) -> bool:
        """Cheap filter before enqueue (reference: IsExportData signal-source
        bit filter, otlp_exporter/exporter.go:120)."""
        ...

    def put(self, stream: str, decoder_index: int,
            cols: Dict[str, Any]) -> None:
        """Hand one decoded columnar chunk to the exporter. Must not
        block. Batch causality rides the process tracer's thread-local
        batch id (tracing.Tracer.set_batch), not the signature."""
        ...

class Exporters:
    """Registry and fan-out; one instance sits after the decode stage.

    `put` runs on the decoder thread. The filter runs first, outside the
    breaker's accounting (a raising filter is counted loss, not a
    breaker outcome). A raise out of `put`, or a put slower than the
    latency budget, is recorded against that exporter alone; an open
    breaker sheds its puts, counted (`shed`), while siblings and decode
    keep flowing. `breaker_cfg=None` runs unwrapped (errors still
    contained, never quarantined)."""

    def __init__(self, stats: Optional[StatsRegistry] = None,
                 breaker_cfg: Optional[BreakerConfig] = BreakerConfig()
                 ) -> None:
        self._exporters: List[Any] = []
        self._breakers: List[Optional[CircuitBreaker]] = []
        self._breaker_cfg = breaker_cfg
        self._stats = stats
        self._faults = default_faults()
        self._started = False
        self.put_count = 0
        self.filtered_count = 0
        self.put_errors = 0        # exporter raised out of put/filter
        self.shed_count = 0        # puts dropped by an open breaker
        if stats is not None:
            stats.register("exporters", self.counters)

    def register(self, exporter) -> None:
        if self._started:
            raise RuntimeError("register before start()")
        self._exporters.append(exporter)
        breaker = None
        if self._breaker_cfg is not None:
            name = getattr(exporter, "name",
                           f"exporter{len(self._exporters) - 1}")
            breaker = CircuitBreaker(name, self._breaker_cfg)
            if self._stats is not None:
                self._stats.register(f"breaker.{name}", breaker.counters)
        self._breakers.append(breaker)

    def start(self) -> None:
        self._started = True
        for e in self._exporters:
            e.start()

    def close(self) -> None:
        for e in self._exporters:
            e.close()
        self._started = False

    def put(self, stream: str, decoder_index: int,
            cols: Dict[str, Any]) -> None:
        faults = self._faults
        for e, breaker in zip(self._exporters, self._breakers):
            try:
                if not e.is_export_data(stream, cols):
                    self.filtered_count += 1
                    continue
            except Exception:
                self.put_errors += 1
                continue
            if breaker is not None and not breaker.allow():
                self.shed_count += 1   # the breaker counts its own `dropped`
                continue
            t0 = time.perf_counter()
            try:
                if faults.enabled:
                    faults.maybe_raise(FAULT_EXPORTER_RAISE,
                                       key=getattr(e, "name", ""))
                e.put(stream, decoder_index, cols)
                self.put_count += 1
            except Exception:
                # counted loss, never an exception into the decode stage
                self.put_errors += 1
                if breaker is not None:
                    breaker.record_failure()
            else:
                if breaker is not None:
                    breaker.record_success(time.perf_counter() - t0)

    def pending(self) -> int:
        """Chunks parked in exporter queues (`.queue`) plus what a device
        feed holds past them (`pending_extra`): the drain ladder waits
        on this before closing."""
        total = 0
        for e in self._exporters:
            q = getattr(e, "queue", None)
            if q is not None:
                total += len(q)
            extra = getattr(e, "pending_extra", None)
            if extra is not None:
                try:
                    total += int(extra())
                except Exception:
                    pass
        return total

    def breakers(self) -> Dict[str, dict]:
        """Per-exporter breaker states."""
        return {b.name: b.counters()
                for b in self._breakers if b is not None}

    def counters(self) -> dict:
        return {"put": self.put_count, "filtered": self.filtered_count,
                "put_errors": self.put_errors, "shed": self.shed_count,
                "n_exporters": len(self._exporters)}


class QueueWorkerExporter:
    """Base for exporters that buffer chunks and drain on worker
    threads; subclasses implement `process(chunks)`, each chunk a
    (stream, decoder_index, cols, batch_id) tuple."""

    def __init__(self, name: str, streams: Sequence[str],
                 queue_size: int = 1 << 16, n_workers: int = 1,
                 batch: int = 64,
                 stats: Optional[StatsRegistry] = None) -> None:
        self.name = name
        self.streams = frozenset(streams)
        self.queue = OverwriteQueue(f"exporter.{name}", queue_size)
        self.n_workers = n_workers
        self.batch = batch
        self._handles: List = []       # supervisor ThreadHandles
        self.processed = 0
        self.process_errors = 0        # process() raised; batch dropped
        self._tracer = default_tracer()
        self.queue.trace_dwell(self._tracer, f"queue.exporter.{name}")
        if stats is not None:
            stats.register(f"exporter.{name}", self.counters)

    # -- the exporter contract ----------------------------------------------
    def start(self) -> None:
        sup = default_supervisor()
        for i in range(self.n_workers):
            self._handles.append(sup.spawn(f"{self.name}-{i}", self._run))

    def close(self) -> None:
        self.queue.close()
        for h in self._handles:
            h.stop()
            h.join(timeout=5)
        self._handles.clear()

    def is_export_data(self, stream: str, cols: Dict[str, Any]) -> bool:
        return stream in self.streams

    def put(self, stream: str, decoder_index: int,
            cols: Dict[str, Any]) -> None:
        # the enqueuing thread's batch id crosses the queue in the item
        # (-1 with the tracer off: one tuple shape always)
        self.queue.put((stream, decoder_index, cols,
                        self._tracer.current_batch()
                        if self._tracer.enabled else -1))

    # -- subclass surface -----------------------------------------------------
    def process(self, chunks: List[Any]) -> None:  # pragma: no cover
        raise NotImplementedError

    @staticmethod
    def coerce_to_schema(cols: Dict[str, Any], schema) -> Dict[str, Any]:
        """Project a decoded chunk onto a batching Schema: contiguous
        casts for present columns, zeros for absent ones."""
        n = len(next(iter(cols.values()))) if cols else 0
        return {
            name: np.ascontiguousarray(cols[name]).astype(dt, copy=False)
            if name in cols else np.zeros(n, dt)
            for name, dt in schema.columns
        }

    def _run(self) -> None:
        tracer = self._tracer
        sup = default_supervisor()
        faults = default_faults()
        while True:
            sup.beat()
            chunks = self.queue.gets(self.batch, timeout=0.2)
            if chunks:
                # a raising process() must not kill the worker: the
                # batch is counted loss and the drain goes on; errors
                # escaping this loop crash into the supervisor
                try:
                    if faults.enabled:
                        faults.maybe_raise(FAULT_EXPORTER_PROCESS,
                                           key=self.name)
                    if tracer.enabled:
                        tracer.set_batch(chunks[0][3])
                    t0 = time.perf_counter()
                    self.process(chunks)
                    tracer.stage("export", t0, time.perf_counter(),
                                 sum(len(next(iter(c[2].values())))
                                     if c[2] else 0 for c in chunks),
                                 self.name)
                except Exception:
                    self.process_errors += 1
                else:
                    self.processed += len(chunks)
            elif self.queue.closed:
                return

    def counters(self) -> dict:
        c = self.queue.counters()
        c["processed"] = self.processed
        c["process_errors"] = self.process_errors
        c.update(self._tracer.stage_counters(self.name))
        return c
