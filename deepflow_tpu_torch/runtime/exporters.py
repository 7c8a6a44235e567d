"""The exporter contract and its queue-worker base.

An exporter takes decoded columnar chunks from the ingester's decode
stage: `start`, `close`, `is_export_data(stream, cols)` (a cheap filter
before enqueue) and `put(stream, decoder_index, cols)`, which must not
block. `QueueWorkerExporter` buffers chunks in its own drop-oldest
`OverwriteQueue` (the loss counted) and drains them on supervised worker
threads into the subclass's `process(chunks)`. The registry that hosts
exporters, and the circuit breaker around each, belong to the host
(the JAX package's `Exporters` takes this class as it is).

With `stats=` the exporter's counters register with a `StatsRegistry` as
`exporter.<name>`. With the process tracer on, a chunk carries the
enqueuing thread's batch id across the queue, and the worker pins it
and records each drained batch as an `export` span.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from deepflow_tpu_torch.runtime.faults import (FAULT_EXPORTER_PROCESS,
                                               default_faults)
from deepflow_tpu_torch.runtime.queues import OverwriteQueue
from deepflow_tpu_torch.runtime.stats import StatsRegistry
from deepflow_tpu_torch.runtime.supervisor import default_supervisor
from deepflow_tpu_torch.runtime.tracing import default_tracer


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
                        rows = sum(len(next(iter(c[2].values())))
                                   if c[2] else 0 for c in chunks)
                        tracer.set_batch(chunks[0][3])
                        with tracer.span("export", stream=self.name,
                                         batch_id=chunks[0][3], rows=rows):
                            self.process(chunks)
                    else:
                        self.process(chunks)
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
        return c
