"""The exporter contract and its queue-worker base.

An exporter takes decoded columnar chunks from the ingester's decode
stage: `start`, `close`, `is_export_data(stream, cols)` (a cheap filter
before enqueue) and `put(stream, decoder_index, cols)`, which must not
block. `QueueWorkerExporter` buffers chunks in its own drop-oldest
`OverwriteQueue` (the loss counted) and drains them on supervised worker
threads into the subclass's `process(chunks)`. The registry that hosts
exporters, and the circuit breaker around each, belong to the host
(the JAX package's `Exporters` takes this class as it is).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from deepflow_tpu_torch.runtime.faults import (FAULT_EXPORTER_PROCESS,
                                               default_faults)
from deepflow_tpu_torch.runtime.queues import OverwriteQueue
from deepflow_tpu_torch.runtime.supervisor import default_supervisor


class QueueWorkerExporter:
    """Base for exporters that buffer chunks and drain on worker
    threads; subclasses implement `process(chunks)`, each chunk a
    (stream, decoder_index, cols, batch_id) tuple."""

    def __init__(self, name: str, streams: Sequence[str],
                 queue_size: int = 1 << 16, n_workers: int = 1,
                 batch: int = 64) -> None:
        self.name = name
        self.streams = frozenset(streams)
        self.queue = OverwriteQueue(f"exporter.{name}", queue_size)
        self.n_workers = n_workers
        self.batch = batch
        self._handles: List = []       # supervisor ThreadHandles
        self.processed = 0
        self.process_errors = 0        # process() raised; batch dropped

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
        # the batch id slot keeps the reference's chunk shape; this
        # package has no tracer, so it is always -1
        self.queue.put((stream, decoder_index, cols, -1))

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
