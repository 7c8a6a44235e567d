"""flow_metrics pipeline: METRICS Documents -> vtap_flow_port rows and
their rollup tiers.

Reference: server/ingester/flow_metrics/flow_metrics.go (N unmarshallers
from MESSAGE_TYPE_METRICS) + unmarshaller/unmarshaller.go (DecodePB ->
app.Document, dbwriter). Two fronts feed the unmarshallers' queues: with
a `receiver`, METRICS frames (keyed by vtap_id), whose Documents the
unmarshaller decodes (`decode/columnar.decode_metric_records`); and
`put()`, which takes an already decoded METRIC_SCHEMA chunk. N
supervised unmarshaller workers count each chunk, hand it to the
exporters (when there are any) and to the table's StoreWriter; a
supervised ticker advances the RollupManager, whose GROUP BY reduces on
`device`.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from deepflow_tpu_torch.decode import columnar
from deepflow_tpu_torch.models.flow_suite import check_device
from deepflow_tpu_torch.pipelines.schemas import (
    METRICS_TABLE, register_standard_migrations)
from deepflow_tpu_torch.runtime.queues import MultiQueue
from deepflow_tpu_torch.runtime.stats import StatsRegistry
from deepflow_tpu_torch.runtime.supervisor import default_supervisor
from deepflow_tpu_torch.store.db import Store
from deepflow_tpu_torch.store.migrate import Issu
from deepflow_tpu_torch.store.rollup import RollupManager
from deepflow_tpu_torch.store.writer import StoreWriter
from deepflow_tpu_torch.wire.codec import iter_pb_records
from deepflow_tpu_torch.wire.framing import Frame, MessageType

FLOW_METRICS_DB = "flow_metrics"
STREAM = "flow_metrics"


def _chunk_rows(cols) -> int:
    """Rows a malformed chunk claims: its longest column."""
    try:
        return max((len(v) for v in cols.values()), default=0)
    except (AttributeError, TypeError):
        return 1


class FlowMetricsPipeline:
    """exporters: any object with `put(stream, decoder_index, cols)` (the
    host's exporter registry), or None. store None: no writer, no
    rollups (the exporters alone). receiver: a `Receiver` whose METRICS
    frames this pipeline decodes, or None (chunks through `put()`
    only)."""

    def __init__(self, store: Optional[Store], exporters=None,
                 n_unmarshallers: int = 2, queue_size: int = 16384,
                 rollup_intervals=(60,), rollup_period: float = 10.0,
                 device="cuda", receiver=None,
                 stats: Optional[StatsRegistry] = None) -> None:
        self.device = check_device(device)
        self.queues = MultiQueue("ingest.flow_metrics", n_unmarshallers,
                                 queue_size)
        if receiver is not None:
            receiver.register_handler(MessageType.METRICS, self.queues)
        self.exporters = exporters
        self.writer: Optional[StoreWriter] = None
        self.rollups: Optional[RollupManager] = None
        self.rollup_period = rollup_period
        if store is not None:
            # replay schema-evolution history first: a data root written
            # by an older build must gain new columns (tag_code, ...)
            # before the rollup manager snapshots the schema
            issu = Issu(store, FLOW_METRICS_DB)
            register_standard_migrations(issu)
            issu.run()
            self.rollups = RollupManager(store, FLOW_METRICS_DB,
                                         METRICS_TABLE,
                                         intervals=rollup_intervals,
                                         device=self.device)
            self.writer = StoreWriter(self.rollups.base, stats=stats)
        self._handles: List = []       # supervisor ThreadHandles
        self._stop = threading.Event()
        self._keys = itertools.count()
        self._count_lock = threading.Lock()
        self.n = n_unmarshallers
        self.records = 0
        self.decode_errors = 0
        if stats is not None:
            stats.register("flow_metrics", lambda: {
                "records": self.records,
                "decode_errors": self.decode_errors})

    def start(self) -> None:
        if self.writer is not None:
            self.writer.start()
        # supervised (crash capture, backoff restart, deadman beats from
        # each drain iteration): the unmarshaller fleet and the ticker
        sup = default_supervisor()
        for i in range(self.n):
            self._handles.append(
                sup.spawn(f"unmarshall-{i}",
                          functools.partial(self._run, i)))
        if self.rollups is not None:
            self._handles.append(sup.spawn(
                "rollup", self._rollup_loop,
                beat_period_s=self.rollup_period))

    def put(self, cols: Dict[str, np.ndarray],
            key: Optional[int] = None) -> None:
        """Queue one decoded METRIC_SCHEMA chunk; never blocks (a full
        queue overwrites its oldest chunk, counted). Chunks with one key
        go to one unmarshaller, in order (the receiver keys by vtap_id);
        None spreads chunks round robin. The chunk must not change
        after the call."""
        self.queues.put(next(self._keys) if key is None else key, cols)

    def close(self) -> None:
        """Drain the queues, then the writer, then build every rollup
        bucket that is complete by now + 120 s."""
        self.queues.close()
        self._stop.set()
        for h in self._handles:
            h.stop()
            h.join(timeout=30)
        self._handles.clear()
        if self.writer is not None:
            self.writer.close()  # flush pending rows first
        if self.rollups is not None:
            self.rollups.advance(time.time() + 120)  # final drain, no wait

    def _run(self, index: int) -> None:
        sup = default_supervisor()
        while True:
            sup.beat()
            items = self.queues.gets(index, 64, timeout=0.2)
            if not items:
                if self.queues.queues[index].closed:
                    return
                continue
            frames = [x for x in items if isinstance(x, Frame)]
            if frames:
                self._decode_frames(index, frames)
            for cols in items:
                if isinstance(cols, Frame):
                    continue
                try:
                    n = METRICS_TABLE.validate_chunk(cols)
                except (KeyError, ValueError, TypeError, AttributeError):
                    with self._count_lock:
                        self.decode_errors += _chunk_rows(cols)
                    continue
                self._deliver(index, cols, n)

    def _decode_frames(self, index: int, frames: List[Frame]) -> None:
        """One decode for a drained batch of METRICS frames, as the
        reference's unmarshaller does: a frame whose record framing is
        broken counts one error, a Document that fails to parse is
        skipped and counted."""
        records: List[bytes] = []
        bad = 0
        for f in frames:
            try:
                records.extend(iter_pb_records(f.payload))
            except ValueError:
                bad += 1
        cols = None
        if records:
            try:
                cols = columnar.decode_metric_records(records)
            except Exception:
                bad += 1
        n = 0 if cols is None else len(cols["timestamp"])
        if cols is not None:
            bad += len(records) - n
        if bad:
            with self._count_lock:
                self.decode_errors += bad
        if n:
            self._deliver(index, cols, n)

    def _deliver(self, index: int, cols: Dict[str, np.ndarray],
                 n: int) -> None:
        with self._count_lock:
            self.records += n
        if n == 0:
            return
        if self.exporters is not None:
            self.exporters.put(STREAM, index, cols)
        if self.writer is not None:
            self.writer.put(cols)

    def flush(self) -> None:
        if self.writer is not None:
            self.writer.flush()

    def _rollup_loop(self) -> None:
        sup = default_supervisor()
        while not self._stop.wait(self.rollup_period):
            sup.beat()
            self.rollups.advance(time.time())

    def counters(self) -> dict:
        with self._count_lock:
            return {"records": self.records,
                    "decode_errors": self.decode_errors,
                    "queue": self.queues.counters()}
