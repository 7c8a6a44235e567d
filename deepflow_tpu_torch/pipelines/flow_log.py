"""flow_log pipeline: TAGGEDFLOW/COLUMNAR_FLOW/PROTOCOLLOG frames ->
enriched columns -> exporters and the store.

Reference: server/ingester/flow_log/flow_log.go (per-type Loggers, N
decoder threads per queue) + decoder/decoder.go (Gets(1024) batches,
decode by type, PlatformInfoTable enrichment, throttling, CH write,
exporter fan-out :299). A decoder thread drains whole frames, decodes each
frame's record batch straight into schema columns, stamps KnowledgeGraph
tags with one vectorized join and row ids, hands the full (unthrottled)
chunk to the exporter registry, and offers it to the reservoir throttler
in front of the store writer.

Streams: `l4_flow_log` on TAGGEDFLOW (protobuf, the reference agent's
wire) and COLUMNAR_FLOW (planar, `wire/columnar_wire.py`, decoded per
frame), `l7_flow_log` on PROTOCOLLOG. The JAX package's OTel and
PACKETSEQUENCE loggers are not ported: this pipeline registers no handler
for those message types, so the receiver counts their frames as
`no_handler`.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from deepflow_tpu_torch.decode import columnar
from deepflow_tpu_torch.enrich.platform_data import PlatformDataManager
from deepflow_tpu_torch.pipelines.schemas import L4_TABLE, L7_TABLE
from deepflow_tpu_torch.runtime.exporters import Exporters
from deepflow_tpu_torch.runtime.queues import MultiQueue
from deepflow_tpu_torch.runtime.receiver import Receiver
from deepflow_tpu_torch.runtime.stats import StatsRegistry
from deepflow_tpu_torch.runtime.supervisor import default_supervisor
from deepflow_tpu_torch.runtime.throttler import ColumnarThrottler
from deepflow_tpu_torch.runtime.tracing import default_tracer
from deepflow_tpu_torch.store.db import Store
from deepflow_tpu_torch.store.writer import StoreWriter
from deepflow_tpu_torch.wire import columnar_wire
from deepflow_tpu_torch.wire.codec import iter_pb_records
from deepflow_tpu_torch.wire.framing import Frame, MessageType

# row-id generator (reference: l4_flow_log.go genID :1040 --
# time<<32 | analyzer<<22 | counter, the counter a process-wide atomic)
_ID_LOCK = threading.Lock()
_ID_NEXT = [1]

FLOW_LOG_DB = "flow_log"


def stamp_row_ids(cols: Dict[str, np.ndarray],
                  analyzer_id: int = 0) -> Dict[str, np.ndarray]:
    """Fill the `_id` column in place: timestamp << 32 | analyzer << 22 |
    a 22-bit slice of the process-wide counter."""
    ids = cols.get("_id")
    n = 0 if ids is None else len(ids)
    if n == 0:
        return cols
    with _ID_LOCK:
        start = _ID_NEXT[0]
        _ID_NEXT[0] += n
    count = (np.arange(start, start + n, dtype=np.uint64)
             & np.uint64(0x3FFFFF))
    ts = cols["timestamp"].astype(np.uint64)
    cols["_id"] = (ts << np.uint64(32)) \
        | np.uint64((analyzer_id & 0x3FF) << 22) | count
    return cols


class _Decoder:
    """One decoder worker for one stream (reference: decoder.go Run),
    spawned through the process supervisor: an unexpected crash is
    captured and the worker restarts with backoff."""

    def __init__(self, stream: str, index: int, queues: MultiQueue,
                 decode_fn, enrich_fn,
                 throttler: Optional[ColumnarThrottler],
                 writer: Optional[StoreWriter],
                 exporters: Optional[Exporters],
                 batch: int = 64, payload_decode_fns=None) -> None:
        self.name = f"decode-{stream}-{index}"
        self.stream = stream
        self.index = index
        self.queues = queues
        self.decode_fn = decode_fn
        # per-message-type payload fast paths ({MessageType: payload ->
        # (cols, bad)}): the planar decode for COLUMNAR_FLOW; frames
        # without one pool into the record-list decode
        self.payload_decode_fns = payload_decode_fns or {}
        self.enrich_fn = enrich_fn
        self.throttler = throttler
        self.writer = writer
        self.exporters = exporters
        self.batch = batch
        self._halt = threading.Event()
        self.frames = 0
        self.records = 0
        self.decode_errors = 0
        self._tracer = default_tracer()

    def run(self) -> None:
        sup = default_supervisor()
        while not self._halt.is_set():
            sup.beat()
            frames: List[Frame] = self.queues.gets(self.index, self.batch,
                                                   timeout=0.2)
            if not frames:
                if self.queues.queues[self.index].closed:
                    return
                continue
            self.handle(frames)

    def handle(self, frames: List[Frame]) -> None:
        tracer = self._tracer
        if tracer.enabled:
            # the chunk anchors to its first frame's receiver-stamped
            # batch id (receiver -> decode -> export causality)
            bid = getattr(frames[0], "trace_batch_id", 0) or \
                tracer.next_batch()
            tracer.set_batch(bid)
            before = self.records
            with tracer.span("decode", stream=self.stream,
                             batch_id=bid) as sp:
                self._handle_inner(frames)
                sp.rows = self.records - before
        else:
            self._handle_inner(frames)

    def _handle_inner(self, frames: List[Frame]) -> None:
        self.frames += len(frames)
        # fast paths decode per frame, so a corrupt frame loses only its
        # own rows; the other frames pool into one record-list decode
        parts: List[Dict[str, np.ndarray]] = []
        records: List[bytes] = []
        for f in frames:
            fast = self.payload_decode_fns.get(f.msg_type)
            if fast is not None:
                try:
                    c, bad = fast(f.payload)
                    self.decode_errors += bad
                    if len(next(iter(c.values()))):
                        parts.append(c)
                    continue
                except Exception:
                    pass  # fall through to the record-list decode
            try:
                records.extend(iter_pb_records(f.payload))
            except ValueError:
                self.decode_errors += 1
        if records:
            try:
                c = self.decode_fn(records)
                self.decode_errors += len(records) - \
                    len(next(iter(c.values())))  # bad records skipped
                if len(next(iter(c.values()))):
                    parts.append(c)
            except Exception:
                self.decode_errors += 1
        if not parts:
            return
        cols = parts[0] if len(parts) == 1 else \
            {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        decoded = len(next(iter(cols.values()))) if cols else 0
        self.records += decoded
        if decoded == 0:
            return
        cols = self.enrich_fn(cols)
        # exporters see the full (unthrottled) stream, as the reference's
        # export() runs before the CH-write throttler
        if self.exporters is not None:
            self.exporters.put(self.stream, self.index, cols)
        if self.writer is not None:
            self.throttler.offer(cols)

    def stop(self) -> None:
        self._halt.set()
        if self.throttler is not None:
            self.throttler.flush()  # drain the open throttle bucket

    def counters(self) -> dict:
        return {"frames": self.frames, "records": self.records,
                "decode_errors": self.decode_errors}


class FlowLogPipeline:
    """The l4 and l7 loggers: their queues, decoder fleets and store
    writers."""

    def __init__(self, receiver: Receiver, store: Optional[Store],
                 platform: PlatformDataManager,
                 exporters: Optional[Exporters] = None,
                 n_decoders: int = 2, queue_size: int = 16384,
                 throttle_per_s: int = 50_000,
                 stats: Optional[StatsRegistry] = None,
                 tag_dicts=None, analyzer_id: int = 0) -> None:
        self.decoders: List[_Decoder] = []
        self.writers: List[StoreWriter] = []
        self._streams = []
        self._handles: List = []
        endpoint_dict = None if tag_dicts is None \
            else tag_dicts.get("l7_endpoint")

        def decode_l7(records):
            return columnar.decode_l7_records(records,
                                              endpoint_dict=endpoint_dict)

        def _with_ids(enrich):
            return lambda cols: stamp_row_ids(enrich(cols),
                                              analyzer_id=analyzer_id)

        for stream, msg_type, table_schema, decode_fn, enrich_fn in (
            ("l4_flow_log", MessageType.TAGGEDFLOW, L4_TABLE,
             columnar.decode_l4_records, _with_ids(platform.stamp_l4)),
            ("l7_flow_log", MessageType.PROTOCOLLOG, L7_TABLE,
             decode_l7, _with_ids(platform.stamp_l7)),
        ):
            queues = MultiQueue(f"ingest.{stream}", n_decoders, queue_size)
            queues.trace_dwell(default_tracer(), f"queue.ingest.{stream}")
            receiver.register_handler(msg_type, queues)
            writer = None
            if store is not None:
                table = store.create_table(FLOW_LOG_DB, table_schema)
                writer = StoreWriter(table, stats=stats)
                self.writers.append(writer)
            payload_fns = {}
            if stream == "l4_flow_log":
                # planar frames ride the same queues and decoders as
                # protobuf TAGGEDFLOW; the decode is picked per frame
                receiver.register_handler(MessageType.COLUMNAR_FLOW, queues)
                payload_fns[MessageType.COLUMNAR_FLOW] = \
                    columnar_wire.decode_columnar
            # the configured cap splits across every consumer of the
            # stream's writer (reference: flow_log.go throttle/queueCount).
            # The reference's l7 table has one more consumer, its OTel
            # decoder; its slice stays reserved, so each decoder's budget
            # (and its reservoir) is the JAX pipeline's
            n_consumers = n_decoders + (1 if stream == "l7_flow_log" else 0)
            for i in range(n_decoders):
                throttler = None
                if writer is not None:
                    throttler = ColumnarThrottler(
                        writer.put, max(1, throttle_per_s // n_consumers),
                        seed=i)
                d = _Decoder(stream, i, queues, decode_fn, enrich_fn,
                             throttler, writer, exporters,
                             payload_decode_fns=payload_fns)
                self.decoders.append(d)
                if stats is not None:
                    stats.register(f"decoder.{stream}.{i}", d.counters)
            self._streams.append((stream, queues))
        if stats is not None:
            # the process-wide string-hash LRU every decoder shares
            stats.register("decode.hash_cache",
                           columnar.hash_cache_counters)

    def start(self) -> None:
        for w in self.writers:
            w.start()
        sup = default_supervisor()
        self._handles = [sup.spawn(d.name, d.run) for d in self.decoders]

    def flush(self) -> None:
        """Drain the open throttle buckets and the writers' rows to disk."""
        for d in self.decoders:
            if d.throttler is not None:
                d.throttler.flush()
        for w in self.writers:
            w.flush()

    def tick(self) -> None:
        """Wall-clock throttle-bucket roll: a stream that goes quiet must
        not strand its last bucket in the reservoir until its next
        record."""
        for d in self.decoders:
            if d.throttler is not None:
                d.throttler.tick()

    def close(self) -> None:
        for _, queues in self._streams:
            queues.close()
        for d in self.decoders:
            d.stop()
        for h in self._handles:
            h.stop()
            h.join(timeout=2)
        self._handles = []
        for w in self.writers:
            w.close()
