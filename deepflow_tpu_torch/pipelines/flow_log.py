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
wire; decoded per frame by the C++ walker of `decode/native.py` when
`g++` built it, else by the Python decoder) and COLUMNAR_FLOW (planar, `wire/columnar_wire.py`, decoded per
frame), `l7_flow_log` on PROTOCOLLOG, `l7_flow_log.otel` on
OPENTELEMETRY and OPENTELEMETRY_COMPRESSED (OTLP spans into the l7
table; the stream name keeps exporters of `l7_flow_log` from re-reading
OTLP-sourced spans), and `l4_packet` on PACKETSEQUENCE (per-flow packet
batches: metadata rows in the `l4_packet` table, the batch bytes in
per-partition sidecar blob files beside it, pruned with their
partitions).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from deepflow_tpu_torch.agent.packet_sequence import decode_blocks
from deepflow_tpu_torch.decode import columnar, native
from deepflow_tpu_torch.enrich.platform_data import PlatformDataManager
from deepflow_tpu_torch.pipelines.schemas import (L4_PACKET_TABLE, L4_TABLE,
                                                  L7_TABLE)
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
                 batch: int = 64, payload_decode_fns=None,
                 frame_mode: bool = False) -> None:
        self.name = f"decode-{stream}-{index}"
        self.stream = stream
        self.index = index
        self.queues = queues
        self.decode_fn = decode_fn
        # per-message-type payload fast paths ({MessageType: payload ->
        # (cols, bad)}): the planar decode for COLUMNAR_FLOW; frames
        # without one pool into the record-list decode
        self.payload_decode_fns = payload_decode_fns or {}
        # frame_mode: decode_fn takes whole frames, not length-prefixed
        # record lists (one OTel frame is one ExportTraceServiceRequest)
        self.frame_mode = frame_mode
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
        if self.frame_mode:
            try:
                cols, bad = self.decode_fn(frames)
                self.decode_errors += bad
            except Exception:
                self.decode_errors += len(frames)
                return
        else:
            cols = self._decode_records(frames)
            if cols is None:
                return
        self._deliver(cols)

    def _decode_records(self, frames: List[Frame]):
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
            return None
        return parts[0] if len(parts) == 1 else \
            {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def _deliver(self, cols: Dict[str, np.ndarray]) -> None:
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
            if self.throttler is not None:
                self.throttler.offer(cols)
            else:
                # an unthrottled stream (diagnosis data) goes straight to
                # the writer
                self.writer.put(cols)

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
        self._pseq_table = None
        self._pseq_blob = None          # (partition start, open file)
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
                # protobuf frames take the C++ walker when g++ built it
                # (a failed build is logged once; the Python decoder
                # gives the same columns)
                if native.available():
                    payload_fns[MessageType.TAGGEDFLOW] = \
                        native.decode_l4_payload
            # the configured cap splits across every consumer of the
            # stream's writer (reference: flow_log.go throttle/queueCount);
            # the l7 table is also fed by the OTel decoder, so its budget
            # splits one way further
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
        self._build_otel(receiver, platform, exporters, endpoint_dict,
                         _with_ids, n_decoders, queue_size, throttle_per_s,
                         stats)
        self._build_pseq(receiver, store, exporters, queue_size, stats)

    def _build_otel(self, receiver, platform, exporters, endpoint_dict,
                    with_ids, n_decoders, queue_size, throttle_per_s,
                    stats) -> None:
        """OTel spans, raw and zlib-compressed frames, into l7_flow_log
        (reference: flow_log.go OTel and compressed Loggers :99-106)."""
        def decode_otel(frames: List[Frame]):
            # per frame, so each span batch carries its sender's vtap_id
            # from the flow header
            parts, bad = [], 0
            for f in frames:
                c, b = columnar.decode_otel_frames(
                    [f.payload],
                    compressed=(f.msg_type
                                == MessageType.OPENTELEMETRY_COMPRESSED),
                    vtap_id=(f.flow_header.vtap_id if f.flow_header
                             else 0),
                    endpoint_dict=endpoint_dict)
                bad += b
                if len(next(iter(c.values()))):
                    parts.append(c)
            if not parts:
                return columnar.decode_otel_frames([])[0], bad
            return ({k: np.concatenate([p[k] for p in parts])
                     for k in parts[0]}, bad)

        queues = MultiQueue("ingest.otel", 1, queue_size)
        receiver.register_handler(MessageType.OPENTELEMETRY, queues)
        receiver.register_handler(MessageType.OPENTELEMETRY_COMPRESSED,
                                  queues)
        l7_writer = next((w for w in self.writers
                          if w.table.schema.name == "l7_flow_log"), None)
        # the l7 write budget is shared with the PROTOCOLLOG decoders, so
        # every consumer gets an equal slice of the configured cap
        throttler = None
        if l7_writer is not None:
            throttler = ColumnarThrottler(
                l7_writer.put, max(1, throttle_per_s // (n_decoders + 1)),
                seed=n_decoders)
        # the stream name keeps exporters that match "l7_flow_log" (the
        # RED and OTLP exporters) off spans that arrived over OTLP; the
        # rows get the same KnowledgeGraph stamping as PROTOCOLLOG rows
        d = _Decoder("l7_flow_log.otel", 0, queues, decode_otel,
                     with_ids(platform.stamp_l7), throttler, l7_writer,
                     exporters, frame_mode=True)
        self.decoders.append(d)
        self._streams.append(("otel", queues))
        if stats is not None:
            stats.register("decoder.otel.0", d.counters)

    def _build_pseq(self, receiver, store, exporters, queue_size,
                    stats) -> None:
        """The l4_packet logger (PACKETSEQUENCE): per-packet TCP headers
        batched per flow (reference flow_log.go L4Packet logger :107,
        l4_packet.go DecodePacketSequence). Metadata rows land in the
        l4_packet table; the opaque batch bytes append to a sidecar blob
        addressed by (batch_off, batch_len)."""
        writer = None
        if store is not None:
            table = store.create_table(FLOW_LOG_DB, L4_PACKET_TABLE)
            writer = StoreWriter(table, stats=stats)
            self.writers.append(writer)
            os.makedirs(table.root, exist_ok=True)
            self._pseq_table = table

        def decode_pseq(frames: List[Frame]):
            rows, bad = [], 0
            for f in frames:
                r, b = decode_blocks(
                    f.payload,
                    vtap_id=(f.flow_header.vtap_id if f.flow_header
                             else 0))
                rows.extend(r)
                bad += b
            n = len(rows)
            cols = {
                "timestamp": np.fromiter(
                    (r["end_time_us"] // 1_000_000 for r in rows),
                    np.uint32, n),
                "start_time_us": np.fromiter(
                    (r["start_time_us"] for r in rows), np.uint64, n),
                "end_time_us": np.fromiter(
                    (r["end_time_us"] for r in rows), np.uint64, n),
                "flow_id": np.fromiter(
                    (r["flow_id"] for r in rows), np.uint64, n),
                "vtap_id": np.fromiter(
                    (r["vtap_id"] for r in rows), np.uint32, n),
                "packet_count": np.fromiter(
                    (r["packet_count"] for r in rows), np.uint32, n),
                "batch_off": np.zeros(n, np.uint64),
                "batch_len": np.fromiter(
                    (len(r["batch"]) for r in rows), np.uint32, n),
            }
            if self._pseq_table is not None and n:
                psec = self._pseq_table.schema.partition_seconds
                offs = []
                for i, r in enumerate(rows):
                    part = int(cols["timestamp"][i]) // psec * psec
                    fh = self._pseq_blob_for(part)
                    offs.append(fh.tell())
                    fh.write(r["batch"])
                self._pseq_blob[1].flush()
                cols["batch_off"] = np.asarray(offs, np.uint64)
            return cols, bad

        queues = MultiQueue("ingest.l4_packet", 1, queue_size)
        receiver.register_handler(MessageType.PACKETSEQUENCE, queues)
        # bare rows (no KnowledgeGraph); diagnosis data is never
        # throttled (the reference's L4Packet logger writes straight
        # through)
        d = _Decoder("l4_packet", 0, queues, decode_pseq, lambda cols: cols,
                     None, writer, exporters, frame_mode=True)
        self.decoders.append(d)
        self._streams.append(("l4_packet", queues))
        if stats is not None:
            stats.register("decoder.l4_packet.0", d.counters)

    def _pseq_blob_for(self, part: int):
        """The blob file of a table partition (batches-p<start>.bin), so
        expiring a partition's rows prunes its batch bytes too; the
        reader derives the file from the row's timestamp. One handle
        stays open (frames arrive in time order)."""
        if self._pseq_blob is not None and self._pseq_blob[0] == part:
            return self._pseq_blob[1]
        if self._pseq_blob is not None:
            self._pseq_blob[1].close()
        f = open(os.path.join(self._pseq_table.root,
                              f"batches-p{part}.bin"), "ab")
        self._pseq_blob = (part, f)
        return f

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
        self._prune_pseq_blobs()

    def tick(self) -> None:
        """Wall-clock throttle-bucket roll: a stream that goes quiet must
        not strand its last bucket in the reservoir until its next
        record."""
        for d in self.decoders:
            if d.throttler is not None:
                d.throttler.tick()

    def _prune_pseq_blobs(self) -> None:
        """Remove the blob files whose table partition has expired (TTL
        or GC dropped the rows). A blob younger than 120 s on the wall
        clock stays: its rows may still be on their way to the table
        (the decoder writes the bytes first), and partition stamps are
        data time, so a replayed old capture would otherwise lose
        them."""
        t = self._pseq_table
        if t is None:
            return
        live = set(t.partitions())
        cur = self._pseq_blob[0] if self._pseq_blob is not None else None
        mtime_horizon = time.time() - 120.0
        try:
            names = os.listdir(t.root)
        except OSError:
            return
        for name in names:
            if not (name.startswith("batches-p")
                    and name.endswith(".bin")):
                continue
            try:
                part = int(name[len("batches-p"):-len(".bin")])
            except ValueError:
                continue
            path = os.path.join(t.root, name)
            try:
                recent = os.path.getmtime(path) > mtime_horizon
            except OSError:
                continue
            if part not in live and part != cur and not recent:
                try:
                    os.remove(path)
                except OSError:
                    pass

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
        if self._pseq_blob is not None:
            self._pseq_blob[1].close()
            self._pseq_blob = None
