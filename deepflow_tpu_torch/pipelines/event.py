"""event pipeline: eBPF perf events + alarm events (+ resource events API).

Reference: server/ingester/event/ — decoders for perf events (file IO from
eBPF, decoder.go:290), alarm events (:406), and controller-emitted resource
change events (:125, arriving over an internal queue rather than the wire).
All three land in the `event` database; resource events are accepted
through `put_resource_event` the way the reference's controller pushes
them in-process.

A copy of the JAX package's `pipelines/event.py` (host code; this
package imports none of it).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from deepflow_tpu_torch.runtime.queues import MultiQueue
from deepflow_tpu_torch.runtime.receiver import Receiver
from deepflow_tpu_torch.runtime.stats import StatsRegistry
from deepflow_tpu_torch.store.db import Store
from deepflow_tpu_torch.store.dict_store import TagDictRegistry
from deepflow_tpu_torch.store.table import AggKind, ColumnSpec, TableSchema
from deepflow_tpu_torch.store.writer import StoreWriter
from deepflow_tpu_torch.wire.codec import iter_pb_records
from deepflow_tpu_torch.wire.framing import MessageType
from deepflow_tpu_torch.wire.gen import telemetry_pb2

EVENT_DB = "event"

_U32 = np.dtype(np.uint32)

PERF_EVENT_TABLE = TableSchema(
    name="perf_event",
    columns=(
        ColumnSpec("timestamp", _U32, AggKind.KEY),
        ColumnSpec("pid", _U32, AggKind.KEY),
        ColumnSpec("thread_id", _U32, AggKind.KEY),
        ColumnSpec("pod_id", _U32, AggKind.KEY),
        ColumnSpec("event_type", _U32, AggKind.KEY),
        ColumnSpec("operation", _U32, AggKind.KEY),
        ColumnSpec("filename", _U32, AggKind.KEY),   # dict hash
        ColumnSpec("bytes_count", _U32, AggKind.SUM),
        ColumnSpec("duration_ns", _U32, AggKind.MAX),
    ),
)

ALARM_EVENT_TABLE = TableSchema(
    name="alarm_event",
    columns=(
        ColumnSpec("timestamp", _U32, AggKind.KEY),
        ColumnSpec("policy_id", _U32, AggKind.KEY),
        ColumnSpec("policy_name", _U32, AggKind.KEY),   # dict hash
        ColumnSpec("event_level", _U32, AggKind.KEY),
        ColumnSpec("alarm_target", _U32, AggKind.KEY),  # dict hash
        ColumnSpec("trigger_value", np.dtype(np.float32), AggKind.MAX),
    ),
)

RESOURCE_EVENT_TABLE = TableSchema(
    name="resource_event",
    columns=(
        ColumnSpec("timestamp", _U32, AggKind.KEY),
        ColumnSpec("resource_type", _U32, AggKind.KEY),
        ColumnSpec("resource_id", _U32, AggKind.KEY),
        ColumnSpec("event_type", _U32, AggKind.KEY),    # dict hash
        ColumnSpec("description", _U32, AggKind.KEY),   # dict hash
    ),
)


class EventPipeline:
    def __init__(self, receiver: Receiver, store: Optional[Store],
                 tag_dicts: TagDictRegistry,
                 queue_size: int = 8192,
                 stats: Optional[StatsRegistry] = None) -> None:
        self.strings = tag_dicts.get("event_strings")
        self.perf_writer = self.alarm_writer = self.resource_writer = None
        if store is not None:
            self.perf_writer = StoreWriter(
                store.create_table(EVENT_DB, PERF_EVENT_TABLE),
                batch_rows=16384, flush_interval=5.0, stats=stats)
            self.alarm_writer = StoreWriter(
                store.create_table(EVENT_DB, ALARM_EVENT_TABLE),
                batch_rows=1024, flush_interval=5.0, stats=stats)
            self.resource_writer = StoreWriter(
                store.create_table(EVENT_DB, RESOURCE_EVENT_TABLE),
                batch_rows=1024, flush_interval=5.0, stats=stats)
        self.queues = MultiQueue("ingest.event", 1, queue_size)
        receiver.register_handler(MessageType.PROC_EVENT, self.queues)
        receiver.register_handler(MessageType.ALARM_EVENT, self.queues)
        self._thread: Optional[threading.Thread] = None
        self._halt = threading.Event()
        self.events = 0
        self.decode_errors = 0
        if stats is not None:
            stats.register("event", self.counters)

    def start(self) -> None:
        for w in (self.perf_writer, self.alarm_writer, self.resource_writer):
            if w is not None:
                w.start()
        # supervised: crash capture, backoff restart and deadman beats
        # for the decode worker
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        self._thread = default_supervisor().spawn(
            "event", self._run)

    def close(self) -> None:
        self.queues.close()
        self._halt.set()
        if self._thread is not None:
            self._thread.stop()
            self._thread.join(timeout=2)
        for w in (self.perf_writer, self.alarm_writer, self.resource_writer):
            if w is not None:
                w.close()

    def flush(self) -> None:
        for w in (self.perf_writer, self.alarm_writer, self.resource_writer):
            if w is not None:
                w.flush()

    # -- resource events arrive from the controller in-process -------------
    def put_resource_event(self, resource_type: int, resource_id: int,
                           event_type: str, description: str,
                           ts: Optional[int] = None) -> None:
        self.events += 1
        if self.resource_writer is None:
            return
        self.resource_writer.put({
            "timestamp": np.asarray([ts or int(time.time())], np.uint32),
            "resource_type": np.asarray([resource_type], np.uint32),
            "resource_id": np.asarray([resource_id], np.uint32),
            "event_type": np.asarray(
                [self.strings.encode_one(event_type)], np.uint32),
            "description": np.asarray(
                [self.strings.encode_one(description)], np.uint32),
        })

    # -- wire decode -------------------------------------------------------
    def _run(self) -> None:
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        sup = default_supervisor()
        while not self._halt.is_set():
            sup.beat()
            frames = self.queues.gets(0, 64, timeout=0.2)
            if not frames:
                if self.queues.queues[0].closed:
                    return
                continue
            for f in frames:
                try:
                    if f.msg_type == MessageType.PROC_EVENT:
                        self._handle_proc(f.payload)
                    else:
                        self._handle_alarm(f.payload)
                except Exception:
                    self.decode_errors += 1

    def _handle_proc(self, payload: bytes) -> None:
        rows = {c.name: [] for c in PERF_EVENT_TABLE.columns}
        for raw in iter_pb_records(payload):
            ev = telemetry_pb2.ProcEvent()
            try:
                ev.ParseFromString(raw)
            except Exception:
                self.decode_errors += 1
                continue
            io = ev.io_event_data
            fname = io.filename.rstrip(b"\x00").decode("utf-8", "replace")
            rows["timestamp"].append(ev.start_time // 1_000_000_000)
            rows["pid"].append(ev.pid)
            rows["thread_id"].append(ev.thread_id)
            rows["pod_id"].append(ev.pod_id)
            rows["event_type"].append(int(ev.event_type))
            rows["operation"].append(int(io.operation))
            rows["filename"].append(self.strings.encode_one(fname))
            rows["bytes_count"].append(io.bytes_count)
            rows["duration_ns"].append(min(
                ev.end_time - ev.start_time
                if ev.end_time > ev.start_time else io.latency, 0xFFFFFFFF))
        n = len(rows["timestamp"])
        if n and self.perf_writer is not None:
            self.perf_writer.put({k: np.asarray(v, np.uint32)
                                  for k, v in rows.items()})
        self.events += n

    def _handle_alarm(self, payload: bytes) -> None:
        for raw in iter_pb_records(payload):
            ev = telemetry_pb2.AlarmEvent()
            try:
                ev.ParseFromString(raw)
            except Exception:
                self.decode_errors += 1
                continue
            self.events += 1
            if self.alarm_writer is None:
                continue
            self.alarm_writer.put({
                "timestamp": np.asarray([ev.timestamp], np.uint32),
                "policy_id": np.asarray([ev.policy_id], np.uint32),
                "policy_name": np.asarray(
                    [self.strings.encode_one(ev.policy_name)], np.uint32),
                "event_level": np.asarray([ev.event_level], np.uint32),
                "alarm_target": np.asarray(
                    [self.strings.encode_one(ev.alarm_target)], np.uint32),
                "trigger_value": np.asarray([ev.trigger_value], np.float32),
            })

    def counters(self) -> dict:
        return {"events": self.events, "decode_errors": self.decode_errors}
