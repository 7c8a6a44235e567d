"""profile pipeline: continuous-profiling stacks -> in_process_profile.

Reference: server/ingester/profile/ (decoder_parser.go:35 implements the
pyroscope Putter; stackToInProcess :78 writes CH `in_process_profile`).
Here profiles arrive as firehose Profile records (wire/protos/
telemetry.proto); folded stacks are SmartEncoded through a TagDict, so
the table stays pure-integer columns and flame graphs reconstruct by
dictionary lookup at query time.

A copy of the JAX package's `pipelines/profile.py` (host code; this
package imports none of it).
"""

from __future__ import annotations

import threading
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

PROFILE_DB = "profile"

_U32 = np.dtype(np.uint32)

PROFILE_TABLE = TableSchema(
    name="in_process_profile",
    columns=(
        ColumnSpec("timestamp", _U32, AggKind.KEY),
        ColumnSpec("app_service", _U32, AggKind.KEY),   # dict hash
        ColumnSpec("event_type", _U32, AggKind.KEY),    # dict hash
        ColumnSpec("stack", _U32, AggKind.KEY),         # dict hash (folded)
        ColumnSpec("pid", _U32, AggKind.KEY),
        ColumnSpec("vtap_id", _U32, AggKind.KEY),
        ColumnSpec("pod_id", _U32, AggKind.KEY),
        ColumnSpec("value", _U32, AggKind.SUM),
    ),
)


class ProfilePipeline:
    def __init__(self, receiver: Receiver, store: Optional[Store],
                 tag_dicts: TagDictRegistry, queue_size: int = 8192,
                 stats: Optional[StatsRegistry] = None) -> None:
        self.stacks = tag_dicts.get("profile_stack")
        self.names = tag_dicts.get("profile_name")
        self.writer = None
        if store is not None:
            self.writer = StoreWriter(
                store.create_table(PROFILE_DB, PROFILE_TABLE),
                batch_rows=16384, flush_interval=5.0, stats=stats)
        self.queues = MultiQueue("ingest.profile", 1, queue_size)
        receiver.register_handler(MessageType.PROFILE, self.queues)
        self._thread: Optional[threading.Thread] = None
        self._halt = threading.Event()
        self.profiles = 0
        self.decode_errors = 0
        if stats is not None:
            stats.register("profile", self.counters)

    def start(self) -> None:
        if self.writer is not None:
            self.writer.start()
        # supervised: crash capture, backoff restart and deadman beats
        # for the decode worker
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        self._thread = default_supervisor().spawn(
            "profile", self._run)

    def close(self) -> None:
        self.queues.close()
        self._halt.set()
        if self._thread is not None:
            self._thread.stop()
            self._thread.join(timeout=2)
        if self.writer is not None:
            self.writer.close()

    def flush(self) -> None:
        if self.writer is not None:
            self.writer.flush()

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
                    self._handle(f.payload)
                except Exception:
                    self.decode_errors += 1

    def _handle(self, payload: bytes) -> None:
        rows = {c.name: [] for c in PROFILE_TABLE.columns}
        for raw in iter_pb_records(payload):
            p = telemetry_pb2.Profile()
            try:
                p.ParseFromString(raw)
            except Exception:
                self.decode_errors += 1
                continue
            rows["timestamp"].append(p.timestamp // 1_000_000_000)
            rows["app_service"].append(self.names.encode_one(p.app_service))
            rows["event_type"].append(self.names.encode_one(p.event_type))
            rows["stack"].append(self.stacks.encode_one(p.stack))
            rows["pid"].append(p.pid)
            rows["vtap_id"].append(p.vtap_id)
            rows["pod_id"].append(p.pod_id)
            rows["value"].append(min(p.value, 0xFFFFFFFF))
        n = len(rows["timestamp"])
        self.profiles += n
        if n and self.writer is not None:
            self.writer.put({k: np.asarray(v, np.uint32)
                             for k, v in rows.items()})

    def counters(self) -> dict:
        return {"profiles": self.profiles,
                "decode_errors": self.decode_errors}
