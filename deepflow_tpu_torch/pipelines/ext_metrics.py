"""ext_metrics pipeline: third-party + self telemetry ingest.

Reference: server/ingester/ext_metrics/ — one decoder fleet handling
Prometheus remote-write pb (MESSAGE_TYPE_PROMETHEUS), Telegraf influx
line protocol (TELEGRAF), and the framework's own Countable stats
(DFSTATS, stats.proto) — the system monitors itself through its own
pipeline (SURVEY.md §5). All three normalize into one columnar sample
shape: (timestamp, metric hash, label-set hash, value), with the string
halves of the hashes recorded in TagDicts for query-time display.

A copy of the JAX package's `pipelines/ext_metrics.py` (host code; this
package imports none of it).
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepflow_tpu_torch.runtime.queues import MultiQueue
from deepflow_tpu_torch.runtime.receiver import Receiver
from deepflow_tpu_torch.runtime.stats import StatsRegistry
from deepflow_tpu_torch.runtime.supervisor import default_supervisor
from deepflow_tpu_torch.store.db import Store
from deepflow_tpu_torch.store.dict_store import TagDictRegistry
from deepflow_tpu_torch.store.table import AggKind, ColumnSpec, TableSchema
from deepflow_tpu_torch.store.writer import StoreWriter
from deepflow_tpu_torch.wire.codec import iter_pb_records
from deepflow_tpu_torch.wire.framing import MessageType
from deepflow_tpu_torch.wire.gen import stats_pb2, telemetry_pb2

EXT_METRICS_DB = "ext_metrics"
SELF_DB = "deepflow_system"   # reference: deepflow_stats land separately

SAMPLE_TABLE = TableSchema(
    name="ext_samples",
    columns=(
        ColumnSpec("timestamp", np.dtype(np.uint32), AggKind.KEY),
        ColumnSpec("metric", np.dtype(np.uint32), AggKind.KEY),
        ColumnSpec("labels", np.dtype(np.uint32), AggKind.KEY),
        ColumnSpec("value", np.dtype(np.float32), AggKind.MAX),
    ),
    ttl_seconds=7 * 24 * 3600,
)


def parse_influx_line(line: str) -> Optional[Tuple[str, Dict[str, str],
                                                   Dict[str, float], int]]:
    """Parse one influx line: measurement[,tag=v...] field=v[,field=v] [ts].
    Returns (measurement, tags, fields, ts_ns) or None."""
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    try:
        head, rest = line.split(" ", 1)
        parts = head.split(",")
        measurement, tag_parts = parts[0], parts[1:]
        tags = {}
        for t in tag_parts:
            k, _, v = t.partition("=")
            tags[k] = v
        if " " in rest:
            field_str, ts_str = rest.rsplit(" ", 1)
            ts = int(ts_str)
        else:
            field_str, ts = rest, 0
        fields: Dict[str, float] = {}
        for fp in field_str.split(","):
            k, _, v = fp.partition("=")
            v = v.rstrip("i")
            if v in ("t", "T", "true", "True"):
                fields[k] = 1.0
            elif v in ("f", "F", "false", "False"):
                fields[k] = 0.0
            else:
                try:
                    fields[k] = float(v.strip('"'))
                except ValueError:
                    continue
        if not fields:
            return None
        return measurement, tags, fields, ts
    except ValueError:
        return None


class ExtMetricsPipeline:
    """PROMETHEUS + TELEGRAF + DFSTATS -> ext_samples tables."""

    def __init__(self, receiver: Receiver, store: Optional[Store],
                 tag_dicts: TagDictRegistry,
                 n_decoders: int = 1, queue_size: int = 8192,
                 stats: Optional[StatsRegistry] = None) -> None:
        self.tag_dicts = tag_dicts
        self.metric_dict = tag_dicts.get("metric_name")
        self.label_dict = tag_dicts.get("label_set")
        self.writers: Dict[str, Optional[StoreWriter]] = {}
        for db in (EXT_METRICS_DB, SELF_DB):
            w = None
            if store is not None:
                w = StoreWriter(store.create_table(db, SAMPLE_TABLE),
                                batch_rows=65536, flush_interval=5.0,
                                stats=stats,
                                stats_name=f"store.{db}.ext_samples")
            self.writers[db] = w
        self.queues = MultiQueue("ingest.ext_metrics", n_decoders, queue_size)
        for mt in (MessageType.PROMETHEUS, MessageType.TELEGRAF,
                   MessageType.DFSTATS):
            receiver.register_handler(mt, self.queues)
        self.n = n_decoders
        self._threads: List = []       # supervisor ThreadHandles
        self._halt = threading.Event()
        self.samples = 0
        self.decode_errors = 0
        if stats is not None:
            stats.register("ext_metrics", self.counters)

    # -- decode paths ------------------------------------------------------
    def _emit(self, db: str, ts: List[int], metric: List[int],
              labels: List[int], value: List[float]) -> None:
        if not ts:
            return
        w = self.writers[db]
        self.samples += len(ts)
        if w is not None:
            w.put({
                "timestamp": np.asarray(ts, np.uint32),
                "metric": np.asarray(metric, np.uint32),
                "labels": np.asarray(labels, np.uint32),
                "value": np.asarray(value, np.float32),
            })

    def _label_hash(self, pairs: List[Tuple[str, str]]) -> int:
        return self.label_dict.encode_one(
            ",".join(f"{k}={v}" for k, v in sorted(pairs)))

    def handle_prometheus(self, payload: bytes) -> None:
        # Wrapped form first (PrometheusMetric.metrics = WriteRequest);
        # a bare WriteRequest cross-parses as PrometheusMetric without
        # error (both use field 1 wiretype 2), so fall back on the inner
        # parse failing, not the outer.
        pm = telemetry_pb2.PrometheusMetric()
        wr = telemetry_pb2.WriteRequest()
        try:
            pm.ParseFromString(payload)
            wr.ParseFromString(pm.metrics)
        except Exception:
            pm = telemetry_pb2.PrometheusMetric()
            wr = telemetry_pb2.WriteRequest()
            try:
                wr.ParseFromString(payload)
            except Exception:
                # a direct remote-write sender ships snappy-compressed
                from deepflow_tpu_torch.utils import snappy
                wr.ParseFromString(snappy.decompress(payload))
        extra = list(zip(pm.extra_label_names, pm.extra_label_values))
        ts_l, m_l, l_l, v_l = [], [], [], []
        for series in wr.timeseries:
            name = ""
            pairs = list(extra)
            for lb in series.labels:
                if lb.name == "__name__":
                    name = lb.value
                else:
                    pairs.append((lb.name, lb.value))
            mh = self.metric_dict.encode_one(name)
            lh = self._label_hash(pairs)
            for s in series.samples:
                ts_l.append(int(s.timestamp) // 1000)
                m_l.append(mh)
                l_l.append(lh)
                v_l.append(s.value)
        self._emit(EXT_METRICS_DB, ts_l, m_l, l_l, v_l)

    def handle_telegraf(self, payload: bytes) -> None:
        ts_l, m_l, l_l, v_l = [], [], [], []
        for line in payload.decode("utf-8", "replace").splitlines():
            parsed = parse_influx_line(line)
            if parsed is None:
                continue
            measurement, tags, fields, ts_ns = parsed
            lh = self._label_hash(list(tags.items()))
            # timestamp-less lines get receive time (ts=0 would land in
            # partition p0 and be TTL-reaped immediately)
            tsec = ts_ns // 1_000_000_000 if ts_ns else int(time.time())
            for fname, fval in fields.items():
                ts_l.append(tsec)
                m_l.append(self.metric_dict.encode_one(
                    f"{measurement}.{fname}"))
                l_l.append(lh)
                v_l.append(fval)
        self._emit(EXT_METRICS_DB, ts_l, m_l, l_l, v_l)

    def handle_dfstats(self, payload: bytes) -> None:
        ts_l, m_l, l_l, v_l = [], [], [], []
        for raw in iter_pb_records(payload):
            st = stats_pb2.Stats()
            try:
                st.ParseFromString(raw)
            except Exception:
                self.decode_errors += 1
                continue
            lh = self._label_hash(list(zip(st.tag_names, st.tag_values)))
            for name, val in zip(st.metrics_float_names,
                                 st.metrics_float_values):
                ts_l.append(int(st.timestamp))
                m_l.append(self.metric_dict.encode_one(f"{st.name}.{name}"))
                l_l.append(lh)
                v_l.append(val)
        self._emit(SELF_DB, ts_l, m_l, l_l, v_l)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        for w in self.writers.values():
            if w is not None:
                w.start()
        # supervised (crash capture, backoff restart, deadman beats
        # from each drain iteration) — same discipline as flow_metrics
        sup = default_supervisor()
        for i in range(self.n):
            self._threads.append(
                sup.spawn(f"ext-metrics-{i}",
                          functools.partial(self._run, i)))

    def close(self) -> None:
        self.queues.close()
        self._halt.set()
        for t in self._threads:
            t.stop()
            t.join(timeout=2)
        for w in self.writers.values():
            if w is not None:
                w.close()

    def flush(self) -> None:
        for w in self.writers.values():
            if w is not None:
                w.flush()

    def _run(self, index: int) -> None:
        handlers = {
            MessageType.PROMETHEUS: self.handle_prometheus,
            MessageType.TELEGRAF: self.handle_telegraf,
            MessageType.DFSTATS: self.handle_dfstats,
        }
        sup = default_supervisor()
        while not self._halt.is_set():
            sup.beat()
            frames = self.queues.gets(index, 64, timeout=0.2)
            if not frames:
                if self.queues.queues[index].closed:
                    return
                continue
            for f in frames:
                try:
                    handlers[f.msg_type](f.payload)
                except Exception:
                    self.decode_errors += 1

    def counters(self) -> dict:
        return {"samples": self.samples, "decode_errors": self.decode_errors}
