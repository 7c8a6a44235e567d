"""Legacy droplet streams: syslog text, statsd lines, raw pcap storage.

Reference: server/ingester/droplet/ — the community edition keeps syslog
(text files), statsd (metrics), and policy-driven pcap storage
(server/ingester/pcap/). These are thin host-side paths: none of them
feed device kernels, but the wire surface must exist for agent parity.

A copy of the JAX package's `pipelines/droplet.py` (host code; this
package imports none of it).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from deepflow_tpu_torch.pipelines.ext_metrics import SAMPLE_TABLE, EXT_METRICS_DB
from deepflow_tpu_torch.runtime.queues import MultiQueue
from deepflow_tpu_torch.runtime.receiver import Receiver
from deepflow_tpu_torch.runtime.stats import StatsRegistry
from deepflow_tpu_torch.store.db import Store
from deepflow_tpu_torch.store.dict_store import TagDictRegistry
from deepflow_tpu_torch.store.writer import StoreWriter
from deepflow_tpu_torch.wire.framing import Frame, MessageType


def parse_statsd_line(line: str):
    """'name:value|type[|#tag:v,...]' -> (name, value, tags) or None."""
    line = line.strip()
    if not line:
        return None
    try:
        name, rest = line.split(":", 1)
        parts = rest.split("|")
        value = float(parts[0])
        tags = {}
        for p in parts[2:]:
            if p.startswith("#"):
                for kv in p[1:].split(","):
                    k, _, v = kv.partition(":")
                    tags[k] = v
        return name, value, tags
    except (ValueError, IndexError):
        return None


class DropletPipeline:
    """SYSLOG -> per-vtap text logs; STATSD -> ext_samples; RAW_PCAP ->
    per-vtap capture files."""

    def __init__(self, receiver: Receiver, store: Optional[Store],
                 tag_dicts: TagDictRegistry, out_dir: Optional[str],
                 queue_size: int = 4096,
                 stats: Optional[StatsRegistry] = None) -> None:
        self.out_dir = out_dir
        self.metric_dict = tag_dicts.get("metric_name")
        self.label_dict = tag_dicts.get("label_set")
        self.writer = None
        if store is not None:
            self.writer = StoreWriter(
                store.create_table(EXT_METRICS_DB, SAMPLE_TABLE),
                batch_rows=16384, flush_interval=5.0)
        self.queues = MultiQueue("ingest.droplet", 1, queue_size)
        for mt in (MessageType.SYSLOG, MessageType.STATSD,
                   MessageType.RAW_PCAP):
            receiver.register_handler(mt, self.queues)
        self._thread: Optional[threading.Thread] = None
        self._halt = threading.Event()
        self._files: Dict[str, object] = {}
        self.syslog_lines = 0
        self.statsd_samples = 0
        self.pcap_bytes = 0
        if stats is not None:
            stats.register("droplet", self.counters)

    def start(self) -> None:
        if self.writer is not None:
            self.writer.start()
        # supervised: crash capture, backoff restart and deadman beats
        # for the decode worker
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        self._thread = default_supervisor().spawn(
            "droplet", self._run)

    def close(self) -> None:
        self.queues.close()
        self._halt.set()
        if self._thread is not None:
            self._thread.stop()
            self._thread.join(timeout=2)
        if self.writer is not None:
            self.writer.close()
        for f in self._files.values():
            f.close()
        self._files.clear()

    def flush(self) -> None:
        if self.writer is not None:
            self.writer.flush()

    def _run(self) -> None:
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        sup = default_supervisor()
        while not self._halt.is_set():
            sup.beat()
            frames: List[Frame] = self.queues.gets(0, 64, timeout=0.2)
            if not frames:
                if self.queues.queues[0].closed:
                    return
                continue
            for f in frames:
                vtap = f.flow_header.vtap_id if f.flow_header else 0
                if f.msg_type == MessageType.SYSLOG:
                    self._handle_syslog(vtap, f.payload)
                elif f.msg_type == MessageType.STATSD:
                    self._handle_statsd(f.payload)
                else:
                    self._handle_pcap(vtap, f.payload)

    def _file(self, name: str, mode: str):
        f = self._files.get(name)
        if f is None and self.out_dir is not None:
            os.makedirs(self.out_dir, exist_ok=True)
            f = self._files[name] = open(os.path.join(self.out_dir, name),
                                         mode)
        return f

    def _handle_syslog(self, vtap: int, payload: bytes) -> None:
        text = payload.decode("utf-8", "replace")
        self.syslog_lines += text.count("\n") or 1
        f = self._file(f"syslog-vtap{vtap}.log", "a")
        if f is not None:
            f.write(text if text.endswith("\n") else text + "\n")
            f.flush()

    def _handle_statsd(self, payload: bytes) -> None:
        ts_l, m_l, l_l, v_l = [], [], [], []
        for line in payload.decode("utf-8", "replace").splitlines():
            parsed = parse_statsd_line(line)
            if parsed is None:
                continue
            name, value, tags = parsed
            # statsd has no wire timestamp: stamp receive time (ts=0 would
            # land in partition p0 and be TTL-reaped immediately)
            ts_l.append(int(time.time()))
            m_l.append(self.metric_dict.encode_one(name))
            l_l.append(self.label_dict.encode_one(
                ",".join(f"{k}={v}" for k, v in sorted(tags.items()))))
            v_l.append(value)
        self.statsd_samples += len(ts_l)
        if ts_l and self.writer is not None:
            self.writer.put({
                "timestamp": np.asarray(ts_l, np.uint32),
                "metric": np.asarray(m_l, np.uint32),
                "labels": np.asarray(l_l, np.uint32),
                "value": np.asarray(v_l, np.float32),
            })

    def _handle_pcap(self, vtap: int, payload: bytes) -> None:
        self.pcap_bytes += len(payload)
        f = self._file(f"pcap-vtap{vtap}.bin", "ab")
        if f is not None:
            f.write(payload)
            f.flush()

    def counters(self) -> dict:
        return {"syslog_lines": self.syslog_lines,
                "statsd_samples": self.statsd_samples,
                "pcap_bytes": self.pcap_bytes}
