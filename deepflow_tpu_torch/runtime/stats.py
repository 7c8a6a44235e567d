"""Countable self-telemetry registry.

Every stage registers a counter source; `collect` scrapes them (on
demand, or on a supervised background cadence) into samples kept in a
bounded history and handed to sinks. A Countable is any zero-argument
callable returning {name: number}, so stages register their `counters`
method as it is.

`StatsShipper` ships the samples back into an ingester as DFSTATS
records through `agent/sender.UniformSender`: the framework monitors
itself with its own pipeline, landing in the deepflow_system DB
(reference: server/libs/stats/stats.go:91-92).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

__all__ = ["StatSample", "StatsRegistry", "StatsShipper",
           "default_registry"]

Countable = Callable[[], Dict[str, float]]


@dataclass
class StatSample:
    ts: float
    module: str
    tags: Dict[str, str]
    values: Dict[str, float]


@dataclass
class _Source:
    module: str
    countable: Countable
    tags: Dict[str, str] = field(default_factory=dict)


class StatsRegistry:
    """Register Countables; scrape on demand or on a background cadence."""

    def __init__(self, history: int = 1024) -> None:
        self._sources: List[_Source] = []
        self._lock = threading.Lock()
        self._history: List[StatSample] = []
        self._history_cap = history
        self._handle = None            # supervisor ThreadHandle
        self._stop = threading.Event()
        self._sinks: List[Callable[[StatSample], None]] = []

    def register(self, module: str, countable: Countable,
                 tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._sources.append(_Source(module, countable, dict(tags or {})))

    def deregister(self, module: str) -> None:
        with self._lock:
            self._sources = [s for s in self._sources if s.module != module]

    def add_sink(self, sink: Callable[[StatSample], None]) -> None:
        self._sinks.append(sink)

    def remove_sink(self, sink: Callable[[StatSample], None]) -> None:
        self._sinks = [s for s in self._sinks if s is not sink]

    def _scrape(self) -> List[StatSample]:
        now = time.time()
        with self._lock:
            sources = list(self._sources)
        samples = []
        for s in sources:
            try:
                values = s.countable()
            except Exception:  # a broken source must not stop the scrape
                continue
            samples.append(StatSample(now, s.module, s.tags, dict(values)))
        return samples

    def collect(self) -> List[StatSample]:
        """Scrape every source once into the history and the sinks."""
        samples = self._scrape()
        with self._lock:
            self._history.extend(samples)
            if len(self._history) > self._history_cap:
                del self._history[:len(self._history) - self._history_cap]
        for sample in samples:
            for sink in self._sinks:
                sink(sample)
        return samples

    def peek(self) -> List[StatSample]:
        """Scrape every source once, leaving the history and the sinks
        alone (for a reader with a cadence of its own)."""
        return self._scrape()

    def history(self, module: Optional[str] = None) -> List[StatSample]:
        with self._lock:
            return [s for s in self._history
                    if module is None or s.module == module]

    def start(self, interval_s: float = 10.0) -> None:
        if self._handle is not None:
            return
        self._stop.clear()
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        sup = default_supervisor()

        def loop() -> None:
            while not self._stop.wait(interval_s):
                sup.beat()
                self.collect()

        # supervised: a raising collect() restarts with backoff
        self._handle = sup.spawn("stats-collector", loop,
                                 beat_period_s=interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._handle is not None:
            self._handle.stop()
            self._handle.join(timeout=5)
            self._handle = None


_default: Optional[StatsRegistry] = None
_default_lock = threading.Lock()


class StatsShipper:
    """Ships the registry's samples onto the firehose as DFSTATS records
    — the framework monitors itself with its own pipeline, landing in
    the deepflow_system DB (reference: server/libs/stats/stats.go:91-92
    REMOTE_TYPE_DFSTATSD -> ext_metrics/decoder.go:130)."""

    def __init__(self, registry: StatsRegistry, ingester_addr: str,
                 vtap_id: int = 0) -> None:
        from deepflow_tpu_torch.agent.sender import UniformSender
        from deepflow_tpu_torch.wire.framing import MessageType

        self.registry = registry
        self.sender = UniformSender(MessageType.DFSTATS, ingester_addr,
                                    vtap_id=vtap_id)
        registry.add_sink(self._on_sample)
        self._batch: List = []
        self._lock = threading.Lock()
        self._closed = False

    def _on_sample(self, sample: StatSample) -> None:
        from deepflow_tpu_torch.wire.gen import stats_pb2

        if self._closed:
            return
        # Countables may carry descriptive strings ("mode": "local")
        # alongside numbers: strings ride as tags (what the pb's tag
        # fields are for), numerics as float metrics
        metrics = {}
        tags = dict(sample.tags)
        for k, v in sample.values.items():
            if isinstance(v, (int, float)):   # incl. bool -> 0.0/1.0
                metrics[k] = float(v)
            else:
                tags[k] = str(v)
        st = stats_pb2.Stats(
            timestamp=int(sample.ts), name=sample.module,
            tag_names=list(tags.keys()),
            tag_values=[str(v) for v in tags.values()],
            metrics_float_names=list(metrics.keys()),
            metrics_float_values=list(metrics.values()))
        # swap-under-lock (throttler discipline, deepflow-lint
        # emit-under-lock): detach the full batch while holding _lock,
        # send after release — the wire send can block on a reconnect,
        # and holding _lock across it would stall every sink caller.
        # sender.send is internally serialized, so two detached batches
        # racing here interleave at frame granularity, never corrupt.
        batch = None
        with self._lock:
            self._batch.append(st.SerializeToString())
            if len(self._batch) >= 64:
                batch, self._batch = self._batch, []
        if batch:
            # send() packs, size-splits, and accounts per record
            self.sender.send(batch)

    def flush(self) -> None:
        with self._lock:
            batch, self._batch = self._batch, []
        if batch:
            self.sender.send(batch)

    def close(self) -> None:
        self._closed = True
        self.registry.remove_sink(self._on_sample)
        self.flush()
        self.sender.close()


_default: Optional[StatsRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> StatsRegistry:
    global _default
    with _default_lock:
        if _default is None:
            _default = StatsRegistry()
        return _default
