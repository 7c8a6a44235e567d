"""The flight recorder: spans, per-stage latency sketches, gauges.

Where a batch's wall time goes. Hot-path stages (the exporter's kernel
h2d / dispatch / device split, the window flush, the sharded suites'
updates, flushes and collectives) record spans into

- a fixed-size ring of completed spans (the last N survive for post-hoc
  inspection), and
- per-stage host-side DDSketch histograms (geometric buckets, bounded
  relative error), so p50/p95/p99 per stage read back at any time
  without keeping raw samples.

Batch causality rides a monotonically increasing `batch_id`, pinned per
thread with `set_batch` and picked up by spans recorded with -1.

Cost discipline:

- DISABLED (default): `span()` returns one shared no-op context manager,
  so a disabled span allocates nothing; hot call sites also guard on
  `tracer.enabled` so not even an argument tuple is built.
- ENABLED: one perf_counter pair, one histogram add and one ring store
  per span. Spans are per batch or group, never per record.

The ring is written without a lock (`i = n; n = i + 1`, the interpreter
lock keeps it memory-safe): two racing writers may now and then overwrite
one slot, an acceptable loss for a diagnostic buffer that must never
serialize the hot path. Reads snapshot under a lock.

Gauge and stage names are the reference's, and so is their HELP text,
except the compile family's: here a program's first call loads the
kernel library it launches, there it compiled an XLA program.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = ["HostDDSketch", "Tracer", "default_tracer", "GAUGE_HELP",
           "gauge_help"]

# HELP text of the well-known gauges (the reference's names and text)
GAUGE_HELP: Dict[str, str] = {
    "tpu_h2d_mb_s": "sampled host->device transfer rate of the sketch "
                    "lane (blocking measurement every Nth batch)",
    "tpu_transfers_per_batch": "device_put calls per TensorBatch on the "
                               "sketch lane; the coalesced feed holds "
                               "this at <= 1",
    "tpu_h2d_coalesced_bytes": "bytes of the last sampled coalesced "
                               "staging transfer",
    "tpu_feed_overlap_efficiency": "fraction of feed-thread wall time "
                                   "spent waiting on the device fence "
                                   "(~1 = chip-bound, ~0 = host-bound)",
    "tpu_feed_inflight": "dispatched-but-unfenced updates in the "
                         "prefetch window",
    "mesh_h2d_mb_s": "sampled host->device transfer rate of the "
                     "sharded mesh lane (blocking measurement every "
                     "Nth put_batch)",
    "tpu_audit_cms_rel_error": "observed CMS point-estimate error on "
                               "audited heavy hitters, relative to the "
                               "window's row count (exact shadow)",
    "tpu_audit_cms_eps_headroom": "theoretical CMS epsilon (e/width) "
                                  "minus the observed error; negative "
                                  "= out of bound",
    "tpu_audit_hll_rel_error": "observed HLL cardinality error vs the "
                               "distinct-sampled exact shadow",
    "tpu_audit_hll_eps_headroom": "HLL error bound (sketch epsilon + "
                                  "shadow sampling noise) minus the "
                                  "observed error; negative = out of "
                                  "bound",
    "tpu_audit_entropy_abs_error": "max abs difference between device "
                                   "and exact-shadow normalized "
                                   "entropy across the 4 features",
    "tpu_audit_topk_recall": "fraction of the shadow's exact top "
                             "ceil(rate*K) sampled keys present in the "
                             "device top-K output",
    "tpu_audit_sampled_keys": "distinct flow keys in the exact shadow "
                              "at the last window close",
    "tpu_audit_degraded_window": "1 when the last audited window ran "
                                 "on the degraded host-fallback lane",
    "tpu_audit_detection_precision": "clean-window precision of the "
                                     "anomaly plane's entropy-DDoS "
                                     "verdict vs the exact shadow's "
                                     "twin scorer (advisory below "
                                     "full audit rate)",
    "tpu_audit_detection_recall": "clean-window recall of the anomaly "
                                  "plane's entropy-DDoS verdict vs "
                                  "the exact shadow's twin scorer",
    "anomaly_score": "max detector score at the last window close "
                     "(z units for entropy/PCA, z-normalized distance "
                     "for the matrix profile)",
    "anomaly_alerts_total": "cumulative alerts emitted across all "
                            "detectors since start",
    "anomaly_detect_latency_windows": "windows between the last "
                                      "alert's excursion onset and its "
                                      "first emission (> 0 only when "
                                      "unscored windows intervened)",
    "anomaly_active_flows": "active-flow working-set slots seen in the "
                            "last closed window (device-resident "
                            "table, LRU-by-window)",
    "querier_read_qps": "sketch point queries answered per second "
                        "over the last gauge window (snapshot-cache "
                        "reads; never a device sync)",
    "querier_read_p99_s": "p99 latency of sketch point queries in "
                          "seconds (host DDSketch over all reads)",
    "sketch_snapshot_staleness_s": "age of the newest published sketch "
                                   "snapshot at the last read; the "
                                   "staleness-bounded-read contract is "
                                   "staleness <= max_staleness_s "
                                   "whenever ingest is flushing windows",
    "pod_shards_active": "shards on the device lane after the last "
                         "merge epoch (out of pod_shards; lower = "
                         "degraded/lost fault domains)",
    "pod_merge_epoch_s": "wall seconds the last deadline-bounded epoch "
                         "merge took (marker post -> merged publish)",
    "pod_merge_missed": "cumulative shard contributions that missed "
                        "their epoch's merge deadline (each counted "
                        "row rides pod_rows_excluded until it merges "
                        "late)",
}

# dynamically named gauges get their HELP by prefix
GAUGE_HELP_PREFIXES: Dict[str, str] = {
    "tpu_compile_s_": "first-launch seconds of the named update "
                      "program (the kernel library's load on its first "
                      "call, attributed apart from steady-state kernel "
                      "quantiles)",
}


def gauge_help(name: str) -> str:
    """HELP text for a gauge: its exact entry, then its prefix family,
    else empty."""
    text = GAUGE_HELP.get(name)
    if text is not None:
        return text
    for prefix, ptext in GAUGE_HELP_PREFIXES.items():
        if name.startswith(prefix):
            return ptext
    return ""


class HostDDSketch:
    """Host-side DDSketch: values land in geometric buckets
    (gamma = (1+alpha)/(1-alpha)); any quantile reads back with relative
    error alpha; sketches merge by elementwise add. Sized for durations
    in seconds: alpha=0.01 over 1024 buckets spans 1 us to ~770 s."""

    __slots__ = ("alpha", "min_value", "buckets", "gamma", "_inv_log_gamma",
                 "counts", "zeros", "count", "sum", "max")

    def __init__(self, alpha: float = 0.01, min_value: float = 1e-6,
                 buckets: int = 1024) -> None:
        self.alpha = alpha
        self.min_value = min_value
        self.buckets = buckets
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._inv_log_gamma = 1.0 / math.log(self.gamma)
        self.counts = [0] * buckets
        self.zeros = 0          # values below min_value
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def add(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v > self.max:
            self.max = v
        if v < self.min_value:
            self.zeros += 1
            return
        i = int(math.ceil(math.log(v / self.min_value)
                          * self._inv_log_gamma))
        self.counts[min(max(i, 0), self.buckets - 1)] += 1

    def quantile(self, q: float) -> float:
        """The q-quantile's bucket midpoint; 0.0 when empty or below
        min_value."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        if target <= self.zeros:
            return 0.0
        acc = self.zeros
        idx = self.buckets - 1
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                idx = i
                break
        g = self.gamma
        return self.min_value * (2.0 * g ** idx) / (g + 1.0)

    def merge(self, other: "HostDDSketch") -> None:
        """Exact union; the bucket layouts must match."""
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.zeros += other.zeros
        self.count += other.count
        self.sum += other.sum
        if other.max > self.max:
            self.max = other.max

    def cumulative_buckets(self, stride: int = 32) -> List[tuple]:
        """[(upper bound, cumulative count)] at every stride-th gamma
        boundary (the +Inf bucket is `count`, the caller's to add)."""
        return self.snapshot(stride)[0]

    def snapshot(self, stride: int = 32) -> tuple:
        """(cumulative buckets, total, sum) from ONE copy of the bucket
        array, so the total always equals the last cumulative value
        while writers add without a lock."""
        counts = list(self.counts)
        acc = self.zeros
        sum_ = self.sum
        out = []
        g = self.gamma
        for i in range(0, self.buckets, stride):
            for j in range(i, min(i + stride, self.buckets)):
                acc += counts[j]
            out.append((self.min_value
                        * g ** min(i + stride - 1, self.buckets - 1), acc))
        return out, acc, sum_


class _NoopSpan:
    """The disabled tracer's span: one shared instance, nothing
    allocated per call."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "stage", "stream", "batch_id", "rows", "t0")

    def __init__(self, tracer: "Tracer", stage: str, stream: str,
                 batch_id: int, rows: int) -> None:
        self._tracer = tracer
        self.stage = stage
        self.stream = stream
        self.batch_id = batch_id
        self.rows = rows
        self.t0 = 0.0

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer.observe(self.stage, time.perf_counter() - self.t0,
                             stream=self.stream, batch_id=self.batch_id,
                             rows=self.rows, t0=self.t0)
        return False


class Tracer:
    """Span recorder, per-stage latency sketches and gauges; disabled
    by default. One tracer serves the process (`default_tracer`); spans
    of two exporters in one process tell apart by their stream label."""

    def __init__(self, ring: int = 4096, alpha: float = 0.01,
                 min_value_s: float = 1e-6, buckets: int = 1024) -> None:
        self.enabled = False
        self._ring: List[Optional[tuple]] = [None] * ring
        self._ring_cap = ring
        self._n = 0                     # spans recorded, ever
        self._alpha = alpha
        self._min_value_s = min_value_s
        self._buckets = buckets
        self._stages: Dict[str, HostDDSketch] = {}
        self._gauges: Dict[str, float] = {}
        self._gauge_stamps: Dict[str, float] = {}
        self._lock = threading.Lock()   # reads, stage and gauge creation
        self._batch_seq = 0
        self._tls = threading.local()
        # every recorded span is proof of life for the recording thread
        # (set by supervisor.default_supervisor)
        self.heartbeat: Optional[Callable[[], None]] = None

    # -- lifecycle -----------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._ring = [None] * self._ring_cap
            self._n = 0
            self._stages = {}
            self._gauges = {}
            self._gauge_stamps = {}

    # -- batch causality -----------------------------------------------------
    def next_batch(self) -> int:
        """A new batch id (monotonic; a rare duplicate under a race
        degrades causality, never correctness)."""
        b = self._batch_seq + 1
        self._batch_seq = b
        return b

    def set_batch(self, batch_id: int) -> None:
        """Pin the calling thread's current batch id (spans recorded
        with batch_id=-1 pick it up)."""
        self._tls.batch = batch_id

    def current_batch(self) -> int:
        return getattr(self._tls, "batch", -1)

    # -- recording -----------------------------------------------------------
    def span(self, stage: str, stream: str = "", batch_id: int = -1,
             rows: int = 0):
        """Context manager timing one stage; the shared no-op when
        disabled."""
        if not self.enabled:
            return _NOOP
        return _Span(self, stage, stream, batch_id, rows)

    def observe(self, stage: str, dur_s: float, stream: str = "",
                batch_id: int = -1, rows: int = 0,
                t0: Optional[float] = None) -> None:
        """Record one completed span (the form hot call sites use behind
        their own `enabled` guard)."""
        if not self.enabled:
            return
        if self.heartbeat is not None:
            self.heartbeat()
        if batch_id < 0:
            batch_id = self.current_batch()
        sk = self._stages.get(stage)
        if sk is None:
            with self._lock:
                sk = self._stages.setdefault(
                    stage, HostDDSketch(self._alpha, self._min_value_s,
                                        self._buckets))
        sk.add(dur_s)
        i = self._n
        self._n = i + 1
        self._ring[i % self._ring_cap] = (
            stage, stream, batch_id,
            time.time() if t0 is None else time.time() - dur_s,
            dur_s, rows)

    def gauge(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        # wall-stamped: a gauge refreshes only on its own code path, so
        # the stamp tells a live value from a fossil
        self._gauges[name] = float(value)
        self._gauge_stamps[name] = time.time()

    # -- readback ------------------------------------------------------------
    @property
    def spans_recorded(self) -> int:
        return self._n

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def gauges_stamped(self) -> Dict[str, tuple]:
        """name -> (value, wall stamp of its last write)."""
        with self._lock:
            return {k: (v, self._gauge_stamps.get(k, 0.0))
                    for k, v in self._gauges.items()}

    def stages(self) -> Dict[str, HostDDSketch]:
        """A copy of the stage map (the sketches themselves are live)."""
        with self._lock:
            return dict(self._stages)

    def latency(self) -> Dict[str, Dict[str, float]]:
        """{stage: {count, p50_ms, p95_ms, p99_ms, max_ms, mean_ms}}."""
        out = {}
        for stage, sk in sorted(self.stages().items()):
            if sk.count == 0:
                continue
            out[stage] = {
                "count": sk.count,
                "p50_ms": sk.quantile(0.50) * 1e3,
                "p95_ms": sk.quantile(0.95) * 1e3,
                "p99_ms": sk.quantile(0.99) * 1e3,
                "max_ms": sk.max * 1e3,
                "mean_ms": (sk.sum / sk.count) * 1e3,
            }
        return out

    def recent(self, n: int = 32, stage: Optional[str] = None,
               slow_ms: Optional[float] = None) -> List[dict]:
        """The newest completed spans, newest first; optionally of one
        stage, optionally only those slower than slow_ms."""
        with self._lock:
            total = self._n
            ring = list(self._ring)
        out: List[dict] = []
        for k in range(total - 1, max(total - self._ring_cap, 0) - 1, -1):
            s = ring[k % self._ring_cap]
            if s is None:
                continue
            if stage is not None and s[0] != stage:
                continue
            if slow_ms is not None and s[4] * 1e3 < slow_ms:
                continue
            out.append({"stage": s[0], "stream": s[1], "batch_id": s[2],
                        "ts": s[3], "dur_ms": s[4] * 1e3, "rows": s[5]})
            if len(out) >= n:
                break
        return out

    def counters(self) -> dict:
        """Totals for the stats registry."""
        c = {"spans": self._n, "batches": self._batch_seq,
             "enabled": 1.0 if self.enabled else 0.0}
        for stage, sk in self.stages().items():
            key = stage.replace(".", "_")
            c[f"{key}_count"] = sk.count
            c[f"{key}_sum_s"] = sk.sum
        return c


_default: Optional[Tracer] = None
_default_lock = threading.Lock()


def default_tracer() -> Tracer:
    """The process flight recorder, made on first use."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Tracer()
        return _default
