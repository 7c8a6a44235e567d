"""Self-telemetry timeline: a bounded in-process TSDB over the runtime.

A supervised sampler thread (deadman beats) snapshots every registered
Countable and every gauge surface (the tracer's gauges, the occupancy
profiler's) at `sample_s` cadence into fixed-size per-series rings
(float64 value + wall stamp). The sampler is the only writer: appends
are unsynchronized reserve-and-store under the interpreter lock (the
tracer ring's discipline); readers snapshot under a lock. Past
`hot_samples` the oldest sample either graduates into a coarse tier
(every `coarse_every`-th evicted sample: `coarse_every` times the
lookback at 1/`coarse_every` the resolution) or is dropped counted
(`samples_overwritten`).

Series names are the /metrics names without the `deepflow_` prefix: a
Countable registered as module `exporter.tpu_sketch` with key `rows_in`
is the series `tpu_sketch_rows_in` (the `exporter.` prefix dropped);
tracer and profiler gauges keep their names
(`tpu_device_busy_fraction`).

**Rules** run on the sampler tick: recording rules write derived series
back into the timeline; SLO rules compute the multi-window burn rate
(fast 5 min, slow 1 h) against declared objectives and feed the
`slo_burn_rate` gauge family and `Ingester.health()`.

**Gauge staleness**: a tracer gauge is refreshed only by its own code
path, so one whose wall stamp is older than `stale_after_s` (10x the
sample cadence) is skipped counted (`stale_skipped`) instead of
extending its series, and promexpo reports the count as
`deepflow_selfmetric_stale`.

The timeline is also the querier's PromQL and SQL datasource
(`prom_fetch` for any metric it carries, `SELECT * FROM timeline`), and
`register_datasource` lists it in `store/rollup.py`'s registry.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Timeline", "SeriesRing", "RecordingRule", "SloRule",
           "TIMELINE_TABLE", "SLO_FAST_WINDOW_S", "SLO_SLOW_WINDOW_S"]

TIMELINE_TABLE = "timeline"
TIMELINE_SQL_COLUMNS = ["time", "metric", "labels", "value", "tier"]

# multi-window burn-rate windows (the classic fast-page / slow-ticket
# pair): fast catches a budget-torching outage in minutes, slow
# confirms it is not a blip
SLO_FAST_WINDOW_S = 300.0
SLO_SLOW_WINDOW_S = 3600.0

class SeriesRing:
    """One series' fixed-size hot ring + coarse downsampled tier.

    Single-writer (the sampler thread): append() is unsynchronized
    reserve-and-store under the GIL. Readers copy through
    :meth:`samples` under the owning Timeline's lock.
    """

    __slots__ = ("name", "labels", "cap", "ts", "vs", "n",
                 "coarse_every", "ccap", "cts", "cvs", "cn",
                 "overwritten", "coarse_overwritten")

    def __init__(self, name: str, labels: Dict[str, str], cap: int,
                 coarse_every: int) -> None:
        self.name = name
        self.labels = dict(labels)
        self.cap = max(2, int(cap))
        self.ts = np.zeros(self.cap, np.float64)
        self.vs = np.zeros(self.cap, np.float64)
        self.n = 0                       # total samples appended (ever)
        self.coarse_every = max(0, int(coarse_every))
        # the coarse tier reuses the hot capacity: same memory bound,
        # coarse_every-times the lookback
        self.ccap = self.cap if self.coarse_every else 0
        self.cts = np.zeros(self.ccap, np.float64)
        self.cvs = np.zeros(self.ccap, np.float64)
        self.cn = 0
        self.overwritten = 0             # hot samples dropped, not kept
        self.coarse_overwritten = 0      # coarse samples overwritten

    def append(self, ts: float, value: float) -> None:
        i = self.n
        if i >= self.cap:
            # the slot being reused holds the OLDEST hot sample: every
            # coarse_every-th one graduates to the coarse tier, the
            # rest are dropped counted — never silently
            evicted = i - self.cap
            slot = evicted % self.cap
            if self.coarse_every and evicted % self.coarse_every == 0:
                j = self.cn
                if j >= self.ccap:
                    self.coarse_overwritten += 1
                self.cts[j % self.ccap] = self.ts[slot]
                self.cvs[j % self.ccap] = self.vs[slot]
                self.cn = j + 1
            else:
                self.overwritten += 1
        self.ts[i % self.cap] = ts
        self.vs[i % self.cap] = value
        self.n = i + 1

    def _tier(self, ts: np.ndarray, vs: np.ndarray, n: int,
              cap: int) -> Tuple[np.ndarray, np.ndarray]:
        if n == 0:
            return (np.empty(0, np.float64), np.empty(0, np.float64))
        if n <= cap:
            return ts[:n].copy(), vs[:n].copy()
        pivot = n % cap                  # oldest live slot
        return (np.concatenate([ts[pivot:], ts[:pivot]]),
                np.concatenate([vs[pivot:], vs[:pivot]]))

    def samples(self, lo: Optional[float] = None,
                hi: Optional[float] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
        """(ts, vs) oldest-first across coarse + hot tiers, clipped to
        [lo, hi). Coarse samples strictly older than the oldest hot
        sample by construction (they were evicted from it)."""
        hts, hvs = self._tier(self.ts, self.vs, self.n, self.cap)
        cts, cvs = self._tier(self.cts, self.cvs, self.cn, self.ccap)
        if len(cts) and len(hts):
            keep = cts < hts[0]
            cts, cvs = cts[keep], cvs[keep]
        ts = np.concatenate([cts, hts])
        vs = np.concatenate([cvs, hvs])
        if lo is not None or hi is not None:
            a = np.searchsorted(ts, -np.inf if lo is None else lo,
                                side="left")
            b = np.searchsorted(ts, np.inf if hi is None else hi,
                                side="left")
            ts, vs = ts[a:b], vs[a:b]
        return ts, vs

    @property
    def last(self) -> Tuple[float, float]:
        """(ts, value) of the newest sample; (0, nan) when empty."""
        if self.n == 0:
            return 0.0, float("nan")
        i = (self.n - 1) % self.cap
        return float(self.ts[i]), float(self.vs[i])


@dataclass
class RecordingRule:
    """Materialize a derived series back into the timeline on every
    sampler tick. `fn(timeline, now)` returns the value (NaN/None =
    skip this tick)."""

    name: str
    fn: Callable[["Timeline", float], Optional[float]]
    labels: Dict[str, str] = field(default_factory=dict)


@dataclass
class SloRule:
    """One declared objective, burn-rated over the fast/slow windows.

    kind="ratio": error fraction = sum of window-deltas of the `bad`
    counter series over the sum of window-deltas of the `total` series
    (e.g. ingest availability off the conservation-ledger loss
    counters). kind="threshold": error fraction = fraction of `series`
    samples in the window above `bound` (e.g. serving p99, detection
    latency). Burn rate = error fraction / (1 - objective); 1.0 means
    the budget burns exactly at its sustainable pace, 14.4 means a
    0.999 objective's monthly budget gone in two days.
    """

    name: str
    objective: float
    kind: str = "ratio"                  # "ratio" | "threshold"
    bad: Tuple[str, ...] = ()
    total: Tuple[str, ...] = ()
    series: str = ""
    bound: float = 0.0

    def error_frac(self, tl: "Timeline", now: float,
                   window_s: float) -> float:
        lo = now - window_s
        if self.kind == "threshold":
            seen = bad = 0
            for ring in tl._rings_of(self.series):
                # hi=None: samples() windows are [lo, hi), which would
                # exclude the sample taken at the trigger instant
                # itself; the ring never holds samples newer than now
                _ts, vs = ring.samples(lo, None)
                seen += len(vs)
                bad += int(np.count_nonzero(vs > self.bound))
            return bad / seen if seen else 0.0
        bad_d = sum(tl._window_delta(n, lo, now) for n in self.bad)
        tot_d = sum(tl._window_delta(n, lo, now) for n in self.total)
        if tot_d <= 0:
            # no traffic: an idle lane burns nothing, but counted loss
            # with zero accounted total is a full burn, not a free pass
            return 1.0 if bad_d > 0 else 0.0
        return min(1.0, bad_d / tot_d)

    def burn(self, tl: "Timeline", now: float, window_s: float) -> float:
        budget = max(1.0 - self.objective, 1e-9)
        return self.error_frac(tl, now, window_s) / budget


class Timeline:
    """The bounded in-process TSDB + rule engine + sampler thread."""

    def __init__(self, sample_s: float = 1.0, hot_samples: int = 600,
                 coarse_every: int = 10,
                 stats=None, tracer=None, profiler=None,
                 fast_burn_threshold: float = 14.4,
                 clock=time.time) -> None:
        self.sample_s = float(sample_s)
        self.hot_samples = int(hot_samples)
        self.coarse_every = int(coarse_every)
        self.stale_after_s = 10.0 * self.sample_s
        self.fast_burn_threshold = float(fast_burn_threshold)
        self.stats = stats
        self.tracer = tracer
        self.profiler = profiler
        self._clock = clock
        self._lock = threading.Lock()    # series map + reader snapshots
        self._series: Dict[Tuple[str, tuple], SeriesRing] = {}
        self._by_metric: Dict[str, List[SeriesRing]] = {}
        # sampler-private ring memo: (module, key) or gauge name ->
        # ring, skipping name sanitization + label-key rebuild per tick
        self._memo: Dict[object, SeriesRing] = {}
        self._rules: List[RecordingRule] = []
        self._slos: List[SloRule] = []
        self._tick_hooks: List[Callable[[float], None]] = []
        self._stale: Dict[str, float] = {}   # gauge -> age at last tick
        self.ticks = 0
        self.samples_taken = 0
        self.stale_skipped = 0
        self.rule_errors = 0
        self._stop = threading.Event()
        self._handle = None

    # -- naming ------------------------------------------------------------
    @staticmethod
    def series_name(module: str, key: str) -> str:
        """Countable (module, key) -> timeline series name: the
        /metrics name minus the deepflow_ prefix, with the exporter.
        module prefix dropped so the sketch lane reads as operators
        speak (tpu_sketch_rows_in, not exporter_tpu_sketch_rows_in)."""
        if module.startswith("exporter."):
            module = module[len("exporter."):]
        name = f"{module}_{key}"
        return "".join(c if (c.isalnum() or c in "_:") else "_"
                       for c in name)

    # -- recording (sampler thread is the only writer) ---------------------
    def _ring(self, name: str, labels: Dict[str, str]) -> SeriesRing:
        key = (name, tuple(sorted(labels.items())))
        ring = self._series.get(key)
        if ring is None:
            with self._lock:
                ring = self._series.get(key)
                if ring is None:
                    ring = SeriesRing(name, labels, self.hot_samples,
                                      self.coarse_every)
                    self._series[key] = ring
                    self._by_metric.setdefault(name, []).append(ring)
        return ring

    def record(self, name: str, value: float,
               labels: Optional[Dict[str, str]] = None,
               now: Optional[float] = None) -> None:
        ring = self._ring(name, labels or {})
        ring.append(self._clock() if now is None else now, float(value))
        self.samples_taken += 1

    def sample_once(self, now: Optional[float] = None) -> None:
        """One sampler tick: Countables + gauge surfaces + recording
        rules + SLO burn rates, then the registered tick hooks (the
        incident watcher rides here)."""
        now = self._clock() if now is None else now
        # ring lookups are memoized on (module, key): the name
        # sanitization + label-key build would otherwise dominate the
        # tick (~7us/sample vs ~1us for the append itself). Sampler is
        # the only writer, so the memo needs no lock; a deregistered
        # module's stale memo entry is harmless (its ring just stops
        # growing).
        memo = self._memo
        if self.stats is not None:
            for s in self.stats.peek():
                module = s.module
                for k, v in s.values.items():
                    if isinstance(v, bool) or not isinstance(
                            v, (int, float)):
                        continue
                    mk = (module, k)
                    ring = memo.get(mk)
                    if ring is None:
                        ring = self._ring(self.series_name(module, k),
                                          s.tags)
                        memo[mk] = ring
                    ring.append(now, float(v))
                    self.samples_taken += 1
        if self.tracer is not None:
            stale: Dict[str, float] = {}
            for name, (value, stamp) in sorted(
                    self.tracer.gauges_stamped().items()):
                age = now - stamp
                if age > self.stale_after_s:
                    # a fossil gauge extends no series — skipped, counted
                    self.stale_skipped += 1
                    stale[name] = age
                    continue
                ring = memo.get(name)
                if ring is None:
                    ring = memo[name] = self._ring(name, {})
                ring.append(now, float(value))
                self.samples_taken += 1
            self._stale = stale
        if self.profiler is not None:
            # freshly computed per tick — never stale by construction
            for name, value in sorted(self.profiler.gauges().items()):
                ring = memo.get(name)
                if ring is None:
                    ring = memo[name] = self._ring(name, {})
                ring.append(now, float(value))
                self.samples_taken += 1
        for rule in list(self._rules):
            try:
                v = rule.fn(self, now)
            except Exception:
                self.rule_errors += 1
                continue
            if v is not None and not (isinstance(v, float)
                                      and v != v):
                self.record(rule.name, float(v), labels=rule.labels,
                            now=now)
        for slo in list(self._slos):
            for win, win_s in (("fast", SLO_FAST_WINDOW_S),
                               ("slow", SLO_SLOW_WINDOW_S)):
                try:
                    b = slo.burn(self, now, win_s)
                except Exception:
                    self.rule_errors += 1
                    continue
                self.record("slo_burn_rate", b,
                            labels={"slo": slo.name, "window": win},
                            now=now)
        self.ticks += 1
        for hook in list(self._tick_hooks):
            try:
                hook(now)
            except Exception:
                self.rule_errors += 1

    # -- rules -------------------------------------------------------------
    def add_rule(self, rule: RecordingRule) -> None:
        self._rules.append(rule)

    def add_slo(self, slo: SloRule) -> None:
        self._slos.append(slo)

    def add_tick_hook(self, hook: Callable[[float], None]) -> None:
        self._tick_hooks.append(hook)

    def slo_gauges(self) -> List[Tuple[Dict[str, str], float]]:
        """Newest burn-rate per (slo, window) — the slo_burn_rate
        gauge family promexpo renders."""
        out: List[Tuple[Dict[str, str], float]] = []
        with self._lock:
            rings = list(self._by_metric.get("slo_burn_rate", []))
        for ring in rings:
            _ts, v = ring.last
            if v == v:                   # skip NaN (empty ring)
                out.append((dict(ring.labels), v))
        return out

    def fast_burning(self, now: Optional[float] = None) -> List[str]:
        """SLO names whose newest fast-window burn rate exceeds the
        fast-burn threshold (the page condition + incident trigger)."""
        out = []
        for labels, v in self.slo_gauges():
            if labels.get("window") == "fast" \
                    and v > self.fast_burn_threshold:
                out.append(labels.get("slo", ""))
        return sorted(out)

    def stale_gauges(self) -> Dict[str, float]:
        """Gauge name -> age observed at the last tick for gauges past
        the staleness horizon (promexpo's deepflow_selfmetric_stale)."""
        return dict(self._stale)

    # -- internal read helpers ---------------------------------------------
    def _rings_of(self, metric: str) -> List[SeriesRing]:
        with self._lock:
            return list(self._by_metric.get(metric, []))

    def _window_delta(self, metric: str, lo: float, hi: float) -> float:
        """Counter delta over [lo, hi] summed across the metric's
        series: newest sample at-or-before hi minus the sample
        at-or-before lo (0 when the window holds < 2 samples)."""
        total = 0.0
        for ring in self._rings_of(metric):
            ts, vs = ring.samples()
            if len(ts) < 2:
                continue
            a = int(np.searchsorted(ts, lo, side="right")) - 1
            b = int(np.searchsorted(ts, hi, side="right")) - 1
            if b <= 0 or b <= a:
                continue
            d = vs[b] - vs[max(a, 0)]
            if d > 0:                    # counter reset clamps at 0
                total += float(d)
        return total

    # -- querier datasources -------------------------------------------------
    def has_metric(self, metric: str) -> bool:
        with self._lock:
            return metric in self._by_metric

    def metric_names(self) -> List[str]:
        with self._lock:
            return sorted(self._by_metric)

    def prom_fetch(self, metric: str, matchers, lo: int, hi: int):
        """[(labels, sorted int64-second ts, float64 vs)]: the PromQL
        evaluator's `_fetch` contract, served from the rings instead of
        a store scan. Sub-second samples truncate onto the
        integer-second grid the evaluator runs on (duplicates are fine:
        searchsorted and the extrapolated-rate math tolerate them)."""
        out = []
        for ring in self._rings_of(metric):
            labels = {"__name__": metric, **ring.labels}
            if not self._match(labels, matchers):
                continue
            ts, vs = ring.samples(float(lo), float(hi))
            if not len(ts):
                continue
            out.append((labels, ts.astype(np.int64),
                        vs.astype(np.float64)))
        return out

    @staticmethod
    def _match(labels: Dict[str, str], matchers) -> bool:
        from deepflow_tpu_torch.querier.promql import PromEngine
        return PromEngine._match(labels, list(matchers or ()))

    # -- SQL datasource (querier/engine.py routes table == "timeline") -----
    def sql(self, stmt) -> "QueryResult":
        """`SELECT * FROM timeline`: one row per ring sample, WHERE time
        bounds applied, sorted by (time, metric, labels)."""
        from deepflow_tpu_torch.querier import sql as Q
        from deepflow_tpu_torch.querier.engine import QueryResult
        from deepflow_tpu_torch.serving.tables import SketchTables

        if len(stmt.items) != 1 \
                or not isinstance(stmt.items[0].expr, Q.Column) \
                or stmt.items[0].expr.name != "*":
            raise ValueError("the timeline datasource answers "
                             "SELECT * FROM timeline (one row per "
                             "sample; WHERE time bounds apply)")
        lo, hi = SketchTables._time_bounds(stmt.where)
        rows: List[list] = []
        with self._lock:
            rings = list(self._series.values())
        for ring in rings:
            lbl = ",".join(f"{k}={v}"
                           for k, v in sorted(ring.labels.items()))
            hts, _ = ring._tier(ring.ts, ring.vs, ring.n, ring.cap)
            hot_lo = float(hts[0]) if len(hts) else float("inf")
            ts, vs = ring.samples(lo, hi)
            for t, v in zip(ts.tolist(), vs.tolist()):
                rows.append([int(t), ring.name, lbl, float(v),
                             "hot" if t >= hot_lo else "coarse"])
        rows.sort(key=lambda r: (r[0], r[1], r[2]))
        off = getattr(stmt, "offset", 0)
        if off:
            rows = rows[off:]
        if stmt.limit is not None:
            rows = rows[:stmt.limit]
        return QueryResult(list(TIMELINE_SQL_COLUMNS), rows)

    # -- datasource registration (store/rollup.py) -------------------------
    def register_datasource(self) -> None:
        from deepflow_tpu_torch.store import rollup
        rollup.register_datasource(TIMELINE_TABLE, self.datasources)

    def unregister_datasource(self) -> None:
        from deepflow_tpu_torch.store import rollup
        rollup.unregister_datasource(TIMELINE_TABLE)

    def datasources(self) -> List[dict]:
        with self._lock:
            n_series = len(self._series)
        return [{"table": TIMELINE_TABLE, "kind": "timeline",
                 "series": n_series, "sample_s": self.sample_s,
                 "hot_samples": self.hot_samples,
                 "coarse_every": self.coarse_every,
                 "ticks": self.ticks}]

    # -- window export (the incident recorder reads this) -------------------
    def window(self, lo: float, hi: float) -> List[dict]:
        """JSON-friendly dump of every series' samples in [lo, hi)."""
        out = []
        with self._lock:
            rings = list(self._series.values())
        for ring in rings:
            ts, vs = ring.samples(lo, hi)
            if not len(ts):
                continue
            out.append({"metric": ring.name, "labels": dict(ring.labels),
                        "ts": [round(float(t), 3) for t in ts],
                        "values": [float(v) for v in vs]})
        return out

    # -- sampler lifecycle (stats.py collector discipline) -----------------
    def start(self, supervisor=None) -> None:
        if self._handle is not None:
            return
        self._stop.clear()
        if supervisor is None:
            from deepflow_tpu_torch.runtime.supervisor import default_supervisor
            supervisor = default_supervisor()
        sup = supervisor

        def _sampler_loop() -> None:
            while not self._stop.wait(self.sample_s):
                sup.beat()
                self.sample_once()

        # supervised: a raising tick restarts with backoff instead of
        # silently ending self-telemetry; the beat feeds the deadman
        self._handle = sup.spawn("timeline-sampler", _sampler_loop,
                                 beat_period_s=self.sample_s)

    def stop(self) -> None:
        self._stop.set()
        if self._handle is not None:
            self._handle.stop()
            self._handle.join(timeout=5)
            self._handle = None

    # -- observability ------------------------------------------------------
    def counters(self) -> dict:
        with self._lock:
            rings = list(self._series.values())
        return {
            "series": len(rings),
            "ticks": self.ticks,
            "samples": self.samples_taken,
            "samples_overwritten": sum(r.overwritten for r in rings),
            "coarse_overwritten": sum(r.coarse_overwritten
                                      for r in rings),
            "stale_skipped": self.stale_skipped,
            "stale_gauges": len(self._stale),
            "rule_errors": self.rule_errors,
            "rules": len(self._rules),
            "slos": len(self._slos),
        }
