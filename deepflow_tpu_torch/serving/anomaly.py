"""Queryable anomaly tables: alert records over published snapshots.

The read side of the anomaly plane: an `AnomalyTables` subscribes
(through a `SnapshotCache`) to the plane's `SnapshotBus(name="anomaly")`
and answers

- SQL: `SELECT * FROM anomaly [WHERE time >= A AND time < B]`, one row
  per detector per window (score, threshold, alert flag, top
  contributing flow keys, lossy/degraded tags);
- PromQL: `anomaly_score{detector=...}`,
  `anomaly_alerts_total{detector=...}` and `anomaly_active_flows` as
  instant-vector selectors (label matchers compose with the whole
  evaluator: `max(anomaly_score) > 4` works),

entirely from host snapshot caches, never the device (the
serving/cache.py staleness contract). A copy of the JAX package's
`serving/anomaly.py`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from deepflow_tpu_torch.anomaly.detectors import DETECTORS
from deepflow_tpu_torch.runtime.snapbus import SketchSnapshot
from deepflow_tpu_torch.serving.cache import SnapshotCache

__all__ = ["AnomalyTables", "ANOMALY_TABLE", "ANOMALY_PROM_METRICS"]

ANOMALY_TABLE = "anomaly"
# PromQL instant-vector selectors the tables answer (promql.py routes
# these metric names here instead of the store's samples table)
ANOMALY_PROM_METRICS = ("anomaly_score", "anomaly_alerts_total",
                        "anomaly_active_flows")

ALERT_SQL_COLUMNS = ["time", "window", "detector", "score", "threshold",
                     "alert", "latency_windows", "top_keys",
                     "top_counts", "lossy", "degraded"]


class _AnomalyView:
    """Validated positional access to one anomaly snapshot's leaves
    (anomaly/alerts.py AlertSnapshot pins the order)."""

    def __init__(self, snap: SketchSnapshot) -> None:
        lv = snap.leaves
        if len(lv) != 8:
            raise ValueError(
                f"snapshot has {len(lv)} leaves, expected the 8-leaf "
                "AlertSnapshot layout — the anomaly wire shape changed "
                "under the serving view")
        self.snap = snap
        self.scores = np.asarray(lv[0], np.float32)
        self.thresholds = np.asarray(lv[1], np.float32)
        self.z = np.asarray(lv[2], np.float32)
        self.feats = np.asarray(lv[3], np.float32)
        self.active_flows = int(np.asarray(lv[4]))
        self.new_flows = int(np.asarray(lv[5]))
        self.rows = int(np.asarray(lv[6]))
        self.alerts_total = np.asarray(lv[7], np.int64)
        if (self.scores.shape != (len(DETECTORS),)
                or self.thresholds.shape != (len(DETECTORS),)
                or self.alerts_total.shape != (len(DETECTORS),)):
            raise ValueError("snapshot leaves do not look like an "
                             "AlertSnapshot — refusing to serve them")

    def alert_by_detector(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for a in self.snap.tags.get("alerts", []):
            out[a.get("detector", "")] = a
        return out


class AnomalyTables:
    """The ``anomaly`` datasource over one plane's snapshot cache."""

    def __init__(self, cache: SnapshotCache, tracer=None) -> None:
        from deepflow_tpu_torch.runtime.tracing import default_tracer

        self.cache = cache
        self._tracer = tracer if tracer is not None else default_tracer()
        self.reads = 0
        self.errors = 0
        self._views: Dict[int, _AnomalyView] = {}

    # -- datasource registration (store/rollup.py) -------------------------
    def register_datasource(self) -> None:
        from deepflow_tpu_torch.store import rollup
        rollup.register_datasource(ANOMALY_TABLE, self.datasources)

    def unregister_datasource(self) -> None:
        from deepflow_tpu_torch.store import rollup
        rollup.unregister_datasource(ANOMALY_TABLE)

    def datasources(self) -> List[dict]:
        c = self.cache.counters()
        return [{"table": ANOMALY_TABLE, "kind": "anomaly",
                 "detectors": list(DETECTORS),
                 "newest_window": c["newest_step"],
                 "cached_snapshots": c["cached"],
                 "staleness_s": c["staleness_s"],
                 "max_staleness_s": c["max_staleness_s"]}]

    # -- snapshot plumbing -------------------------------------------------
    def _view(self, snap: SketchSnapshot) -> _AnomalyView:
        v = self._views.get(snap.seq)
        if v is None:
            v = _AnomalyView(snap)
            if len(self._views) > 4 * self.cache.history:
                self._views.clear()
            self._views[snap.seq] = v
        return v

    def _views_of(self, snaps) -> List[_AnomalyView]:
        """Snapshots -> validated views; a malformed snapshot is
        skipped counted (one definition for the SQL and PromQL paths)."""
        views = []
        for s in snaps:
            try:
                views.append(self._view(s))
            except ValueError:
                self.errors += 1            # malformed snapshot skipped
        return views

    def _window_views(self, lo: Optional[float],
                      hi: Optional[float]) -> List[_AnomalyView]:
        if lo is None and hi is None:
            snap = self.cache.latest()
            snaps = [snap] if snap is not None else []
        else:
            self.cache.latest()             # staleness-bounded refresh
            snaps = self.cache.window_range(lo, hi)
        return self._views_of(snaps)

    # -- SQL (querier/engine.py routes table == "anomaly" here) ------------
    def sql(self, stmt) -> "QueryResult":
        from deepflow_tpu_torch.querier.engine import QueryResult
        from deepflow_tpu_torch.querier import sql as Q
        from deepflow_tpu_torch.serving.tables import SketchTables

        self.reads += 1
        try:
            lo, hi = SketchTables._time_bounds(stmt.where)
            views = self._window_views(lo, hi)
            if len(stmt.items) != 1 \
                    or not isinstance(stmt.items[0].expr, Q.Column) \
                    or stmt.items[0].expr.name != "*":
                raise ValueError(
                    "the anomaly datasource answers SELECT * FROM "
                    "anomaly (one row per detector per window)")
            rows = []
            for v in views:
                alerts = v.alert_by_detector()
                for i, det in enumerate(DETECTORS):
                    a = alerts.get(det)
                    rows.append([
                        int(v.snap.wall_time), v.snap.step, det,
                        round(float(v.scores[i]), 4),
                        float(v.thresholds[i]),
                        1 if a is not None else 0,
                        a.get("latency_windows", 0) if a else 0,
                        list(a.get("top_keys", [])) if a else [],
                        list(a.get("top_counts", [])) if a else [],
                        int(bool(v.snap.tags.get("lossy"))),
                        int(bool(v.snap.tags.get("degraded"))),
                    ])
            off = getattr(stmt, "offset", 0)
            if off:
                rows = rows[off:]
            if stmt.limit is not None:
                rows = rows[:stmt.limit]
            return QueryResult(list(ALERT_SQL_COLUMNS), rows)
        except Exception:
            self.errors += 1
            raise

    # -- PromQL (querier/promql.py routes the metric names here) -----------
    def prom_instant(self, metric: str, matchers,
                     grid: np.ndarray) -> List[Tuple[dict, np.ndarray]]:
        """Instant-vector series for one anomaly metric on the grid:
        each grid point answers from the newest snapshot at-or-before
        it (the serving/tables.py lookback convention); label matchers
        filter the per-detector series."""
        from deepflow_tpu_torch.serving.tables import LOOKBACK_S

        self.reads += 1
        try:
            self.cache.latest()             # staleness-bounded refresh
            views = self._views_of(self.cache.window_range(None, None))
            if not views:
                return []
            walls = np.asarray([v.snap.wall_time for v in views])
            g = np.asarray(grid, np.float64)
            idx = np.searchsorted(walls, g, side="right") - 1
            valid = idx >= 0
            age = np.where(valid, g - walls[np.maximum(idx, 0)], np.inf)
            valid &= age <= LOOKBACK_S

            def series(labels: dict, per_view) -> Tuple[dict, np.ndarray]:
                vals = np.full(len(g), np.nan)
                for j in range(len(g)):
                    if valid[j]:
                        vals[j] = per_view(views[int(idx[j])])
                return ({"__name__": metric, **labels}, vals)

            out: List[Tuple[dict, np.ndarray]] = []
            if metric == "anomaly_active_flows":
                out.append(series({}, lambda v: float(v.active_flows)))
            else:
                for i, det in enumerate(DETECTORS):
                    if metric == "anomaly_score":
                        out.append(series(
                            {"detector": det},
                            lambda v, i=i: float(v.scores[i])))
                    else:                   # anomaly_alerts_total
                        out.append(series(
                            {"detector": det},
                            lambda v, i=i: float(v.alerts_total[i])))
            return [(labels, vals) for labels, vals in out
                    if self._match(labels, matchers)
                    and not np.isnan(vals).all()]
        except Exception:
            self.errors += 1
            raise

    @staticmethod
    def _match(labels: dict, matchers) -> bool:
        from deepflow_tpu_torch.querier.promql import PromEngine
        return PromEngine._match(labels, list(matchers or ()))

    # -- observability -----------------------------------------------------
    def counters(self) -> dict:
        c = {"reads": self.reads, "errors": self.errors}
        c.update({f"cache_{k}": v
                  for k, v in self.cache.counters().items()})
        return c
