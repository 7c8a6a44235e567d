"""Queryable sketch tables: point queries over published snapshots.

A `SketchTables` answers

- `cms_point(key)`   Count-Min point estimate of one flow key,
- `hll_card(group)`  per-service (or total) distinct-client count,
- `topk(k)`          the candidate ring's current top-k flows,
- `entropy()`        the 4 per-feature normalized entropies,

entirely from host numpy over `SnapshotCache` snapshots. Every estimator
here is the host twin of its device op: the CMS bucket hash mirrors
`ops/hashing.multi_bucket` through `_mix32_np`, the HLL readout is
Ertl's estimator in float32 like `ops/hll.estimate`, entropy is the same
normalized Shannon formula. A served answer for a snapshot therefore
equals what the device answers for that state.

The snapshots are the port's in-memory `SketchSnapshot`s, whose leaves
`convert.state_to_numpy` gives in the JAX package's FlowSuiteState order
and dtypes (uint32 ring keys with their sentinel, HLL registers and CMS
seeds), so `_SketchView`'s 9-leaf layout is the reference's.

Both query engines mount this as the `sketch` datasource:

    SELECT sketch.topk(10) FROM sketch WHERE time >= A AND time < B
    SELECT sketch.cms_point(3203386110) FROM sketch
    SELECT sketch.hll_card() FROM sketch
    SELECT sketch.entropy FROM sketch WHERE time >= A AND time < B

    sketch_topk(10)  sketch_cms_point(3203386110)
    sketch_hll_card()  sketch_entropy()          (PromQL)

Time bounds map to snapshot windows by publish wall time; a query with
no bounds is an instant read of the staleness-bounded latest snapshot.
Serving emits the `querier_read_qps`, `querier_read_p99_s` and
`sketch_snapshot_staleness_s` gauges through the port's tracer (the
`serving_p99` SLO rule reads `querier_read_p99_s`). Nothing here blocks
on the device: snapshots arrive as host arrays.

A copy of the JAX package's `serving/tables.py`.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepflow_tpu_torch.convert import SUITE_LEAVES
from deepflow_tpu_torch.runtime.snapbus import SketchSnapshot
from deepflow_tpu_torch.runtime.tracing import HostDDSketch, default_tracer
from deepflow_tpu_torch.serving.cache import SnapshotCache
from deepflow_tpu_torch.utils.twinmark import host_twin_of
from deepflow_tpu_torch.utils.u32 import _mix32_np

__all__ = ["SketchTables", "SKETCH_TABLE", "SKETCH_SQL_FUNCS",
           "SKETCH_PROM_FUNCS"]

_U32 = np.uint32
_MASK = 0xFFFFFFFF
_SENTINEL = 0xFFFFFFFF          # ops/topk.py empty-slot key

SKETCH_TABLE = "sketch"
# the SQL surface (qualified function names the parser hands through)
SKETCH_SQL_FUNCS = ("sketch.cms_point", "sketch.hll_card",
                    "sketch.topk", "sketch.entropy")
# the PromQL surface (leaf functions in querier/promql.py)
SKETCH_PROM_FUNCS = ("sketch_cms_point", "sketch_hll_card",
                     "sketch_topk", "sketch_entropy")

ENTROPY_COLS = ("entropy_ip_src", "entropy_ip_dst",
                "entropy_port_src", "entropy_port_dst")

# a snapshot older than this never answers an instant/grid point (the
# PromQL lookback convention; staleness inside the bound is reported,
# beyond it the answer would be fiction)
LOOKBACK_S = 300.0


@host_twin_of("deepflow_tpu_torch/utils/u32.py:mix32")
def _mix32_int(x: int) -> int:
    """Scalar host twin of utils/u32.mix32 (murmur3 fmix32) — plain int
    arithmetic, the cms_point fast path (no array allocation per query,
    which is what holds single-key reads at dashboard QPS)."""
    x &= _MASK
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _MASK
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _MASK
    x ^= x >> 16
    return x


@host_twin_of("deepflow_tpu_torch/utils/u32.py:fold_columns")
def fold_tuple(ip_src: int, ip_dst: int, port_src: int, port_dst: int,
               proto: int) -> int:
    """Scalar host twin of flow_suite.flow_key (fold_columns): the
    5-tuple -> u32 flow key, so a human query can name a flow instead
    of its hash."""
    h = 0x9E3779B9
    for c in (ip_src, ip_dst, port_src, port_dst, proto):
        h = _mix32_int(h ^ ((int(c) + 0x9E3779B9
                             + ((h << 6) & _MASK) + (h >> 2)) & _MASK))
    return h


class _SketchView:
    """Named, validated access to a FlowSuiteState snapshot's leaves.

    The leaves come in `convert.SUITE_LEAVES` order (what
    `convert.state_to_numpy` gives and both packages' npz files hold),
    pinned here positionally and checked by count, dtype and shape so a
    state-layout change fails crisply instead of serving garbage:
      0 cms counts [d, w]   1 cms seeds [d, 2]
      2 ring keys [r]       3 ring counts [r]
      4 hll registers [g, m]
      5 entropy hist [f, b] 6 entropy seeds [f, 2]
      7 rows_seen []        8 batches_seen []
    """

    def __init__(self, snap: SketchSnapshot) -> None:
        lv = snap.leaves
        if len(lv) != len(SUITE_LEAVES):
            raise ValueError(
                f"snapshot has {len(lv)} leaves, expected the 9-leaf "
                "FlowSuiteState layout — state shape changed under the "
                "serving view")
        bad = [name for a, (name, dt) in zip(lv, SUITE_LEAVES)
               if np.asarray(a).dtype != np.dtype(dt)]
        if bad:
            raise ValueError(f"snapshot leaves {bad} do not have the "
                             "FlowSuiteState dtypes (convert.SUITE_LEAVES)")
        self.snap = snap
        self.cms_counts = np.asarray(lv[0])
        self.cms_seeds = np.asarray(lv[1])
        self.ring_keys = np.asarray(lv[2])
        self.ring_counts = np.asarray(lv[3])
        self.hll_registers = np.asarray(lv[4])
        self.ent_hist = np.asarray(lv[5])
        self.rows = int(np.asarray(lv[7]))
        if (self.cms_counts.ndim != 2 or self.cms_seeds.shape
                != (self.cms_counts.shape[0], 2)
                or self.ring_keys.shape != self.ring_counts.shape
                or self.hll_registers.ndim != 2
                or self.ent_hist.ndim != 2):
            raise ValueError("snapshot leaves do not look like a "
                             "FlowSuiteState — refusing to serve it")
        w = self.cms_counts.shape[1]
        self._log2_width = int(w).bit_length() - 1
        # scalar seed pairs for the int fast path
        self._seed_pairs = [(int(m), int(s)) for m, s in self.cms_seeds]

    # -- estimators (host twins of the ops/ kernels) -----------------------
    def cms_point(self, key: int) -> int:
        """ops/cms.query host twin for ONE key: min over rows of the
        hashed buckets. Scalar arithmetic only (~µs per call)."""
        shift = 32 - self._log2_width
        best = None
        key = int(key) & _MASK
        for d, (mult, salt) in enumerate(self._seed_pairs):
            x = _mix32_int(key ^ salt)
            idx = ((mult * x) & _MASK) >> shift
            v = int(self.cms_counts[d, idx])
            best = v if best is None or v < best else best
        return int(best or 0)

    def cms_points(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized twin of ops/hashing.multi_bucket + cms.query."""
        keys = np.asarray(keys).astype(_U32, copy=False)
        mult = self.cms_seeds[:, 0].astype(_U32)[:, None]
        salt = self.cms_seeds[:, 1].astype(_U32)[:, None]
        with np.errstate(over="ignore"):
            x = _mix32_np(keys[None, :] ^ salt)
            idx = ((mult * x) >> _U32(32 - self._log2_width))
        est = np.take_along_axis(self.cms_counts,
                                 idx.astype(np.int64), axis=1)
        return est.min(axis=0)

    def hll_card(self, group: Optional[int] = None) -> float:
        """ops/hll.estimate host twin (Ertl improved estimator, float32
        like the device); group None = sum across all service groups
        (what flush_window's distinct_clients column reports)."""
        regs = self.hll_registers
        if group is not None:
            g = int(group)
            if not 0 <= g < regs.shape[0]:
                raise ValueError(
                    f"hll group {g} out of range [0, {regs.shape[0]})")
            regs = regs[g:g + 1]
        est = _hll_estimate_np(regs)
        return float(est.sum())

    def topk(self, k: int) -> List[Tuple[int, int]]:
        """ops/topk.result host twin: (key, count) pairs, count-desc,
        live slots only (sentinel keys / negative counts are empties)."""
        counts = self.ring_counts.astype(np.int64)
        keys = self.ring_keys.astype(np.uint32)
        # stable argsort on -counts == lax.top_k tie order (first index)
        order = np.argsort(-counts, kind="stable")[:max(0, int(k))]
        out = []
        for i in order:
            if int(keys[i]) == _SENTINEL or int(counts[i]) <= 0:
                continue
            out.append((int(keys[i]), int(counts[i])))
        return out

    def entropies(self) -> np.ndarray:
        """ops/entropy.entropies host twin: [features] normalized
        Shannon entropy in [0, 1] (float32 like the device)."""
        h = self.ent_hist.astype(np.float32)
        total = h.sum(axis=1, keepdims=True, dtype=np.float32)
        p = h / np.maximum(total, np.float32(1.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            xlogx = np.where(p > 0, p * np.log(p), np.float32(0.0))
        ent = -xlogx.sum(axis=1)
        norm = np.float32(np.log(np.float32(self.ent_hist.shape[1])))
        return np.where(total[:, 0] > 0, ent / norm, np.float32(0.0))


def _hll_estimate_np(registers: np.ndarray) -> np.ndarray:
    """[groups] float32 cardinalities — numpy port of ops/hll.estimate
    (same σ/τ fixed-iteration series, same all-zero guard)."""
    g, m = registers.shape
    p = int(m).bit_length() - 1
    q = 32 - p
    clipped = np.clip(registers, 0, q + 1)
    c = np.zeros((g, q + 2), np.float32)
    for gi in range(g):
        c[gi] = np.bincount(clipped[gi].astype(np.int64),
                            minlength=q + 2).astype(np.float32)
    mf = np.float32(m)

    def sigma(x, iters=32):
        y = np.ones_like(x)
        z = x.copy()
        for _ in range(iters):
            x = x * x
            z = z + x * y
            y = y + y
        return z

    def tau(x, iters=32):
        y = np.ones_like(x)
        z = 1.0 - x
        for _ in range(iters):
            x = np.sqrt(x)
            y = np.float32(0.5) * y
            z = z - np.square(1.0 - x) * y
        return z / np.float32(3.0)

    ks = np.arange(1, q + 1, dtype=np.float32)
    z = mf * tau(1.0 - c[:, q + 1] / mf) * np.float32(2.0 ** (-q))
    mid = np.sum(c[:, 1:q + 1] * np.exp2(-ks)[None, :], axis=1)
    denom = z + mid + mf * sigma(c[:, 0] / mf)
    alpha_inf = np.float32(1.0 / (2.0 * math.log(2.0)))
    est = alpha_inf * mf * mf / denom
    return np.where(c[:, 0] >= mf, np.float32(0.0), est)


class SketchTables:
    """The ``sketch`` datasource: versioned sketch tables over a
    :class:`SnapshotCache`, wired into both query engines and the
    rollup manager's datasource listing."""

    def __init__(self, cache: SnapshotCache,
                 tracer=None) -> None:
        self.cache = cache
        self._tracer = tracer if tracer is not None else default_tracer()
        self._lock = threading.Lock()
        self._lat = HostDDSketch()
        self.reads = 0
        self.errors = 0
        self._qps = 0.0
        self._qps_count = 0
        self._qps_t0 = time.time()
        self._views: Dict[int, _SketchView] = {}   # seq -> view (bounded)

    # -- datasource registration (store/rollup.py) -------------------------
    def register_datasource(self) -> None:
        """List the sketch tables beside the rollup tiers (the
        `datasource list` debug/CLI surface)."""
        from deepflow_tpu_torch.store import rollup
        rollup.register_datasource(SKETCH_TABLE, self.datasources)

    def unregister_datasource(self) -> None:
        from deepflow_tpu_torch.store import rollup
        rollup.unregister_datasource(SKETCH_TABLE)

    def datasources(self) -> List[dict]:
        c = self.cache.counters()
        return [{"table": f"{SKETCH_TABLE}.{fn}", "kind": "sketch",
                 "newest_window": c["newest_step"],
                 "cached_snapshots": c["cached"],
                 "staleness_s": c["staleness_s"],
                 "max_staleness_s": c["max_staleness_s"]}
                for fn in ("cms_point", "hll_card", "topk", "entropy")]

    # -- snapshot plumbing -------------------------------------------------
    def _view(self, snap: SketchSnapshot) -> _SketchView:
        v = self._views.get(snap.seq)
        if v is None:
            v = _SketchView(snap)
            if len(self._views) > 4 * self.cache.history:
                self._views.clear()
            self._views[snap.seq] = v
        return v

    def _latest_view(self) -> Optional[_SketchView]:
        snap = self.cache.latest()
        if snap is None:
            return None
        return self._view(snap)

    def _observe(self, t0: float) -> None:
        """Per-query latency + the serving gauges. Gauges re-emit at
        most ~2x/second so the hot read path stays dict-store cheap."""
        dt = time.perf_counter() - t0
        self._lat.add(dt)
        self.reads += 1
        self._qps_count += 1
        now = time.time()
        elapsed = now - self._qps_t0
        if elapsed >= 0.5:
            self._qps = self._qps_count / elapsed
            self._qps_count = 0
            self._qps_t0 = now
            tr = self._tracer
            if tr.enabled:
                tr.gauge("querier_read_qps", self._qps)
                tr.gauge("querier_read_p99_s", self._lat.quantile(0.99))
                st = self.cache.staleness_s()
                if st != float("inf"):
                    tr.gauge("sketch_snapshot_staleness_s", st)

    # -- point queries (the df-ctl / tests surface) ------------------------
    def cms_point(self, key: int) -> Optional[dict]:
        t0 = time.perf_counter()
        try:
            v = self._latest_view()
            if v is None:
                return None
            return {"time": v.snap.wall_time, "window": v.snap.step,
                    "key": int(key) & _MASK,
                    "estimate": v.cms_point(key)}
        finally:
            self._observe(t0)

    def cms_points(self, keys) -> Optional[dict]:
        """Multiget: one vectorized CMS lookup for a whole key batch
        (the dashboard panel shape — 64 flows per refresh cross the API
        as ONE call, and numpy does the per-key work with the GIL
        released). Returns {"estimates": np.ndarray aligned to keys}."""
        t0 = time.perf_counter()
        try:
            v = self._latest_view()
            if v is None:
                return None
            return {"time": v.snap.wall_time, "window": v.snap.step,
                    "estimates": v.cms_points(np.asarray(keys))}
        finally:
            self._observe(t0)

    def hll_card(self, group: Optional[int] = None) -> Optional[dict]:
        t0 = time.perf_counter()
        try:
            v = self._latest_view()
            if v is None:
                return None
            return {"time": v.snap.wall_time, "window": v.snap.step,
                    "group": -1 if group is None else int(group),
                    "cardinality": v.hll_card(group)}
        finally:
            self._observe(t0)

    def topk(self, k: int = 100) -> List[dict]:
        t0 = time.perf_counter()
        try:
            v = self._latest_view()
            if v is None:
                return []
            # pod-merged snapshots (parallel/pod.py) carry shard-
            # participation tags: a reduced-participation answer SAYS
            # so instead of silently serving a partial sketch. Single-
            # chip snapshots have no shards, so no columns appear.
            extra = {}
            if "pod_shards_participated" in v.snap.tags:
                extra = {"shards_active":
                         int(v.snap.tags["pod_shards_participated"]),
                         "shards": int(v.snap.tags.get(
                             "pod_shards", 0)),
                         "shards_missing": list(v.snap.tags.get(
                             "pod_missing", []))}
            # cross-host pod windows append the HOST ladder
            # too: a top-K served off an epoch that excluded a whole
            # host names the host, beside the shard columns
            if "pod_hosts_participated" in v.snap.tags:
                extra.update(
                    {"hosts_active":
                     int(v.snap.tags["pod_hosts_participated"]),
                     "hosts": int(v.snap.tags.get("pod_hosts", 0)),
                     "hosts_missing": list(v.snap.tags.get(
                         "pod_hosts_missing", []))})
            return [dict({"time": v.snap.wall_time,
                          "window": v.snap.step,
                          "rank": r, "flow_key": key, "count": cnt},
                         **extra)
                    for r, (key, cnt) in enumerate(v.topk(k))]
        finally:
            self._observe(t0)

    def entropy(self) -> Optional[dict]:
        t0 = time.perf_counter()
        try:
            v = self._latest_view()
            if v is None:
                return None
            ent = v.entropies()
            out = {"time": v.snap.wall_time, "window": v.snap.step}
            out.update({c: float(ent[i]) for i, c in enumerate(ENTROPY_COLS)})
            return out
        finally:
            self._observe(t0)

    # -- SQL (querier/engine.py delegates table == "sketch" here) ----------
    def sql(self, stmt) -> "QueryResult":
        from deepflow_tpu_torch.querier.engine import QueryResult
        from deepflow_tpu_torch.querier import sql as Q

        t0 = time.perf_counter()
        try:
            lo, hi = self._time_bounds(stmt.where)
            if lo is None and hi is None:
                snap = self.cache.latest()
                snaps = [snap] if snap is not None else []
            else:
                self.cache.latest()         # staleness-bounded refresh
                snaps = self.cache.window_range(lo, hi)
            views = [self._view(s) for s in snaps]
            if len(stmt.items) != 1:
                raise ValueError(
                    "the sketch datasource takes exactly one select "
                    f"item ({', '.join(SKETCH_SQL_FUNCS)} or *)")
            expr = stmt.items[0].expr
            if isinstance(expr, Q.QualifiedFunc):
                cols, rows = self._sql_func(expr, views)
            elif isinstance(expr, Q.Column) \
                    and expr.name in ("sketch.entropy", "entropy"):
                cols, rows = self._sql_entropy(views)
            elif isinstance(expr, Q.Column) and expr.name == "*":
                cols, rows = self._sql_summary(views)
            else:
                raise ValueError(
                    f"unsupported sketch select item {expr!r}; use "
                    f"{', '.join(SKETCH_SQL_FUNCS)} or *")
            off = getattr(stmt, "offset", 0)
            if off:
                rows = rows[off:]
            if stmt.limit is not None:
                rows = rows[:stmt.limit]
            return QueryResult(cols, rows)
        except Exception:
            self.errors += 1
            raise
        finally:
            self._observe(t0)

    @staticmethod
    def _time_bounds(conds) -> Tuple[Optional[float], Optional[float]]:
        from deepflow_tpu_torch.querier import sql as Q
        lo = hi = None
        for c in conds:
            if not isinstance(c, Q.Cond) or c.column not in ("time",
                                                             "timestamp"):
                raise ValueError(
                    "sketch queries filter on `time` only (snapshot "
                    "windows have no other columns to filter)")
            v = float(c.value)
            if c.op == ">":
                lo = max(lo or 0.0, v + 1.0)
            elif c.op == ">=":
                lo = max(lo or 0.0, v)
            elif c.op == "<":
                hi = min(hi if hi is not None else float(1 << 62), v)
            elif c.op == "<=":
                hi = min(hi if hi is not None else float(1 << 62), v + 1.0)
            else:
                raise ValueError(f"unsupported time operator {c.op!r}")
        return lo, hi

    @staticmethod
    def _arg(fn: str, args, n: int, default=None):
        if len(args) > n:
            raise ValueError(f"{fn} takes at most {n} argument(s)")
        if not args:
            return default
        return args[0]

    def _sql_func(self, expr, views):
        name = expr.name
        args = expr.args
        if name in ("sketch.topk", "topk"):
            k = int(self._arg(name, args, 1, 100))
            cols = ["time", "window", "rank", "flow_key", "count"]
            # pod-merged windows answer with their shard participation
            # appended (honest reduced-participation answers);
            # an all-single-chip range keeps the pinned 5-column shape
            # (in a mixed range, single-chip rows carry None there)
            podded = any("pod_shards_participated" in v.snap.tags
                         for v in views)
            if podded:
                cols = cols + ["shards_active", "shards_missing"]
            # cross-host windows add the host ladder columns
            hosted = any("pod_hosts_participated" in v.snap.tags
                         for v in views)
            if hosted:
                cols = cols + ["hosts_active", "hosts_missing"]
            rows = []
            for v in views:
                # same type as the direct topk() path: the missing-shard
                # ID LIST, not a count — one column name, one meaning.
                # A single-chip window in a mixed range answers None,
                # never a bogus -1 shard count.
                pod_v = "pod_shards_participated" in v.snap.tags
                tail = [] if not podded else [
                    int(v.snap.tags["pod_shards_participated"])
                    if pod_v else None,
                    [int(i) for i in v.snap.tags.get("pod_missing", [])]
                    if pod_v else None]
                host_v = "pod_hosts_participated" in v.snap.tags
                if hosted:
                    tail = tail + [
                        int(v.snap.tags["pod_hosts_participated"])
                        if host_v else None,
                        [int(i) for i in v.snap.tags.get(
                            "pod_hosts_missing", [])]
                        if host_v else None]
                for r, (key, cnt) in enumerate(v.topk(k)):
                    rows.append([int(v.snap.wall_time), v.snap.step,
                                 r, key, cnt] + tail)
            return cols, rows
        if name in ("sketch.cms_point", "cms_point"):
            key = self._arg(name, args, 1)
            if key is None:
                raise ValueError("sketch.cms_point(key) needs a flow key")
            cols = ["time", "window", "key", "estimate"]
            rows = [[int(v.snap.wall_time), v.snap.step,
                     int(key) & _MASK, v.cms_point(int(key))]
                    for v in views]
            return cols, rows
        if name in ("sketch.hll_card", "hll_card"):
            group = self._arg(name, args, 1)
            g = None if group is None else int(group)
            cols = ["time", "window", "group", "cardinality"]
            rows = [[int(v.snap.wall_time), v.snap.step,
                     -1 if g is None else g, round(v.hll_card(g), 2)]
                    for v in views]
            return cols, rows
        if name in ("sketch.entropy", "entropy"):
            return self._sql_entropy(views)
        raise ValueError(
            f"unknown sketch function {name!r}; supported: "
            f"{', '.join(SKETCH_SQL_FUNCS)}")

    def _sql_entropy(self, views):
        cols = ["time", "window"] + list(ENTROPY_COLS)
        rows = []
        for v in views:
            ent = v.entropies()
            rows.append([int(v.snap.wall_time), v.snap.step]
                        + [float(ent[i]) for i in range(len(ENTROPY_COLS))])
        return cols, rows

    def _sql_summary(self, views):
        cols = ["time", "window", "rows", "lossy", "degraded", "final"]
        podded = any("pod_shards_participated" in v.snap.tags for v in views)
        if podded:
            cols = cols + ["shards_active", "shards_missing"]
        rows = []
        for v in views:
            row = [int(v.snap.wall_time), v.snap.step, v.rows,
                   int(bool(v.snap.tags.get("lossy"))),
                   int(bool(v.snap.tags.get("degraded"))),
                   int(bool(v.snap.tags.get("final")))]
            if podded:
                pod_v = "pod_shards_participated" in v.snap.tags
                row += [int(v.snap.tags["pod_shards_participated"])
                        if pod_v else None,
                        [int(i) for i in
                         v.snap.tags.get("pod_missing", [])]
                        if pod_v else None]
            rows.append(row)
        return cols, rows

    # -- PromQL (querier/promql.py leaf functions) -------------------------
    def prom_series(self, fn: str, arg: Optional[float],
                    grid: np.ndarray):
        """[(labels, values-on-grid)] for one sketch PromQL function.
        Each grid point answers from the newest snapshot at-or-before it
        (within the lookback); missing points are NaN (stale)."""
        t0 = time.perf_counter()
        try:
            self.cache.latest()             # staleness-bounded refresh
            snaps = self.cache.window_range(None, None)
            if not snaps:
                return []
            walls = np.asarray([s.wall_time for s in snaps])
            g = np.asarray(grid, np.float64)
            idx = np.searchsorted(walls, g, side="right") - 1
            valid = idx >= 0
            age = np.where(valid, g - walls[np.maximum(idx, 0)], np.inf)
            valid &= age <= LOOKBACK_S
            used = sorted({int(i) for i, ok in zip(idx, valid) if ok})
            if not used:
                return []
            views = {i: self._view(snaps[i]) for i in used}
            n = len(g)

            def series(labels, per_snap: Dict[int, float]):
                vals = np.full(n, np.nan)
                for j in range(n):
                    if valid[j]:
                        vals[j] = per_snap.get(int(idx[j]), np.nan)
                return labels, vals

            if fn == "sketch_cms_point":
                if arg is None:
                    raise ValueError("sketch_cms_point(key) needs a key")
                key = int(arg)
                return [series({"flow_key": str(key & _MASK)},
                               {i: float(v.cms_point(key))
                                for i, v in views.items()})]
            if fn == "sketch_hll_card":
                group = None if arg is None else int(arg)
                labels = {} if group is None else {"group": str(group)}
                return [series(labels,
                               {i: v.hll_card(group)
                                for i, v in views.items()})]
            if fn == "sketch_entropy":
                out = []
                ents = {i: v.entropies() for i, v in views.items()}
                for f_i, feat in enumerate(("ip_src", "ip_dst",
                                            "port_src", "port_dst")):
                    out.append(series({"feature": feat},
                                      {i: float(e[f_i])
                                       for i, e in ents.items()}))
                return out
            if fn == "sketch_topk":
                k = 100 if arg is None else int(arg)
                per_snap = {i: dict(v.topk(k)) for i, v in views.items()}
                keys = sorted({key for d in per_snap.values() for key in d})
                return [series({"flow_key": str(key)},
                               {i: float(d[key])
                                for i, d in per_snap.items() if key in d})
                        for key in keys]
            raise ValueError(f"unknown sketch function {fn!r}")
        except Exception:
            self.errors += 1
            raise
        finally:
            self._observe(t0)

    # -- observability -----------------------------------------------------
    def counters(self) -> dict:
        c = {"reads": self.reads, "errors": self.errors,
             "read_qps": round(self._qps, 1),
             "read_p50_s": round(self._lat.quantile(0.5), 6),
             "read_p99_s": round(self._lat.quantile(0.99), 6)}
        c.update({f"cache_{k}": v
                  for k, v in self.cache.counters().items()})
        return c
