"""Query execution over the columnar store.

The reference engine turns DeepFlow-SQL into ClickHouse SQL and lets CH
aggregate (engine/clickhouse/clickhouse.go). Here the store is ours, so
execution is direct: partition-pruned scans, vectorized numpy filters,
and GROUP BY through the same `group_reduce` the rollup manager uses, on
the engine's `device`: on the card, a batch of at least
`rollup.AUTO_DEVICE_ROWS` rows with u32 keys sorts and reduces there; a
Percentile asks for the row->group map and takes the host sort with the
reduce on the device. SmartEncoded hash columns translate to/from
strings through TagDicts (the reference joins flow_tag dict tables,
engine/clickhouse/tag/translation.go).

A copy of the JAX package's `querier/engine.py` with a `device`
argument; the results are the same on either device.
"""

from __future__ import annotations

import dataclasses
import re

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepflow_tpu_torch.models.flow_suite import check_device
from deepflow_tpu_torch.querier import metrics as M
from deepflow_tpu_torch.querier import sql as Q
from deepflow_tpu_torch.store.db import Store, Table
from deepflow_tpu_torch.store.dict_store import TagDictRegistry
from deepflow_tpu_torch.store.rollup import group_reduce
from deepflow_tpu_torch.store.table import AggKind

# hash-typed columns -> candidate dictionaries that can reverse them (a
# column name may be written by more than one pipeline with different
# dicts, e.g. event_type in resource_event vs in_process_profile)
DICT_COLUMNS = {
    "endpoint_hash": ("l7_endpoint",),
    "province_0": ("province",),
    "province_1": ("province",),
    "metric": ("metric_name",),
    "labels": ("label_set",),
    "stack": ("profile_stack",),
    "app_service": ("profile_name",),
    "event_type": ("event_strings", "profile_name"),
    "filename": ("event_strings",),
    "policy_name": ("event_strings",),
    "alarm_target": ("event_strings",),
    "description": ("event_strings",),
}


@dataclass
class QueryResult:
    columns: List[str]
    values: List[List]         # row-major, JSON-friendly

    def as_dict(self) -> dict:
        return {"columns": self.columns, "values": self.values}


class QueryEngine:
    def __init__(self, store: Store,
                 tag_dicts: Optional[TagDictRegistry] = None,
                 tagrecorder=None, sketch=None, anomaly=None,
                 timeline=None, incidents=None, device="cuda") -> None:
        self.store = store
        # where the GROUP BY reduces (store/rollup.group_reduce): the
        # card unless the caller names the CPU
        self.device = check_device(device)
        self.tag_dicts = tag_dicts
        # controller.tagrecorder.TagRecorder: id->name dimension dicts for
        # KnowledgeGraph columns (pod_id_0 -> pod name); duck-typed so the
        # querier runs without a controller
        self.tagrecorder = tagrecorder
        # serving.SketchTables: the `sketch` virtual datasource
        # — SELECT sketch.cms_point/hll_card/topk/entropy answers from
        # the in-process snapshot cache, never the store or the device
        self.sketch = sketch
        # serving.AnomalyTables: SELECT * FROM anomaly —
        # the detection lane's durable alert records as a table
        self.anomaly = anomaly
        # runtime.Timeline / runtime.IncidentRecorder:
        # SELECT * FROM timeline / FROM incidents — the self-telemetry
        # rings and the flight recorder's bundles as tables
        self.timeline = timeline
        self.incidents = incidents

    # -- public ------------------------------------------------------------
    def execute(self, sql_text: str, db: Optional[str] = None) -> QueryResult:
        stmt = Q.parse_sql(sql_text)
        if isinstance(stmt, Q.Show):
            return self._show(stmt, db)
        if isinstance(stmt, Q.With):
            return self._with(stmt, db)
        return self._select(stmt, db)

    # -- SHOW --------------------------------------------------------------
    def _show(self, stmt: Q.Show, db: Optional[str]) -> QueryResult:
        if stmt.what == "databases":
            names = sorted({d for d, _ in self.store.tables()})
            return QueryResult(["name"], [[n] for n in names])
        if stmt.what == "tables":
            rows = [[d, t] for d, t in self.store.tables()
                    if stmt.table in (None, d)]
            return QueryResult(["database", "table"], rows)
        table = self._resolve_table(stmt.table, db)
        if stmt.what == "tag_values":
            # distinct stored values of one TAG column, humanized (the
            # Grafana variable-dropdown surface). The dedup is the same
            # group_reduce as any GROUP BY with no aggregates. Only KEY
            # columns qualify — a float metric would truncate-merge in
            # the int64 key packing and fabricate "distinct" values.
            tags = {c.name for c in table.schema.columns
                    if c.agg is AggKind.KEY}
            if stmt.tag not in tags:
                raise ValueError(f"{stmt.tag!r} is not a tag of "
                                 f"{stmt.table} (SHOW TAGS lists them)")
            cols = table.scan(columns=[stmt.tag])
            uniq = group_reduce(cols, [stmt.tag], {}, device=self.device)
            rows = [[v] for v in uniq[stmt.tag].tolist()]
            # humanize BEFORE sort/limit: a dict-hash column must page
            # through alphabetical names, not arbitrary hash order
            rows = self._humanize([stmt.tag], rows)
            rows.sort(key=lambda r: (isinstance(r[0], str), r[0]))
            if stmt.limit is not None:
                rows = rows[:stmt.limit]
            return QueryResult([stmt.tag], rows)
        if stmt.what == "tags":
            rows = [[c.name, np.dtype(c.dtype).name]
                    for c in table.schema.columns if c.agg is AggKind.KEY]
            return QueryResult(["name", "type"], rows)
        rows = [[c.name, c.agg.value, "", ""]
                for c in table.schema.columns if c.agg is not AggKind.KEY]
        # derived metrics the table can satisfy (reference:
        # engine/clickhouse/metrics/ registry); a real column of the same
        # name shadows the library entry, matching SELECT precedence
        col_names = set(table.schema.column_names)
        for name, (expr, unit, desc) in sorted(
                M.available_for(col_names).items()):
            if name not in col_names:
                rows.append([name, "derived", unit, desc])
        return QueryResult(["name", "operator", "unit", "description"],
                          rows)

    # -- SELECT ------------------------------------------------------------
    def _resolve_table(self, name: str, db: Optional[str]) -> Table:
        # rollup tables are themselves dotted (`flows.1m`), so with a db
        # in hand the whole name is tried as a table FIRST — otherwise
        # the first dot would be misread as a db separator and every
        # rollup table would be unqueryable relative to its db
        if db is not None:
            try:
                return self.store.table(db, name)
            except KeyError:
                pass
        if "." in name:
            d, _, t = name.partition(".")
            try:
                return self.store.table(d, t)
            except KeyError:
                pass
        if db is None:
            # no db scoping requested: search every database
            for d, t in self.store.tables():
                if t == name:
                    try:
                        return self.store.table(d, t)
                    except KeyError:
                        continue   # dropped between listing and lookup
        # an explicit db must NOT fall through to other databases — a
        # typo'd db would silently answer from the wrong data
        raise KeyError(f"unknown table {name}"
                       + (f" in db {db}" if db is not None else ""))

    def _select(self, stmt: Q.Select, db: Optional[str]) -> QueryResult:
        if self.sketch is not None and stmt.table == "sketch":
            # the sketch datasource: snapshot-cache reads, no store scan
            return self.sketch.sql(stmt)
        if self.anomaly is not None and stmt.table == "anomaly":
            # the anomaly datasource: alert records off the plane's
            # snapshot cache — same no-store, no-device posture
            return self.anomaly.sql(stmt)
        if self.timeline is not None and stmt.table == "timeline":
            # the self-telemetry datasource: one row per
            # ring sample, straight off the in-process rings
            return self.timeline.sql(stmt)
        if self.incidents is not None and stmt.table == "incidents":
            # the flight recorder's bundles: one row per manifest
            return self.incidents.sql(stmt)
        table = self._resolve_table(stmt.table, db)
        schema = table.schema

        # SELECT *: every schema column, in schema order
        if len(stmt.items) == 1 \
                and isinstance(stmt.items[0].expr, Q.Column) \
                and stmt.items[0].expr.name == "*":
            stmt = dataclasses.replace(stmt, items=[
                Q.SelectItem(Q.Column(c.name), None)
                for c in schema.columns])

        # expand derived metrics: a bare identifier that names a library
        # metric (and not a real column) substitutes its expression, so
        # `SELECT ip_dst, rtt_avg FROM l4 GROUP BY ip_dst` just works
        col_names = set(schema.column_names)
        items = []
        for it in stmt.items:
            if isinstance(it.expr, Q.Column) \
                    and it.expr.name not in col_names:
                d = M.expression(it.expr.name)
                if d is not None:
                    items.append(Q.SelectItem(d, it.alias or it.expr.name))
                    continue
            items.append(it)
        if items != stmt.items:
            # replace(), never positional reconstruction: a new Select
            # field must not be silently droppable at this call site
            stmt = dataclasses.replace(stmt, items=items)

        # columns referenced anywhere
        bucket = next((g for g in stmt.group_by
                       if isinstance(g, Q.TimeBucket)), None)
        for it in stmt.items:
            # walk the whole tree: time(30)+0 must not dodge the check
            for tb in _time_buckets(it.expr):
                if tb != bucket:
                    raise ValueError(
                        "time()/interval() in the select list requires "
                        "the SAME bucket in GROUP BY")
        needed = {g for g in stmt.group_by if isinstance(g, str)}
        for it in stmt.items:
            needed |= Q.expr_columns(it.expr)
        for c in stmt.where:
            needed |= _where_columns(c)
        if bucket is not None:
            needed.add(schema.time_column)
        if not needed:
            needed = {schema.time_column}  # Count(*) still needs row counts
        for nm in needed:
            schema.spec(nm)  # raises on unknown

        time_range, residual = self._time_bounds(stmt.where,
                                                 schema.time_column)
        # PerSecond(): resolve IntervalRef to concrete seconds — the
        # bucket width under interval grouping, else the WHERE span
        if any(_has_interval_ref(it.expr) for it in stmt.items):
            # BOTH bounds must be explicit: _time_bounds fills a missing
            # lower bound with 0, and dividing by an epoch-sized span
            # would silently collapse every rate to ~0
            has_lo = any(isinstance(c, Q.Cond) and c.column ==
                         schema.time_column and c.op in (">", ">=")
                         for c in stmt.where)
            if bucket is not None:
                iv = bucket.seconds
            elif time_range is not None and has_lo \
                    and time_range[1] < (1 << 62):
                iv = max(time_range[1] - time_range[0], 1)
            else:
                raise ValueError(
                    "PerSecond() needs GROUP BY time(N) or a WHERE "
                    "time range bounded on both sides to define the "
                    "interval")
            stmt = dataclasses.replace(stmt, items=[
                Q.SelectItem(_resolve_interval(it.expr, iv),
                             it.alias or _expr_name(it.expr))
                for it in stmt.items])
        cols = table.scan(columns=sorted(needed), time_range=time_range)
        mask = self._filter_mask(cols, residual)
        if mask is not None:
            cols = {k: v[mask] for k, v in cols.items()}
        if bucket is not None:
            # interval lowering: floor the time column once, then group
            # on the bucket like any other key (the reduction itself is
            # the same device segment-reduce — reference TransGroupBy
            # lowers to toStartOfInterval the same way)
            t = cols[schema.time_column].astype(np.int64)
            cols["__time_bucket"] = (t // bucket.seconds) * bucket.seconds

        if stmt.group_by:
            out_cols, out_rows = self._grouped(stmt, cols)
        else:
            out_cols, out_rows = self._flat(stmt, cols)

        out_rows = self._having(stmt, out_cols, out_rows)
        out_rows = self._order_limit(stmt, out_cols, out_rows)
        out_rows = self._humanize(out_cols, out_rows)
        return QueryResult(out_cols, out_rows)

    def _with(self, stmt: Q.With, db: Optional[str]) -> QueryResult:
        """WITH q1 AS (...), q2 AS (...) SELECT ... FROM q1 [LEFT] JOIN
        q2 ON ... — the reference's Grafana multi-metric panel shape
        (two aggregated subqueries hash-joined on their shared tags,
        clickhouse_test.go:452). Each CTE runs through the normal select
        path (device GROUP BY and all); the join is a host hash join
        over the (small) aggregated results."""
        results: Dict[str, QueryResult] = {}
        for name, sel in stmt.ctes:
            results[name] = self._select(sel, db)
        js = stmt.select
        left, right = results[js.left], results[js.right]
        lpos = {c: i for i, c in enumerate(left.columns)}
        rpos = {c: i for i, c in enumerate(right.columns)}
        for lc, rc in js.on:
            if lc not in lpos:
                raise ValueError(f"ON column {lc!r} not produced by "
                                 f"{js.left} ({left.columns})")
            if rc not in rpos:
                raise ValueError(f"ON column {rc!r} not produced by "
                                 f"{js.right} ({right.columns})")
        # hash the right side on its key tuple. Duplicate keys would make
        # the join silently pick one arbitrary row per key — nothing
        # forces a CTE to aggregate, so enforce it instead of guessing
        index: Dict[tuple, list] = {}
        for row in right.values:
            key = tuple(row[rpos[rc]] for _, rc in js.on)
            if key in index:
                raise ValueError(
                    f"JOIN right side {js.right!r} has duplicate key "
                    f"{key!r}; GROUP BY the CTE so join keys are unique")
            index[key] = row

        def resolve(item: Q.SelectItem):
            qname = item.expr.name
            qn, _, col = qname.partition(".")
            if qn == js.left:
                if col not in lpos:
                    raise ValueError(f"{qname}: no column {col!r} in "
                                     f"{js.left}")
                return ("L", lpos[col])
            if qn == js.right:
                if col not in rpos:
                    raise ValueError(f"{qname}: no column {col!r} in "
                                     f"{js.right}")
                return ("R", rpos[col])
            raise ValueError(f"{qname}: unknown query name {qn!r}")

        plan = [resolve(it) for it in js.items]
        out_cols = [it.alias or it.expr.name for it in js.items]
        rows = []
        for lrow in left.values:
            key = tuple(lrow[lpos[lc]] for lc, _ in js.on)
            rrow = index.get(key)
            if rrow is None and js.join_type != "left":
                continue
            rows.append([
                lrow[i] if side == "L"
                else (rrow[i] if rrow is not None else None)
                for side, i in plan])
        rows = self._order_limit(js, out_cols, rows)
        return QueryResult(out_cols, rows)

    def _having(self, stmt: Q.Select, out_cols: List[str], rows):
        """Post-aggregation row filter on output columns/aliases
        (reference: TransHaving in engine/clickhouse)."""
        if not stmt.having:
            return rows
        idx = {}
        for c in stmt.having:
            if c.column not in out_cols:
                raise ValueError(
                    f"HAVING references {c.column!r}, which is not an "
                    f"output column of this query ({out_cols})")
            idx[c.column] = out_cols.index(c.column)

        preds = [(idx[c.column], self._scalar_pred(c))
                 for c in stmt.having]
        return [row for row in rows
                if all(p(row[j]) for j, p in preds)]

    def _scalar_pred(self, c: Q.Cond):
        """One condition -> a value predicate, with the literal
        translated through the dictionaries ONCE (the scalar form of
        _filter_mask's semantics: unknown strings match nothing,
        duplicate resource names widen =/!= to membership — keep the
        two in agreement)."""
        import operator
        ops = {"=": operator.eq, "!=": operator.ne, "<": operator.lt,
               "<=": operator.le, ">": operator.gt, ">=": operator.ge}
        if c.op in ("in", "not_in"):
            hits = [self._cond_value(c.column, x) for x in c.value]
            flat = {y for x in hits if x is not None
                    for y in (x if isinstance(x, list) else [x])}
            if c.op == "not_in":
                return lambda v: v not in flat
            return lambda v: v in flat
        if c.op in ("like", "not_like", "regexp"):
            raise ValueError(f"{c.op} is a WHERE operator; HAVING "
                             "compares aggregated values")
        raw = self._cond_value(c.column, c.value)
        if raw is None:              # unknown dictionary string
            return lambda v, ok=(c.op == "!="): ok
        if isinstance(raw, list):
            if c.op not in ("=", "!="):
                raise ValueError(
                    f"ordering comparison with name {c.value!r} matching "
                    f"{len(raw)} resources")
            members = set(raw)
            if c.op == "=":
                return lambda v: v in members
            return lambda v: v not in members
        return lambda v, op=ops[c.op], t=raw: op(v, t)

    # -- where -------------------------------------------------------------
    def _time_bounds(self, conds, tcol: str):
        """Split WHERE into a [lo,hi) range on the time column (for
        partition pruning) + residual vectorized conditions. Only
        TOP-LEVEL conjuncts prune; OR/NOT subtrees stay residual (a
        time bound inside `a OR b` does not bound the whole scan)."""
        lo, hi = None, None
        residual = []
        for c in conds:
            if not isinstance(c, Q.Cond):
                residual.append(c)
            elif c.column == tcol and c.op in (">", ">=", "<", "<="):
                v = int(c.value)
                if c.op == ">":
                    lo = max(lo or 0, v + 1)
                elif c.op == ">=":
                    lo = max(lo or 0, v)
                elif c.op == "<":
                    hi = min(hi if hi is not None else 1 << 62, v)
                else:
                    hi = min(hi if hi is not None else 1 << 62, v + 1)
            else:
                residual.append(c)
        if lo is None and hi is None:
            return None, residual
        return (lo or 0, hi if hi is not None else 1 << 62), residual

    def _cond_value(self, column: str, value):
        """Translate string literals on hash columns through the dicts,
        and on KnowledgeGraph id columns through the tagrecorder (the
        reference's auto-tag: WHERE pod_id = 'api-0' filters by resource
        NAME). Lookup-only (never grows a dictionary); an unknown string
        returns None, meaning the condition matches nothing. Duplicate
        resource names return a list — the caller widens = to IN."""
        if isinstance(value, str):
            dict_names = DICT_COLUMNS.get(column)
            if dict_names is not None and self.tag_dicts is not None:
                for dn in dict_names:
                    h = self.tag_dicts.get(dn).lookup(value)
                    if h is not None:
                        return h
                return None
            if self.tagrecorder is not None:
                d = self.tagrecorder.dict_for_column(column)
                if d is not None:
                    ids = d.ids_for_name(value)
                    if not ids:
                        return None
                    return ids[0] if len(ids) == 1 else ids
            raise ValueError(
                f"string literal on non-dictionary column {column}")
        return value

    def _filter_mask(self, cols: Dict[str, np.ndarray],
                     conds) -> Optional[np.ndarray]:
        if not conds:
            return None
        mask = None
        for c in conds:
            m = self._node_mask(cols, c)
            mask = m if mask is None else (mask & m)
        return mask

    def _node_mask(self, cols, node) -> np.ndarray:
        """One WHERE tree node -> boolean row mask."""
        if isinstance(node, Q.BoolOp):
            if node.op == "not":
                return ~self._node_mask(cols, node.children[0])
            parts = [self._node_mask(cols, ch) for ch in node.children]
            out = parts[0]
            for p in parts[1:]:
                out = (out & p) if node.op == "and" else (out | p)
            return out
        c = node
        col = cols[c.column]
        if c.op in ("in", "not_in"):
            vals = []
            for x in c.value:
                v = self._cond_value(c.column, x)
                if v is None:
                    continue
                # a duplicate resource name maps to several ids
                vals.extend(v if isinstance(v, list) else [v])
            m = np.isin(col, np.asarray(vals, dtype=col.dtype)) if vals \
                else np.zeros(len(col), np.bool_)
            return ~m if c.op == "not_in" else m
        if c.op in ("like", "not_like", "regexp"):
            ids = self._pattern_ids(c.column, c.op, c.value)
            m = np.isin(col, np.asarray(sorted(ids),
                                        dtype=col.dtype)) if ids \
                else np.zeros(len(col), np.bool_)
            return ~m if c.op == "not_like" else m
        raw = self._cond_value(c.column, c.value)
        if raw is None:  # unknown dictionary string
            return np.full(len(col), c.op == "!=")
        if isinstance(raw, list):
            # a resource name shared by several ids: = widens to
            # membership, != to non-membership
            if c.op not in ("=", "!="):
                raise ValueError(
                    f"ordering comparison with name "
                    f"{c.value!r} matching {len(raw)} resources")
            member = np.isin(col, np.asarray(raw, dtype=col.dtype))
            return member if c.op == "=" else ~member
        v = np.asarray(raw).astype(col.dtype)
        return {"=": col == v, "!=": col != v, "<": col < v,
                "<=": col <= v, ">": col > v, ">=": col >= v}[c.op]

    def _pattern_ids(self, column: str, op: str, pattern: str):
        """LIKE/REGEXP on a dictionary-backed column: enumerate the
        column's dictionary (tag dicts or tagrecorder names), match the
        pattern against the STRINGS, return the matching ids — the
        reference lowers LIKE on auto-tags to dictGet the same way."""
        if op in ("like", "not_like"):
            # SQL wildcards -> anchored regex (% = any run, _ = one)
            rx = re.compile("".join(
                ".*" if ch == "%" else "." if ch == "_"
                else re.escape(ch) for ch in pattern))
            match = rx.fullmatch
        else:
            # REGEXP is an unanchored SEARCH (ClickHouse match(), the
            # reference's lowering) — fullmatch would make 'api' match
            # nothing
            match = re.compile(pattern).search
        ids = set()
        dict_names = DICT_COLUMNS.get(column)
        if dict_names is not None and self.tag_dicts is not None:
            for dn in dict_names:
                d = self.tag_dicts.get(dn)
                for s in d.values():
                    if match(s):
                        h = d.lookup(s)
                        if h is not None:
                            ids.add(h)
            return ids
        if self.tagrecorder is not None:
            d = self.tagrecorder.dict_for_column(column)
            if d is not None:
                for i, name in d.snapshot().items():
                    if match(str(name)):
                        ids.add(i)
                return ids
        raise ValueError(
            f"{op.upper().replace('_', ' ')} needs a dictionary-backed "
            f"column, got {column}")

    # -- aggregation -------------------------------------------------------
    def _grouped(self, stmt: Q.Select, cols: Dict[str, np.ndarray]):
        # a plain column in the select list must be grouped (SELECT *
        # with GROUP BY reaches here for every schema column) — catch it
        # here with a real message, not a KeyError from _eval_reduced
        grouped = {g for g in stmt.group_by if isinstance(g, str)}
        for it in stmt.items:
            if isinstance(it.expr, Q.Column) and it.expr.name not in grouped:
                raise ValueError(
                    f"column {it.expr.name!r} must appear in GROUP BY "
                    "or inside an aggregate function")
        group_names = ["__time_bucket" if isinstance(g, Q.TimeBucket)
                       else g for g in stmt.group_by]
        aggs: Dict[str, str] = {}     # internal value name -> reduce kind
        value_src: Dict[str, np.ndarray] = {}
        # Percentile cannot ride the segment reduction (no sum/max/min
        # form); its sources reduce per group AFTER, via the row->group
        # inverse the same grouping pass produces
        pct_jobs: Dict[str, Tuple[np.ndarray, float]] = {}
        n = len(next(iter(cols.values()))) if cols else 0

        def register(agg: Q.Agg) -> str:
            kind = agg.func
            if agg.arg is None:            # Count(*)
                key = "__count"
                value_src[key] = np.ones(n, np.int64)
                aggs[key] = "sum"
                return key
            src = _eval_cols(agg.arg, cols, n)
            key = f"__{kind}_{len(value_src) + len(pct_jobs)}"
            if kind == "percentile":
                pct_jobs[key] = (src, agg.param)
                return key
            value_src[key] = src
            aggs[key] = "count" if kind == "count" else \
                "sum" if kind in ("sum", "avg") else kind
            if kind == "avg":
                value_src[key + "_n"] = np.ones(n, np.int64)
                aggs[key + "_n"] = "sum"
            if kind == "count":
                aggs[key] = "sum"
                value_src[key] = np.ones(n, np.int64)
            return key

        # map every aggregate in every select item to a reduced column
        plans = [_plan_aggs(it.expr, register) for it in stmt.items]
        work = {k: cols[k] for k in group_names}
        if not aggs and pct_jobs:
            # the reduction needs at least one value column to carry
            work["__ones"] = np.ones(n, np.int64)
            aggs["__ones"] = "sum"
        work.update(value_src)
        if n == 0:
            reduced = {k: np.empty(0, np.int64)
                       for k in group_names + list(aggs)}
            for key in pct_jobs:
                reduced[key] = np.empty(0, np.float64)
        elif pct_jobs:
            reduced, inv = group_reduce(work, group_names, aggs,
                                        return_inverse=True,
                                        device=self.device)
            order = np.argsort(inv, kind="stable")
            n_groups = len(next(iter(reduced.values())))
            bounds = np.searchsorted(inv[order], np.arange(n_groups + 1))
            for key, (src, p) in pct_jobs.items():
                vals = src[order].astype(np.float64)
                out = np.empty(n_groups, np.float64)
                for g in range(n_groups):
                    seg = vals[bounds[g]:bounds[g + 1]]
                    out[g] = np.percentile(seg, p) if len(seg) else np.nan
                reduced[key] = out
        else:
            reduced = group_reduce(work, group_names, aggs,
                                   device=self.device)

        out_cols, series = [], []
        for it, plan in zip(stmt.items, plans):
            name = it.alias or _expr_name(it.expr)
            out_cols.append(name)
            series.append(_eval_reduced(plan, reduced))
        rows = [list(r) for r in zip(*[np.asarray(s).tolist()
                                       for s in series])] if series else []
        return out_cols, rows

    def _flat(self, stmt: Q.Select, cols: Dict[str, np.ndarray]):
        n = len(next(iter(cols.values()))) if cols else 0
        has_agg = any(_has_agg(it.expr) for it in stmt.items)
        out_cols, series = [], []
        for it in stmt.items:
            name = it.alias or _expr_name(it.expr)
            out_cols.append(name)
            if has_agg:
                series.append([_eval_scalar(it.expr, cols, n)])
            else:
                series.append(np.asarray(
                    _eval_cols(it.expr, cols, n)).tolist())
        rows = [list(r) for r in zip(*series)]
        return out_cols, rows

    # -- post --------------------------------------------------------------
    def _order_limit(self, stmt, out_cols: List[str], rows):
        # multi-key sort: apply keys in reverse so the stable sort makes
        # the first ORDER BY key primary. None values (left-join misses)
        # sort last in either direction.
        for key, desc in reversed(stmt.order_by):
            if key not in out_cols:
                raise ValueError(f"ORDER BY {key} not in select list")
            idx = out_cols.index(key)
            rows = sorted(rows,
                          key=lambda r: ((r[idx] is None) ^ desc,
                                         0 if r[idx] is None else r[idx]),
                          reverse=desc)
        off = getattr(stmt, "offset", 0)
        if off:
            rows = rows[off:]
        if stmt.limit is not None:
            rows = rows[:stmt.limit]
        return rows

    def _humanize(self, out_cols: List[str], rows):
        """Reverse-translate dictionary hash columns to strings, and
        KnowledgeGraph id columns to resource names (tagrecorder)."""
        if self.tagrecorder is not None:
            for j, name in enumerate(out_cols):
                d = self.tagrecorder.dict_for_column(name)
                if d is None:
                    continue
                id_names = d.snapshot()  # one locked copy per column
                for r in rows:
                    if isinstance(r[j], (int, np.integer)):
                        r[j] = id_names.get(int(r[j]), r[j])
        if self.tag_dicts is None:
            return rows
        for j, name in enumerate(out_cols):
            dict_names = DICT_COLUMNS.get(name)
            if dict_names is None:
                continue
            dicts = [self.tag_dicts.get(dn) for dn in dict_names]
            for r in rows:
                for d in dicts:
                    s = d.decode(int(r[j]))
                    if s is not None:
                        r[j] = s
                        break
        return rows


# -- expression helpers ----------------------------------------------------
def _time_buckets(e: Q.Expr) -> List[Q.TimeBucket]:
    if isinstance(e, Q.TimeBucket):
        return [e]
    if isinstance(e, Q.BinOp):
        return _time_buckets(e.left) + _time_buckets(e.right)
    if isinstance(e, Q.Agg) and e.arg is not None:
        return _time_buckets(e.arg)
    return []


def _has_agg(e: Q.Expr) -> bool:
    if isinstance(e, Q.Agg):
        return True
    if isinstance(e, Q.BinOp):
        return _has_agg(e.left) or _has_agg(e.right)
    return False


def _expr_name(e: Q.Expr) -> str:
    if isinstance(e, Q.Column):
        return e.name
    if isinstance(e, Q.Literal):
        return str(e.value)
    if isinstance(e, Q.Agg):
        if e.func == "percentile":
            return f"percentile({_expr_name(e.arg)},{e.param:g})"
        return f"{e.func}({_expr_name(e.arg) if e.arg else '*'})"
    if isinstance(e, Q.TimeBucket):
        return "time"            # Grafana timeseries column convention
    if isinstance(e, Q.IntervalRef):
        return "interval"
    return f"{_expr_name(e.left)}{e.op}{_expr_name(e.right)}"


def _where_columns(node) -> set:
    """Column names referenced anywhere in a WHERE tree node."""
    if isinstance(node, Q.BoolOp):
        out = set()
        for ch in node.children:
            out |= _where_columns(ch)
        return out
    return {node.column}


def _has_interval_ref(e: Q.Expr) -> bool:
    if isinstance(e, Q.IntervalRef):
        return True
    if isinstance(e, Q.BinOp):
        return _has_interval_ref(e.left) or _has_interval_ref(e.right)
    if isinstance(e, Q.Agg) and e.arg is not None:
        return _has_interval_ref(e.arg)
    return False


def _resolve_interval(e: Q.Expr, seconds: int) -> Q.Expr:
    """Substitute IntervalRef with the resolved interval literal."""
    if isinstance(e, Q.IntervalRef):
        return Q.Literal(seconds)
    if isinstance(e, Q.BinOp):
        return Q.BinOp(e.op, _resolve_interval(e.left, seconds),
                       _resolve_interval(e.right, seconds))
    if isinstance(e, Q.Agg) and e.arg is not None:
        return Q.Agg(e.func, _resolve_interval(e.arg, seconds), e.param)
    return e


def _eval_cols(e: Q.Expr, cols: Dict[str, np.ndarray], n: int) -> np.ndarray:
    """Row-wise evaluation (no aggregates)."""
    if isinstance(e, Q.Column):
        c = cols[e.name]
        # floats stay float row-wise; grouped reduction is integer-domain
        # (group_reduce casts to int64 — fractional metric sums truncate)
        return c.astype(np.float64 if c.dtype.kind == "f" else np.int64)
    if isinstance(e, Q.Literal):
        return np.full(n, e.value)
    if isinstance(e, Q.BinOp):
        a = _eval_cols(e.left, cols, n)
        b = _eval_cols(e.right, cols, n)
        return _apply_op(e.op, a, b)
    raise ValueError("aggregate in row-wise context")


def _apply_op(op: str, a, b):
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.asarray(a, np.float64) / np.asarray(b, np.float64)
    return np.nan_to_num(r)


def _plan_aggs(e: Q.Expr, register) -> Q.Expr:
    """Rewrite Agg nodes into Column refs over reduced names."""
    if isinstance(e, Q.Agg):
        return Q.Column(register(e) + ("|avg" if e.func == "avg" else ""))
    if isinstance(e, Q.TimeBucket):
        return Q.Column("__time_bucket")
    if isinstance(e, Q.BinOp):
        return Q.BinOp(e.op, _plan_aggs(e.left, register),
                       _plan_aggs(e.right, register))
    return e


def _eval_reduced(e: Q.Expr, reduced: Dict[str, np.ndarray]) -> np.ndarray:
    if isinstance(e, Q.Column):
        if e.name.endswith("|avg"):
            base = e.name[:-4]
            return _apply_op("/", reduced[base], reduced[base + "_n"])
        return reduced[e.name]
    if isinstance(e, Q.Literal):
        some = next(iter(reduced.values()))
        return np.full(len(some), e.value)
    return _apply_op(e.op, _eval_reduced(e.left, reduced),
                     _eval_reduced(e.right, reduced))


def _eval_scalar(e: Q.Expr, cols: Dict[str, np.ndarray], n: int):
    if isinstance(e, Q.Agg):
        if e.arg is None or e.func == "count":
            return n
        src = _eval_cols(e.arg, cols, n)
        if len(src) == 0:
            return 0
        if e.func == "sum":
            return int(src.sum())
        if e.func == "max":
            return int(src.max())
        if e.func == "min":
            return int(src.min())
        if e.func == "percentile":
            return float(np.percentile(src, e.param))
        return float(src.mean())
    if isinstance(e, Q.BinOp):
        return _apply_op(e.op, _eval_scalar(e.left, cols, n),
                         _eval_scalar(e.right, cols, n))
    if isinstance(e, Q.Literal):
        return e.value
    raise ValueError(f"bare column {e} in aggregate context")
