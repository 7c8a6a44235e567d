"""The port's serving tables (deepflow_tpu_torch/serving/) against the JAX
package's, on the CPU.

The port's `TpuSketchExporter(device="cpu")` publishes Zipf windows, and
a second one with the anomaly plane on publishes the `ddos_ramp`
alerts. The port's `SketchTables` and `AnomalyTables` read the
exporters' in-memory buses; the JAX tables read the same snapshots back
from the buses' directories. After every window both are asked the same
questions: point reads, SQL, PromQL series, staleness and counters must
be identical (both packages answer in numpy int64, float32 and float64
from the same leaves). The caches run on one pinned clock, past every
window, so every read refreshes in both packages alike.
"""

import json

import numpy as np
import pytest

from deepflow_tpu.querier.engine import QueryEngine as JEngine
from deepflow_tpu.querier.promql import PromEngine as JProm
from deepflow_tpu.querier.sql import parse_sql as jparse
from deepflow_tpu.replay.generator import ddos_ramp
from deepflow_tpu.runtime import tracing as jtracing
from deepflow_tpu.runtime.snapbus import SnapshotBus as JBus
from deepflow_tpu.serving import AnomalyTables as JAnomaly
from deepflow_tpu.serving import SketchTables as JTables
from deepflow_tpu.serving import SnapshotCache as JCache
from deepflow_tpu.store import db as jdb
from deepflow_tpu.store import dict_store as jdicts
from deepflow_tpu_torch.anomaly.detectors import AnomalyConfig
from deepflow_tpu_torch.batch.schema import L4_SCHEMA
from deepflow_tpu_torch.models import flow_suite
from deepflow_tpu_torch.querier import QueryEngine
from deepflow_tpu_torch.querier.promql import PromEngine
from deepflow_tpu_torch.querier.sql import parse_sql
from deepflow_tpu_torch.runtime import tracing as ttracing
from deepflow_tpu_torch.runtime.faults import default_faults
from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter
from deepflow_tpu_torch.serving import AnomalyTables, SketchTables
from deepflow_tpu_torch.serving import SnapshotCache
from deepflow_tpu_torch.store import db as tdb
from deepflow_tpu_torch.store import dict_store as tdicts
from deepflow_tpu_torch.utils.u32 import fold_columns_np

SMALL = dict(cms_log2_width=12, ring_size=256, hll_groups=32,
             hll_precision=8, entropy_log2_buckets=8)
NOW = 5000.0                 # the caches' clock: past every window
WINDOWS = 6
RAMP_WINDOWS = 16


def zipf_window(rng, pool, n=6000):
    """n records of L4 columns over a pool of 5-tuples, ranks Zipf(1.1)."""
    ranks = np.minimum(rng.zipf(1.1, n) - 1, len(pool["ip_src"]) - 1)
    cols = {}
    for name, dt in L4_SCHEMA.columns:
        if name in pool:
            cols[name] = pool[name][ranks].astype(dt)
        else:
            cols[name] = rng.integers(0, 1 << 10, n).astype(dt)
    return cols


def _pool(rng, n=512):
    return {"ip_src": rng.integers(0, 1 << 30, n).astype(np.uint32),
            "ip_dst": rng.integers(0, 1 << 30, n).astype(np.uint32),
            "port_src": rng.integers(0, 1 << 16, n).astype(np.uint32),
            "port_dst": rng.integers(0, 1 << 16, n).astype(np.uint32),
            "proto": rng.integers(0, 255, n).astype(np.uint32)}


def _text(x):
    return json.dumps(x, sort_keys=True, default=lambda a: a.tolist())


def _both(pair, fn):
    """fn(tables) on the JAX and the port object: equal JSON text."""
    want, got = fn(pair[0]), fn(pair[1])
    assert _text(got) == _text(want)
    return got


SKETCH_SQL = [
    "SELECT sketch.topk(10) FROM sketch",
    "SELECT sketch.topk(300) FROM sketch WHERE time >= 1002",
    "SELECT sketch.cms_point({key}) FROM sketch WHERE time >= 1000 "
    "AND time < 1004",
    "SELECT sketch.hll_card() FROM sketch WHERE time >= 1000",
    "SELECT sketch.hll_card(3) FROM sketch",
    "SELECT sketch.entropy FROM sketch WHERE time > 1001 AND time <= 1004",
    "SELECT * FROM sketch WHERE time >= 1000",
    "SELECT sketch.topk(50) FROM sketch WHERE time >= 1000 LIMIT 20 "
    "OFFSET 5",
]


@pytest.fixture(scope="module")
def sketch_run(tmp_path_factory):
    """Both packages' tables after every window, and what each said."""
    ck = str(tmp_path_factory.mktemp("sketch_bus"))
    rng = np.random.default_rng(31)
    pool = _pool(rng)
    keys = fold_columns_np([pool[c] for c in ("ip_src", "ip_dst",
                                              "port_src", "port_dst",
                                              "proto")])
    exp = TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(**SMALL),
                            batch_rows=2048, window_seconds=3600,
                            checkpoint_dir=ck, wire="dict",
                            prefetch_depth=2, device="cpu")
    jtr, ttr = jtracing.Tracer(), ttracing.Tracer()
    jtr.enable()
    ttr.enable()
    port = SketchTables(SnapshotCache(exp.snapshot_bus, max_staleness_s=5.0,
                                      clock=lambda: NOW), tracer=ttr)
    jax_ = JTables(JCache(JBus(ck), max_staleness_s=5.0, clock=lambda: NOW),
                   tracer=jtr)
    pair = (jax_, port)
    seen = []
    try:
        for w in range(WINDOWS):
            exp.process([("l4_flow_log", 0, zipf_window(rng, pool), -1)])
            exp.flush_window(now=1000.0 + w)
            seen.append(_both(pair, lambda t: t.cms_point(int(keys[w]))))
            seen.append(_both(pair, lambda t: t.cms_points(keys)))
            seen.append(_both(pair, lambda t: t.hll_card()))
            seen.append(_both(pair, lambda t: t.hll_card(w)))
            seen.append(_both(pair, lambda t: t.topk(20)))
            seen.append(_both(pair, lambda t: t.entropy()))
    finally:
        exp.close()
    yield pair, keys, seen, (jtr, ttr)
    port.cache.close()
    jax_.cache.close()


def test_point_reads_after_every_window(sketch_run):
    _, _, seen, _ = sketch_run
    assert len(seen) == 6 * WINDOWS
    assert all(s is not None for s in seen)
    assert seen[-2] and seen[-2][0]["count"] > 0


@pytest.mark.parametrize("sql", SKETCH_SQL,
                         ids=[f"s{i}" for i in range(len(SKETCH_SQL))])
def test_sketch_sql_matches_jax(sketch_run, sql):
    pair, keys, _, _ = sketch_run
    sql = sql.format(key=int(keys[0]))
    got = _both((pair[0].sql(jparse(sql)), pair[1].sql(parse_sql(sql))),
                lambda r: r.as_dict())
    assert got["values"]


@pytest.mark.parametrize("fn,arg", [("sketch_topk", 5.0),
                                    ("sketch_cms_point", None),
                                    ("sketch_hll_card", None),
                                    ("sketch_hll_card", 2.0),
                                    ("sketch_entropy", None)])
def test_sketch_prom_series_matches_jax(sketch_run, fn, arg):
    pair, keys, _, _ = sketch_run
    if fn == "sketch_cms_point":
        arg = float(keys[1])
    grid = np.arange(995.0, 1400.0, 7.0)
    got = _both(pair, lambda t: t.prom_series(fn, arg, grid))
    assert got and not np.isnan(got[0][1]).all()


def test_sketch_through_both_engines(sketch_run, tmp_path):
    pair, keys, _, _ = sketch_run
    j = (JEngine(jdb.Store(str(tmp_path / "j")), jdicts.TagDictRegistry(None),
                 sketch=pair[0]),
         JProm(jdb.Store(str(tmp_path / "j")), jdicts.TagDictRegistry(None),
               sketch=pair[0]))
    t = (QueryEngine(tdb.Store(str(tmp_path / "t")),
                     tdicts.TagDictRegistry(None), sketch=pair[1],
                     device="cpu"),
         PromEngine(tdb.Store(str(tmp_path / "t")),
                    tdicts.TagDictRegistry(None), sketch=pair[1],
                    device="cpu"))
    for sql in ("SELECT sketch.topk(5) FROM sketch",
                f"SELECT sketch.cms_point({int(keys[2])}) FROM sketch"):
        assert _text(t[0].execute(sql).as_dict()) == \
            _text(j[0].execute(sql).as_dict())
    for q in ("sketch_topk(3)", "sketch_hll_card()",
              f"sketch_cms_point({int(keys[3])})",
              'sketch_entropy() > bool 0.5'):
        assert _text(t[1].query(q, at=1010)) == _text(j[1].query(q, at=1010))
        assert _text(t[1].query_range(q, 1000, 1010, 2)) == \
            _text(j[1].query_range(q, 1000, 1010, 2))


def test_sketch_refusals_match_jax(sketch_run):
    pair, _, _, _ = sketch_run
    for sql in ("SELECT sketch.nope(1) FROM sketch",
                "SELECT sketch.topk(1), sketch.hll_card() FROM sketch",
                "SELECT sketch.topk(1) FROM sketch WHERE ip = 3",
                "SELECT sketch.cms_point() FROM sketch"):
        with pytest.raises(ValueError) as je:
            pair[0].sql(jparse(sql))
        with pytest.raises(ValueError) as te:
            pair[1].sql(parse_sql(sql))
        assert str(te.value) == str(je.value)
    for t in pair:
        with pytest.raises(ValueError, match="out of range"):
            t.hll_card(10_000)


def test_staleness_counters_and_gauges(sketch_run):
    pair, _, _, (jtr, ttr) = sketch_run
    for t in pair:
        t._qps_t0 -= 1.0                 # the next read re-emits gauges
        t.topk(1)
    jc, tc = pair[0].counters(), pair[1].counters()
    for k in ("read_qps", "read_p50_s", "read_p99_s"):
        jc.pop(k), tc.pop(k)             # wall-clock latencies
    assert tc == jc
    assert tc["cache_staleness_s"] == NOW - (1000.0 + WINDOWS - 1)
    assert tc["cache_stale_served"] > 0 and tc["errors"] == 4
    assert pair[1].cache.staleness_s() == pair[0].cache.staleness_s()
    names = {"querier_read_qps", "querier_read_p99_s",
             "sketch_snapshot_staleness_s"}
    assert names <= set(ttr.gauges()) and names <= set(jtr.gauges())
    assert ttr.gauges()["querier_read_p99_s"] > 0
    assert ttr.gauges()["sketch_snapshot_staleness_s"] == \
        jtr.gauges()["sketch_snapshot_staleness_s"]
    assert _text(pair[1].datasources()) == _text(pair[0].datasources())


def test_tables_list_in_the_registry(sketch_run):
    from deepflow_tpu_torch.store import rollup
    _, port = sketch_run[0]
    port.register_datasource()
    try:
        rows = [r for r in rollup.external_datasources()
                if r.get("kind") == "sketch"]
        assert rows == port.datasources()
    finally:
        port.unregister_datasource()


# -- anomaly ---------------------------------------------------------------

ANOMALY_SQL = [
    "SELECT * FROM anomaly",
    "SELECT * FROM anomaly WHERE time >= 1000 AND time < 1016",
    "SELECT * FROM anomaly WHERE time >= 1008 LIMIT 5 OFFSET 2",
]
ANOMALY_PROM = [
    'anomaly_score{detector="entropy_ddos"}',
    "anomaly_alerts_total",
    "anomaly_active_flows",
    "max(anomaly_score) > 4",
    'anomaly_score{detector=~"pca.*|mp.*"}',
]


@pytest.fixture(scope="module")
def anomaly_run(tmp_path_factory):
    """The plane writes only alert windows to its directory; every window
    reaches subscribers. The JAX tables read a JAX bus that republishes
    each of the port bus's snapshots (same leaves, step, wall time and
    tags), in memory like the port's own."""
    default_faults().disarm()
    d = str(tmp_path_factory.mktemp("anomaly_bus"))
    exp = TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(), batch_rows=4096,
                            window_seconds=3600, wire="lanes", device="cpu",
                            anomaly=AnomalyConfig(), anomaly_dir=d)
    jbus = JBus(None, name="anomaly")
    exp.anomaly.bus.subscribe(lambda snap: jbus.publish(
        list(snap.leaves), snap.step, wall_time=snap.wall_time,
        tags=snap.tags, to_disk=False))
    port = AnomalyTables(SnapshotCache(exp.anomaly.bus, max_staleness_s=5.0,
                                       clock=lambda: NOW))
    jax_ = JAnomaly(JCache(jbus, max_staleness_s=5.0, clock=lambda: NOW))
    pair = (jax_, port)
    latest = []
    try:
        for w, _phase, cols in ddos_ramp(seed=7).windows():
            if w >= RAMP_WINDOWS:
                break
            exp.process([("l4_flow_log", 0, cols, -1)])
            exp.flush_window(now=1000.0 + w)
            latest.append(_both(pair, lambda t: t.sql(
                (jparse if t is jax_ else parse_sql)(
                    "SELECT * FROM anomaly")).as_dict()))
    finally:
        exp.close()
    yield pair, latest, d


def test_anomaly_alert_windows_from_the_directory(anomaly_run):
    """Both packages' tables over buses that read the plane's directory
    (its alert windows) answer alike."""
    from deepflow_tpu_torch.runtime.snapbus import SnapshotBus
    _, _, d = anomaly_run
    pair = (JAnomaly(JCache(JBus(d, name="anomaly"), clock=lambda: NOW)),
            AnomalyTables(SnapshotCache(SnapshotBus(d, name="anomaly"),
                                        clock=lambda: NOW)))
    got = _both((pair[0].sql(jparse("SELECT * FROM anomaly")),
                 pair[1].sql(parse_sql("SELECT * FROM anomaly"))),
                lambda r: r.as_dict())
    assert any(r[5] for r in got["values"])


def test_anomaly_latest_after_every_window(anomaly_run):
    _, latest, _ = anomaly_run
    assert len(latest) == RAMP_WINDOWS
    assert any(r[5] for snap in latest for r in snap["values"])


@pytest.mark.parametrize("sql", ANOMALY_SQL,
                         ids=[f"a{i}" for i in range(len(ANOMALY_SQL))])
def test_anomaly_sql_matches_jax(anomaly_run, sql):
    pair, _, _ = anomaly_run
    got = _both((pair[0].sql(jparse(sql)), pair[1].sql(parse_sql(sql))),
                lambda r: r.as_dict())
    assert got["values"]


@pytest.mark.parametrize("q", ANOMALY_PROM,
                         ids=[f"m{i}" for i in range(len(ANOMALY_PROM))])
def test_anomaly_promql_matches_jax(anomaly_run, tmp_path, q):
    pair, _, _ = anomaly_run
    j = JProm(jdb.Store(str(tmp_path / "j")), jdicts.TagDictRegistry(None),
              anomaly=pair[0])
    t = PromEngine(tdb.Store(str(tmp_path / "t")),
                   tdicts.TagDictRegistry(None), anomaly=pair[1],
                   device="cpu")
    got = _text(t.query(q, at=1012))
    assert got == _text(j.query(q, at=1012))
    assert _text(t.query_range(q, 1000, 1015, 1)) == \
        _text(j.query_range(q, 1000, 1015, 1))
    assert q == "max(anomaly_score) > 4" or got != "[]"


def test_anomaly_prom_instant_and_counters(anomaly_run):
    pair, _, _ = anomaly_run
    grid = np.arange(990.0, 1020.0, 1.5)
    for metric, matchers in (("anomaly_score", []),
                             ("anomaly_alerts_total",
                              [("detector", "=", "mp_discord")]),
                             ("anomaly_active_flows", [])):
        _both(pair, lambda t: t.prom_instant(metric, matchers, grid))
    with pytest.raises(ValueError) as je:
        pair[0].sql(jparse("SELECT score FROM anomaly"))
    with pytest.raises(ValueError) as te:
        pair[1].sql(parse_sql("SELECT score FROM anomaly"))
    assert str(te.value) == str(je.value)
    assert pair[1].counters() == pair[0].counters()
    assert _text(pair[1].datasources()) == _text(pair[0].datasources())


def test_view_refuses_a_foreign_layout(sketch_run):
    """The 9-leaf layout is checked against `convert.SUITE_LEAVES`: a
    leaf missing or of another dtype is refused, as a shape is in both
    packages."""
    import dataclasses

    from deepflow_tpu.serving.tables import _SketchView as JView
    from deepflow_tpu_torch.serving.tables import _SketchView
    snap = sketch_run[0][1].cache.latest()
    _SketchView(snap)
    short = dataclasses.replace(snap, leaves=snap.leaves[:8])
    for view in (_SketchView, JView):
        with pytest.raises(ValueError, match="9-leaf"):
            view(short)
    wide = list(snap.leaves)
    wide[0] = wide[0].astype(np.int64)
    with pytest.raises(ValueError, match="sketch.counts"):
        _SketchView(dataclasses.replace(snap, leaves=tuple(wide)))
    flat = list(snap.leaves)
    flat[0] = flat[0].reshape(-1)
    for view in (_SketchView, JView):
        with pytest.raises(ValueError, match="FlowSuiteState"):
            view(dataclasses.replace(snap, leaves=tuple(flat)))
