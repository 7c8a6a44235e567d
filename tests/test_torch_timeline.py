"""The port's self-telemetry timeline (runtime/timeline.py) against the
JAX package's, on the CPU.

Both timelines get the same seeded sequence through `sample_once(now=)`:
Countables in a StatsRegistry of each package (monotonic counters with
tags, a bool and a string that are skipped), tracer gauges with their
wall stamps set on the fake clock (some of them fossils), profiler
gauges, two recording rules and both SLO kinds. Compared, per series:
hot and coarse rings (stamps exactly, values at rtol 1e-6), overwrite
counts; then the counters, the burn-rate gauges, `fast_burning`,
`stale_gauges` and `window`. The querier datasources (`prom_fetch`,
`_match`, `sql`, and PromQL through both packages' engines) answer as
the JAX package's."""

import time

import numpy as np
import pytest

from deepflow_tpu.runtime import timeline as jtl
from deepflow_tpu.runtime.stats import StatsRegistry as JStats
from deepflow_tpu.runtime.tracing import Tracer as JTracer
from deepflow_tpu_torch.runtime import timeline as ttl
from deepflow_tpu_torch.runtime.stats import StatsRegistry as TStats
from deepflow_tpu_torch.runtime.supervisor import Supervisor
from deepflow_tpu_torch.runtime.tracing import Tracer as TTracer
from deepflow_tpu_torch.store import rollup as trollup

RTOL = 1e-6
T0 = 1_000_000.0


class _Prof:
    """A profiler surface with gauges set per tick."""

    def __init__(self):
        self.values = {}

    def gauges(self):
        return dict(self.values)


def _plan(seed, ticks):
    """Per tick: counter increments, gauge values and stamp ages,
    profiler gauges."""
    rng = np.random.default_rng(seed)
    out = []
    frames = shed = rows = 0
    for i in range(ticks):
        frames += int(rng.integers(50, 150))
        rows += int(rng.integers(1000, 5000))
        # counted loss from tick ticks // 2 on: the ratio SLO burns
        if i >= ticks // 2:
            shed += int(rng.integers(2, 9))
        out.append({
            "receiver": {"rx_frames": frames, "rx_dropped": 0,
                         "mode": "tcp", "live": True},
            "exporters": {"put_errors": 0, "shed": shed},
            "exporter.tpu_sketch": {"rows_in": rows,
                                    "h2d_bytes": rows * 16.5},
            "gauges": {"querier_read_p99_s": float(rng.uniform(0.0, 0.1)),
                       "tpu_h2d_mb_s": float(rng.uniform(100, 900)),
                       "fossil": 1.0},
            # the fossil's stamp stops moving at tick 3
            "ages": {"querier_read_p99_s": float(rng.uniform(0, 2)),
                     "tpu_h2d_mb_s": 0.0,
                     "fossil": 0.0 if i < 3 else float(i - 2) * 4.0},
            "prof": {"tpu_device_busy_fraction": float(rng.uniform(0, 1)),
                     "tpu_feed_stall_seconds": float(i) * 0.01},
        })
    return out


def _build(mod, stats_cls, tracer_cls, hot, coarse):
    state = {}
    stats = stats_cls()
    for module in ("receiver", "exporters", "exporter.tpu_sketch"):
        stats.register(module, (lambda m: lambda: state["tick"][m])(module),
                       tags={"host": "a"} if module == "receiver" else None)
    tracer = tracer_cls()
    tracer.enable()
    prof = _Prof()
    tl = mod.Timeline(sample_s=1.0, hot_samples=hot, coarse_every=coarse,
                      stats=stats, tracer=tracer, profiler=prof,
                      fast_burn_threshold=14.4, clock=lambda: T0)
    rate_win = 10.0

    def per_s(metric):
        return lambda t, now: t._window_delta(metric, now - rate_win,
                                              now) / rate_win

    tl.add_rule(mod.RecordingRule("ingest_frames_per_s",
                                  per_s("receiver_rx_frames")))
    tl.add_rule(mod.RecordingRule("sketch_rows_per_s",
                                  per_s("tpu_sketch_rows_in"),
                                  labels={"lane": "l4"}))
    tl.add_slo(mod.SloRule("ingest_availability", objective=0.999,
                           kind="ratio",
                           bad=("receiver_rx_dropped",
                                "exporters_put_errors", "exporters_shed"),
                           total=("receiver_rx_frames",)))
    tl.add_slo(mod.SloRule("serving_p99", objective=0.99,
                           kind="threshold", series="querier_read_p99_s",
                           bound=0.05))
    return tl, state, tracer, prof


def _drive(built, plan):
    tl, state, tracer, prof = built
    for i, tick in enumerate(plan):
        now = T0 + i
        state["tick"] = tick
        for name, value in tick["gauges"].items():
            tracer.gauge(name, value)
            tracer._gauge_stamps[name] = now - tick["ages"][name]
        prof.values = tick["prof"]
        tl.sample_once(now=now)
    return tl


def _series(tl):
    out = {}
    for (name, labels), ring in tl._series.items():
        ts, vs = ring.samples()
        cts, cvs = ring._tier(ring.cts, ring.cvs, ring.cn, ring.ccap)
        out[(name, labels)] = (ts, vs, cts, cvs, ring.overwritten,
                               ring.coarse_overwritten, ring.n, ring.cn)
    return out


@pytest.mark.parametrize("hot,coarse,ticks", [
    (8, 0, 40), (8, 3, 60), (16, 4, 120), (600, 10, 90)])
def test_timeline_equal(hot, coarse, ticks):
    plan = _plan(hot * 7 + coarse, ticks)
    t = _drive(_build(ttl, TStats, TTracer, hot, coarse), plan)
    j = _drive(_build(jtl, JStats, JTracer, hot, coarse), plan)
    ts_, js_ = _series(t), _series(j)
    assert sorted(ts_) == sorted(js_)
    for key in ts_:
        a, b = ts_[key], js_[key]
        np.testing.assert_array_equal(a[0], b[0], err_msg=str(key))
        np.testing.assert_allclose(a[1], b[1], rtol=RTOL, err_msg=str(key))
        np.testing.assert_array_equal(a[2], b[2], err_msg=str(key))
        np.testing.assert_allclose(a[3], b[3], rtol=RTOL, err_msg=str(key))
        assert a[4:] == b[4:], key
    assert t.counters() == j.counters()
    tg = sorted((sorted(lb.items()), v) for lb, v in t.slo_gauges())
    jg = sorted((sorted(lb.items()), v) for lb, v in j.slo_gauges())
    assert [lb for lb, _ in tg] == [lb for lb, _ in jg]
    np.testing.assert_allclose([v for _, v in tg], [v for _, v in jg],
                               rtol=RTOL)
    now = T0 + ticks - 1
    assert t.fast_burning(now) == j.fast_burning(now)
    assert "ingest_availability" in t.fast_burning(now)
    assert t.stale_gauges() == j.stale_gauges()
    assert set(t.stale_gauges()) == {"fossil"}
    assert t.stale_skipped == j.stale_skipped > 0
    for lo, hi in ((T0, T0 + 5), (T0 + ticks - 20, now + 1.0)):
        tw, jw = t.window(lo, hi), j.window(lo, hi)
        assert [(s["metric"], s["labels"], s["ts"]) for s in tw] == \
            [(s["metric"], s["labels"], s["ts"]) for s in jw]
        for a, b in zip(tw, jw):
            np.testing.assert_allclose(a["values"], b["values"], rtol=RTOL)
    # the burn of each window against the rule's own arithmetic
    for slo_t, slo_j in zip(t._slos, j._slos):
        for win in (jtl.SLO_FAST_WINDOW_S, jtl.SLO_SLOW_WINDOW_S, 20.0):
            np.testing.assert_allclose(slo_t.burn(t, now, win),
                                       slo_j.burn(j, now, win), rtol=RTOL)


def test_threshold_slo_and_rules_fire():
    plan = _plan(3, 30)
    t = _drive(_build(ttl, TStats, TTracer, 64, 0), plan)
    gauges = {(lb["slo"], lb["window"]): v for lb, v in t.slo_gauges()}
    p99 = np.array([p["gauges"]["querier_read_p99_s"] for p in plan])
    fresh = np.array([p["ages"]["querier_read_p99_s"] for p in plan]) \
        <= t.stale_after_s
    frac = np.count_nonzero(p99[fresh] > 0.05) / np.count_nonzero(fresh)
    np.testing.assert_allclose(gauges[("serving_p99", "fast")],
                               frac / 0.01, rtol=RTOL)
    _, v = t._rings_of("ingest_frames_per_s")[0].last
    want = (plan[-1]["receiver"]["rx_frames"]
            - plan[-11]["receiver"]["rx_frames"]) / 10.0
    np.testing.assert_allclose(v, want, rtol=RTOL)


def _driven_pair():
    plan = _plan(5, 40)
    return (_drive(_build(jtl, JStats, JTracer, 16, 4), plan),
            _drive(_build(ttl, TStats, TTracer, 16, 4), plan))


PROM_FETCHES = [
    ("tpu_sketch_rows_in", [], T0, T0 + 40),
    ("receiver_rx_frames", [("host", "=", "a")], T0 + 3, T0 + 30),
    ("receiver_rx_frames", [("host", "!~", "a.*")], T0, T0 + 40),
    ("sketch_rows_per_s", [("lane", "=~", "l[0-9]")], T0 + 10, T0 + 40),
    ("tpu_device_busy_fraction", [], T0, T0 + 12),
    ("querier_read_p99_s", [("__name__", "=", "querier_read_p99_s")],
     T0, T0 + 40),
    ("no_such_series", [], T0, T0 + 40),
]


def test_querier_datasources_raise_and_registry_lists_the_timeline():
    """The querier datasources (`prom_fetch`, `_match`, `sql`) answer as
    the JAX package's on the same samples, and `register_datasource`
    lists the timeline in the registry."""
    from deepflow_tpu.querier.sql import parse_sql as jparse
    from deepflow_tpu_torch.querier.sql import parse_sql
    j, t = _driven_pair()
    for metric, matchers, lo, hi in PROM_FETCHES:
        want = j.prom_fetch(metric, matchers, lo, hi)
        got = t.prom_fetch(metric, matchers, lo, hi)
        assert [g[0] for g in got] == [w[0] for w in want]
        for (_, gts, gvs), (_, wts, wvs) in zip(got, want):
            assert gts.dtype == wts.dtype == np.int64
            assert gvs.dtype == wvs.dtype == np.float64
            np.testing.assert_array_equal(gts, wts)
            np.testing.assert_array_equal(gvs, wvs)
    labels = {"__name__": "receiver_rx_frames", "host": "ab"}
    for m in ([], [("host", "=", "ab")], [("host", "!=", "ab")],
              [("host", "=~", "a.")], [("host", "!~", "a")],
              [("zone", "=", "")], [("zone", "!=", "")]):
        assert t._match(labels, m) == j._match(labels, m)
    assert t._match(labels, None) is j._match(labels, None) is True
    for sql in ("SELECT * FROM timeline",
                f"SELECT * FROM timeline WHERE time >= {T0 + 20:.0f} "
                f"AND time < {T0 + 30:.0f}",
                "SELECT * FROM timeline LIMIT 25 OFFSET 40"):
        want, got = j.sql(jparse(sql)), t.sql(parse_sql(sql))
        assert got.columns == want.columns == ttl.TIMELINE_SQL_COLUMNS
        assert got.values == want.values and got.values
    assert {r[4] for r in t.sql(parse_sql("SELECT * FROM timeline"))
            .values} == {"hot", "coarse"}
    with pytest.raises(ValueError) as je:
        j.sql(jparse("SELECT value FROM timeline"))
    with pytest.raises(ValueError) as te:
        t.sql(parse_sql("SELECT value FROM timeline"))
    assert str(te.value) == str(je.value)
    tl = ttl.Timeline(sample_s=1.0)
    tl.register_datasource()
    try:
        rows = [r for r in trollup.external_datasources()
                if r.get("table") == ttl.TIMELINE_TABLE]
        assert rows == tl.datasources()
        assert rows[0]["kind"] == "timeline" and rows[0]["sample_s"] == 1.0
    finally:
        tl.unregister_datasource()
    assert not [r for r in trollup.external_datasources()
                if r.get("table") == ttl.TIMELINE_TABLE]


@pytest.mark.parametrize("q", [
    "rate(receiver_rx_frames[10s])", "tpu_sketch_rows_in",
    'sketch_rows_per_s{lane="l4"}', "max_over_time(tpu_h2d_mb_s[20s])",
    "querier_read_p99_s > bool 0.05"])
def test_timeline_through_both_prom_engines(tmp_path, q):
    """PromQL selectors over timeline-carried metrics answer from the
    rings in both packages' engines alike."""
    import json

    from deepflow_tpu.querier.promql import PromEngine as JProm
    from deepflow_tpu.store import db as jdb
    from deepflow_tpu.store import dict_store as jdicts
    from deepflow_tpu_torch.querier.promql import PromEngine
    from deepflow_tpu_torch.store import db as tdb
    from deepflow_tpu_torch.store import dict_store as tdicts
    j, t = _driven_pair()
    je = JProm(jdb.Store(str(tmp_path / "j")), jdicts.TagDictRegistry(None),
               timeline=j)
    te = PromEngine(tdb.Store(str(tmp_path / "t")),
                    tdicts.TagDictRegistry(None), timeline=t, device="cpu")
    for fn, args in (("query", (q, int(T0) + 35)),
                     ("query_range", (q, int(T0) + 10, int(T0) + 39, 3))):
        want = getattr(je, fn)(*args)
        got = getattr(te, fn)(*args)
        assert want and json.dumps(got, sort_keys=True) == \
            json.dumps(want, sort_keys=True)


def test_sampler_runs_on_the_supervisor():
    sup = Supervisor()
    stats = TStats()
    stats.register("receiver", lambda: {"rx_frames": 1})
    tl = ttl.Timeline(sample_s=0.05, stats=stats)
    tl.start(sup)
    try:
        deadline = time.monotonic() + 10
        while tl.ticks < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        tl.stop()
        sup.close()
    assert tl.ticks >= 3
    assert tl.counters()["series"] == 1
    assert "timeline-sampler" in {t["name"] for t in sup.threads()}
