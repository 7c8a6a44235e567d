"""The port's incident recorder and watcher (runtime/incident.py) against
the JAX package's, on the CPU.

Both packages' watchers get the same seeded sequence of levels per tick
(breaker states, health, the accuracy alarm, the anomaly alert count,
fast-burning SLOs) with a pinned `now`, each over its own recorder (a
timeline of its own package fed the same samples, a StatsRegistry of its
own, the same fake snapshot buses). Compared: the edges fired, every
bundle's name, manifest keys and files, the trigger and timeline files
byte for byte, rate-limit suppressions and budget evictions. Each
package lists the other's bundles, and `SELECT * FROM incidents` answers
alike in both."""

import json
import os
import types

import numpy as np
import pytest

from deepflow_tpu.runtime import incident as jinc
from deepflow_tpu.runtime import timeline as jtl
from deepflow_tpu.runtime.stats import StatsRegistry as JStats
from deepflow_tpu_torch.runtime import incident as tinc
from deepflow_tpu_torch.runtime import timeline as ttl
from deepflow_tpu_torch.runtime.stats import StatsRegistry as TStats

T0 = 2_000_000.0


class _Bus:
    def __init__(self, step):
        self.step = step

    def latest(self):
        return types.SimpleNamespace(
            step=self.step, seq=self.step + 1, wall_time=T0,
            path=f"/snap/{self.step}", leaves=(np.zeros(3),) * 4,
            tags={"lossy": False})


class _Levels:
    """The watched surfaces, advanced by the test."""

    def __init__(self):
        self.breakers = {}
        self.health = {"ok": True, "accuracy_alarm": False}
        self.alerts = 0.0
        self.burning = []


def _levels_plan(seed, ticks):
    rng = np.random.default_rng(seed)
    plan = []
    brk = {"a": "closed", "b": "closed"}
    alerts = 0.0
    for _ in range(ticks):
        for name in brk:
            if rng.random() < 0.15:
                brk[name] = str(rng.choice(["closed", "open",
                                            "half_open"]))
        if rng.random() < 0.2:
            alerts += float(rng.integers(1, 3))
        plan.append({
            "breakers": {k: {"state": v} for k, v in brk.items()},
            "health": {"ok": bool(rng.random() < 0.7),
                       "accuracy_alarm": bool(rng.random() < 0.1)},
            "alerts": alerts,
            "burning": sorted(str(x) for x in rng.choice(
                ["ingest_availability", "serving_p99"],
                int(rng.integers(0, 3)), replace=False))})
    return plan


def _rig(inc, tl_mod, stats_cls, d, min_interval, budget):
    lv = _Levels()
    # counters.json carries the scrape's wall stamp, whose printed width
    # varies: the budget cases leave it out so bundle sizes compare
    stats = None
    if budget >= 1 << 20:
        stats = stats_cls()
        stats.register("receiver", lambda: {"rx_frames": 7, "mode": "tcp"})
    tl = tl_mod.Timeline(sample_s=1.0, hot_samples=32)
    tl.fast_burning = lambda now=None: list(lv.burning)
    rec = inc.IncidentRecorder(
        d, timeline=tl, stats=stats,
        snapbuses={"sketch": _Bus(4), "anomaly": _Bus(9)},
        budget_bytes=budget, min_interval_s=min_interval, window_s=30.0,
        clock=lambda: T0)
    w = inc.IncidentWatcher(rec, health_fn=lambda: dict(lv.health),
                            breakers_fn=lambda: dict(lv.breakers),
                            alerts_fn=lambda: lv.alerts, timeline=tl)
    return lv, tl, rec, w


def _run(inc, tl_mod, stats_cls, d, plan, min_interval, budget):
    lv, tl, rec, w = _rig(inc, tl_mod, stats_cls, d, min_interval, budget)
    fired = []
    orig = w._fire
    w._fire = lambda kind, detail, now: (fired.append((kind, now)),
                                         orig(kind, detail, now))
    for i, step in enumerate(plan):
        now = T0 + 5.0 * i
        tl.record("ingest_frames_per_s", float(i), now=now)
        lv.breakers = step["breakers"]
        lv.health = step["health"]
        lv.alerts = step["alerts"]
        lv.burning = step["burning"]
        w.tick(now)
    return fired, rec, w


@pytest.mark.parametrize("seed,min_interval,budget", [
    (1, 0.0, 64 << 20), (2, 12.0, 64 << 20), (3, 0.0, 6000),
    (4, 30.0, 3000)])
def test_watcher_and_recorder_equal(tmp_path, seed, min_interval, budget):
    plan = _levels_plan(seed, 40)
    dt, dj = str(tmp_path / "t"), str(tmp_path / "j")
    ft, rt, wt = _run(tinc, ttl, TStats, dt, plan, min_interval, budget)
    fj, rj, wj = _run(jinc, jtl, JStats, dj, plan, min_interval, budget)
    assert ft == fj and ft
    assert wt.counters() == wj.counters()
    assert wt.triggers == wj.triggers == len(ft)
    assert rt.counters() == rj.counters()
    if min_interval:
        assert rt.suppressed > 0
    if budget < (1 << 20):
        assert rt.bundles_evicted > 0
    mt, mj = rt.list(), rj.list()
    assert [m["id"] for m in mt] == [m["id"] for m in mj]
    for a, b in zip(mt, mj):
        assert sorted(a) == sorted(b)
        assert sorted(a["files"]) == sorted(b["files"])
        for key in ("version", "kind", "wall_time", "window", "detail"):
            assert a[key] == b[key]
        for f in ("trigger.json", "timeline.json", "snapbus.json"):
            with open(os.path.join(a["path"], f), "rb") as x, \
                    open(os.path.join(b["path"], f), "rb") as y:
                assert x.read() == y.read(), f
        if budget >= 1 << 20:
            with open(os.path.join(a["path"], "counters.json")) as x:
                counters = json.load(x)
            assert counters[0]["module"] == "receiver"
    # each package lists the other's bundles
    assert [m["id"] for m in jinc.IncidentRecorder(dt).list()] == \
        [m["id"] for m in mt]
    assert [m["id"] for m in tinc.IncidentRecorder(dj).list()] == \
        [m["id"] for m in mj]


def test_torn_manifest_counted_and_no_tmp_left(tmp_path):
    rec = tinc.IncidentRecorder(str(tmp_path), min_interval_s=0.0,
                                clock=lambda: T0)
    p = rec.capture("breaker_open", {"breaker": "x"})
    assert os.path.isdir(p)
    with open(os.path.join(p, "manifest.json"), "w") as f:
        f.write("{torn")
    assert rec.list() == [] and rec.manifest_errors == 1
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".")]


def test_sql_raises_and_registry_lists_incidents(tmp_path):
    """`SELECT * FROM incidents` answers as the JAX package's over the
    same bundles (each package's recorder over the other's directory
    too), and `register_datasource` lists the recorder."""
    from deepflow_tpu.querier.sql import parse_sql as jparse
    from deepflow_tpu_torch.querier.sql import parse_sql
    from deepflow_tpu_torch.store import rollup
    plan = _levels_plan(3, 40)
    dt, dj = str(tmp_path / "t"), str(tmp_path / "j")
    _, rt, _ = _run(tinc, ttl, TStats, dt, plan, 0.0, 6000)
    _, rj, _ = _run(jinc, jtl, JStats, dj, plan, 0.0, 6000)
    end = int(T0 + 5.0 * 40)
    for sql in ("SELECT * FROM incidents",
                f"SELECT * FROM incidents WHERE time >= {int(T0) + 50} "
                f"AND time < {end}",
                "SELECT * FROM incidents LIMIT 3 OFFSET 1"):
        want = rj.sql(jparse(sql))
        got = rt.sql(parse_sql(sql))
        assert got.columns == want.columns == tinc.INCIDENTS_SQL_COLUMNS
        assert got.values == want.values and got.values
        # either package's recorder over the other's bundles
        assert tinc.IncidentRecorder(dj).sql(parse_sql(sql)).values == \
            want.values
        assert jinc.IncidentRecorder(dt).sql(jparse(sql)).values == \
            got.values
    with pytest.raises(ValueError) as je:
        rj.sql(jparse("SELECT id FROM incidents"))
    with pytest.raises(ValueError) as te:
        rt.sql(parse_sql("SELECT id FROM incidents"))
    assert str(te.value) == str(je.value)
    rec = tinc.IncidentRecorder(str(tmp_path / "empty"))
    assert rec.sql(parse_sql("SELECT * FROM incidents")).values == []
    rec.register_datasource()
    try:
        rows = [r for r in rollup.external_datasources()
                if r.get("table") == tinc.INCIDENTS_TABLE]
        assert rows == rec.datasources()
    finally:
        rec.unregister_datasource()
