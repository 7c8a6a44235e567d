"""The port's flight recorder against the reference's, on the CPU.

- The same small ddos_ramp windows through the JAX exporter and the
  port's, both with their process tracer on, on the feed path (dict and
  lanes wires, zero-copy staging, the anomaly plane and the auditor on):
  the true totals `h2d_bytes`, `h2d_transfers` and `dispatches` are
  equal (both feeds copy one staged buffer and dispatch one program per
  group, and the staged words are equal), and so are the stage names
  and the gauge names each recorder holds afterwards, the per-program
  compile gauges included. Timings are not compared.
- The inline paths move different arrays, by design: the reference's
  inline lanes path copies the four lanes and the mask of every batch
  and dispatches once per batch, its inline dict path copies every plane
  of a batch's wire and dispatches once per plane; the port's inline
  paths stage the same words the feed stages, one buffer and one
  program per dispatch (a batch of the dict wire, `coalesce_batches`
  batches of the lanes wire). The test holds each package to its own
  rule and the rows to each other.
- `HostDDSketch` quantiles and cumulative buckets equal the reference's
  on the same samples; a disabled tracer allocates no span.
- `stats=` registers the same modules with a `StatsRegistry` as the
  reference's, and the registries read the same counters.
"""

import tracemalloc

import numpy as np
import pytest

from deepflow_tpu.models import flow_suite as jfs
from deepflow_tpu.replay.generator import ddos_ramp
from deepflow_tpu.runtime import profiler as jprofiler
from deepflow_tpu.runtime import stats as jstats
from deepflow_tpu.runtime import tpu_sketch as jts
from deepflow_tpu.runtime import tracing as jtracing
from deepflow_tpu_torch.models import flow_suite
from deepflow_tpu_torch.runtime import profiler, stats, tracing
from deepflow_tpu_torch.runtime.audit import AUDIT_GAUGES
from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter

_SMALL = dict(cms_log2_width=12, ring_size=256, hll_groups=64,
              hll_precision=8, entropy_log2_buckets=10)
B = 512
K = 2


@pytest.fixture
def tracers():
    """Both packages' process tracers on and empty, profilers empty; off
    again afterwards."""
    pair = (jtracing.default_tracer(), tracing.default_tracer())
    for tr in pair:
        tr.reset()
        tr.enable()
    jprofiler.default_profiler().reset()
    profiler.default_profiler().reset()
    yield pair
    for tr in pair:
        tr.disable()
        tr.reset()


def _windows(n=3, rows=1500, chunk=700):
    """ddos_ramp windows from the onset (news flows every window), as
    lists of unaligned chunks."""
    ramp = ddos_ramp(rows_per_window=rows)
    out = []
    for w in range(11, 11 + n):
        _, cols = ramp.window_cols(w)
        total = len(cols["ip_src"])
        out.append([{k: v[s:s + chunk] for k, v in cols.items()}
                    for s in range(0, total, chunk)])
    return out


def _pair(wire, feed, **kw):
    """The JAX exporter and the port's with the same knobs, every group
    attributed in detail (the sampling cadence set to 1 in both)."""
    jreg, treg = kw.pop("jstats", None), kw.pop("tstats", None)
    knobs = dict(wire=wire, coalesce_batches=K, **kw)
    if feed:
        knobs.update(prefetch_depth=2, zero_copy=True)
    jexp = jts.TpuSketchExporter(store=None, cfg=jfs.FlowSuiteConfig(
        **_SMALL), batch_rows=B, window_seconds=3600, stats=jreg, **knobs)
    texp = TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(**_SMALL),
                             batch_rows=B, window_seconds=3600, device="cpu",
                             stats=treg, **knobs)
    jexp._attrib_every = texp._attrib_every = 1
    return jexp, texp


def _drive(exps, windows):
    for chunks in windows:
        for exp in exps:
            for c in chunks:
                exp.process([("l4_flow_log", 0, c, -1)])
            exp.flush_window(now=1000.0)


TOTALS = ("h2d_bytes", "h2d_transfers", "dispatches", "rows_in")


@pytest.mark.parametrize("wire", ["dict", "lanes"])
def test_feed_totals_stages_and_gauges_match_jax(tracers, wire):
    jtr, ttr = tracers
    jexp, texp = _pair(wire, True, anomaly=True, audit_rate=1.0)
    try:
        _drive((jexp, texp), _windows())
        jc, tc = jexp.counters(), texp.counters()
    finally:
        jexp.close()
        texp.close()
    assert {k: tc[k] for k in TOTALS} == {k: jc[k] for k in TOTALS}
    assert tc["dispatches"] == tc["h2d_transfers"] > 0
    stages = set(ttr.latency())
    assert stages == set(jtr.latency())
    assert {"kernel", "kernel.h2d", "kernel.dispatch", "kernel.device",
            "kernel.compile", "window"} <= stages
    gauges = set(ttr.gauges())
    assert gauges == set(jtr.gauges())
    assert {"tpu_h2d_mb_s", "tpu_transfers_per_batch",
            "tpu_h2d_coalesced_bytes", "anomaly_score",
            "anomaly_alerts_total", "anomaly_detect_latency_windows",
            "anomaly_active_flows", "tpu_audit_sampled_keys",
            "tpu_audit_degraded_window"} <= gauges
    assert any(g.startswith("tpu_compile_s_" + ("dict:" if wire == "dict"
                                                else "lanes_x"))
               for g in gauges)
    assert set(g for g in gauges if g.startswith("tpu_audit_")) \
        <= set(AUDIT_GAUGES)
    for g in gauges:
        assert tracing.gauge_help(g), g
    busy = profiler.default_profiler().gauges()["tpu_device_busy_fraction"]
    assert 0.0 < busy <= 1.0


@pytest.mark.parametrize("wire", ["dict", "lanes"])
def test_inline_totals_follow_each_package_rule(tracers, wire):
    """Rows equal; the reference copies every lane and mask (lanes) or
    every plane (dict) and dispatches per batch or per plane; the port
    copies one staged buffer per dispatch."""
    jexp, texp = _pair(wire, False)
    windows = _windows()
    try:
        _drive((jexp, texp), windows)
        jc, tc = jexp.counters(), texp.counters()
    finally:
        jexp.close()
        texp.close()
    assert tc["rows_in"] == jc["rows_in"]
    assert tc["batches"] == jc["batches"]
    assert tc["h2d_transfers"] == tc["dispatches"]
    if wire == "lanes":
        assert jc["h2d_transfers"] == 5 * jc["batches"]
        assert jc["dispatches"] == jc["batches"]
        # K slots a dispatch; the open slots ship at each window close
        batches = [-(-sum(len(c["ip_src"]) for c in w) // B)
                   for w in windows]
        assert sum(batches) == tc["batches"]
        assert tc["dispatches"] == sum(-(-b // K) for b in batches)
    else:
        assert jc["h2d_transfers"] == jc["dispatches"] > jc["batches"]
        assert tc["dispatches"] == tc["batches"]
        assert tc["h2d_bytes"] > jc["h2d_bytes"]   # + one count word a plane
    assert {"kernel.h2d", "kernel.compile", "kernel.dispatch",
            "kernel.device"} <= set(tracers[1].latency())


def test_host_ddsketch_matches_the_reference():
    rng = np.random.default_rng(5)
    samples = np.concatenate([rng.lognormal(np.log(2e-3), 1.5, 5000),
                              [0.0, 1e-9, 5e-7, 1e3]]).tolist()
    ours, ref = tracing.HostDDSketch(), jtracing.HostDDSketch()
    for v in samples:
        ours.add(v)
        ref.add(v)
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0):
        assert ours.quantile(q) == ref.quantile(q), q
    assert ours.cumulative_buckets(16) == ref.cumulative_buckets(16)
    other, jother = tracing.HostDDSketch(), jtracing.HostDDSketch()
    for v in samples[:100]:
        other.add(v)
        jother.add(v)
    ours.merge(other)
    ref.merge(jother)
    assert ours.snapshot() == ref.snapshot()
    assert (ours.count, ours.zeros, ours.max) == (ref.count, ref.zeros,
                                                   ref.max)


def test_disabled_tracer_allocates_no_span():
    tr = tracing.Tracer()
    assert not tr.enabled
    assert tr.span("a") is tr.span("b", stream="s", rows=3)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(10_000):
            with tr.span("kernel", stream="dict"):
                pass
            tr.observe("kernel.h2d", 1e-3)
            tr.gauge("tpu_h2d_mb_s", 1.0)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = [tracemalloc.Filter(True, tracing.__file__)]
    diff = after.filter_traces(mine).compare_to(
        before.filter_traces(mine), "lineno")
    assert sum(d.size_diff for d in diff) == 0
    assert tr.spans_recorded == 0 and tr.gauges() == {}


def test_stats_registry_reads_the_same_counters():
    """`stats=` on both exporters (the auditor and the anomaly plane
    on): the same modules register, and the conservation counters, the
    auditor's and the plane's ledgers read the same."""
    jreg, treg = jstats.StatsRegistry(), stats.StatsRegistry()
    jexp, texp = _pair("dict", True, anomaly=True, audit_rate=1.0,
                       jstats=jreg, tstats=treg)
    try:
        _drive((jexp, texp), _windows(n=2))
        jsamples = {s.module: s.values for s in jreg.collect()}
        tsamples = {s.module: s.values for s in treg.collect()}
    finally:
        jexp.close()
        texp.close()
    assert set(tsamples) == set(jsamples) == {
        "exporter.tpu_sketch", "tpu_sketch_accuracy", "anomaly"}
    for k in ("rows_in", "windows", "h2d_bytes", "h2d_transfers",
              "dispatches", "batches", "lost_rows", "degraded"):
        assert tsamples["exporter.tpu_sketch"][k] == \
            jsamples["exporter.tpu_sketch"][k], k
    assert tsamples["tpu_sketch_accuracy"] == jsamples["tpu_sketch_accuracy"]
    for k in ("rows_seen", "windows", "windows_unscored", "alerts_total",
              "table_offers", "active_flows"):
        assert tsamples["anomaly"][k] == jsamples["anomaly"][k], k
    assert len(treg.history()) == 3


def test_sharded_suite_spans_match_jax(tracers):
    """The sharded flow suite on 8 shards beside the JAX suite on the 8
    CPU devices, both tracers on: the same stage names (the sampled
    `shard.h2d` put, `shard.update`, `shard.flush`), the same gauge names
    (`mesh_h2d_mb_s`) and the same profiler dispatch record."""
    from deepflow_tpu.parallel import sharded as jsh
    from deepflow_tpu.parallel.mesh import make_mesh as jmake_mesh
    from deepflow_tpu_torch.parallel import ShardedFlowSuite, make_mesh

    jtr, ttr = tracers
    jsuite = jsh.ShardedFlowSuite(jfs.FlowSuiteConfig(**_SMALL),
                                  jmake_mesh(8))
    tsuite = ShardedFlowSuite(flow_suite.FlowSuiteConfig(**_SMALL),
                              make_mesh(8, device="cpu"))
    rng = np.random.default_rng(3)
    js, ts = jsuite.init(), tsuite.init()
    for _ in range(3):
        cols = {k: rng.integers(0, 1 << 16, 1024).astype(np.uint32)
                for k in ("ip_src", "ip_dst", "port_src", "port_dst",
                          "proto", "packet_tx", "packet_rx")}
        mask = np.ones(1024, bool)
        js = jsuite.update(js, *jsuite.put_batch(cols, mask))
        ts = tsuite.update(ts, *tsuite.put_batch(cols, mask))
    jsuite.flush(js)
    tsuite.flush(ts)
    assert set(ttr.latency()) == set(jtr.latency()) == {
        "shard.h2d", "shard.update", "shard.flush"}
    assert ttr.latency()["shard.update"]["count"] == 3
    assert ttr.latency()["shard.h2d"]["count"] == 1     # 1 put in 16
    assert set(ttr.gauges()) == set(jtr.gauges()) == {"mesh_h2d_mb_s"}
    names = {e["name"] for e in profiler.default_profiler()
             .to_chrome_trace()["traceEvents"] if e["ph"] == "X"}
    jnames = {e["name"] for e in jprofiler.default_profiler()
              .to_chrome_trace()["traceEvents"] if e["ph"] == "X"}
    assert names == jnames == {"shard:ShardedFlowSuite"}
