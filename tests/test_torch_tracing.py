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


# -- the device-busy measure (gated samples, runtime/profiler.py) ---------

def test_busy_estimator_scales_caps_and_counts():
    """A group's device time is the sum of the newest gated sample of
    each of its programs (a key fixes its planes' widths, so the rows do
    not scale it), capped at its dispatch -> fence interval; a program
    not sampled yet borrows its family's newest sample, counted, and
    with none in its family the group gives the interval itself,
    counted; timed-out samples are counted and change nothing."""
    est = profiler.BusyEstimator()
    est.sample("dict:n8192", 0.002)
    est.sample("lanes_x2", 0.0005)
    est.timed_out("dict:n8192")
    assert est.estimate(["dict:n8192"], 0.01) == pytest.approx(0.002)
    assert est.estimate(["dict:n8192", "lanes_x2"], 0.01) == \
        pytest.approx(0.0025)
    assert est.estimate(["dict:n8192", "lanes_x2"], 0.001) == 0.001
    assert est.estimate(["dict:n8192", "anomaly:h16384"], 0.007) == 0.007
    # an unsampled program of a sampled family borrows its sample
    assert est.estimate(["dict:h16384"], 1.0) == pytest.approx(0.002)
    # the newest sample of a key replaces the older one (and its family's)
    est.sample("dict:n8192", 0.004)
    assert est.estimate(["dict:n8192"], 1.0) == pytest.approx(0.004)
    assert est.estimate(["dict:n16384"], 1.0) == pytest.approx(0.004)
    assert est.has("dict:n8192") and not est.has("dict:n16384")
    assert est.counters() == {"busy_samples": 3,
                              "busy_samples_timed_out": 1,
                              "busy_groups_estimated": 4,
                              "busy_groups_borrowed": 2,
                              "busy_groups_ungated": 1}


def test_feed_device_spans_from_the_estimator(tracers):
    """The feed sizes each fenced group's `device` span from the
    estimator (fences injected: an object with a `synchronize` that
    waits a set time): a sampled program gives its sample, capped at
    dispatch -> fence; a program with no sample in its family, and a
    host-path group (no fence), the interval. The release runs before
    the estimate, so a group's own gated sample sizes its span."""
    import time
    from deepflow_tpu_torch.runtime.feed import DeviceFeed, InFlight
    est = profiler.BusyEstimator()

    class Fence:
        def synchronize(self):
            time.sleep(0.02)

    plan = {0: ("p", 0.001), 1: ("p", None), 2: ("p", 5.0),
            3: ("q", None), 4: (None, None)}

    def process(group):
        (i, _), = group
        key, sample = plan[i]
        release = None if sample is None else \
            (lambda: est.sample(key, sample))
        if key is None:
            return InFlight(None, 100)
        return InFlight(Fence(), 100, release, [key])

    prof = profiler.default_profiler()
    feed = DeviceFeed("busy-feed", process, depth=1, estimator=est)
    try:
        for i in range(5):
            feed.put(i)
        assert feed.drain(10)
    finally:
        feed.close()
    spans = [s for s in prof._snapshot() if s[0] == "device"]
    durs = [s[3] for s in spans]
    assert len(durs) == 5
    assert durs[0] == pytest.approx(0.001)
    assert durs[1] == pytest.approx(0.001)
    assert 0.015 < durs[2] < 1.0          # capped at dispatch -> fence
    assert durs[3] > 0.015                # no sample in its family
    assert durs[4] > 0                    # no fence: the interval
    assert est.counters()["busy_groups_ungated"] == 1
    assert est.counters()["busy_groups_estimated"] == 3


class _Ev:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class _Gate:
    """A gate whose verdicts the test sets per ticket."""

    def __init__(self, verdicts):
        self.verdicts = verdicts

    def verdict(self, ticket):
        return self.verdicts[ticket]


def test_gated_attribution_discards_timed_out_samples(tracers):
    """A warm attributed call read with its gate's verdict (events and
    gate injected): opened by the host, its event time is
    `kernel.device` and a sample; released by the timeout, it is
    discarded and counted (`busy_samples_timed_out`), and a program
    whose gate timed out twice is not gated again; an ungated warm call
    on the card times nothing."""
    _, tr = tracers
    exp = TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(**_SMALL),
                            batch_rows=B, window_seconds=3600, device="cpu")
    try:
        exp._gate = _Gate({1: True, 2: False, 3: None})
        exp._busy = profiler.BusyEstimator()
        ev = (_Ev(0.0), _Ev(0.0025))
        exp._read_attribution([("dict:n8", False, 64, 0.03, ev, None, 1)])
        lat = tr.latency()
        assert lat["kernel.device"]["count"] == 1
        assert lat["kernel.device"]["p50_ms"] == pytest.approx(2.5, rel=0.02)
        assert exp._busy.estimate(["dict:n8"], 1.0) == \
            pytest.approx(0.0025)
        for ticket in (2, 3):
            exp._read_attribution([("dict:n8", False, 64, 0.03, ev, None,
                                    ticket)])
        exp._read_attribution([("dict:n8", False, 64, 0.03, ev, None,
                                None)])
        assert tr.latency()["kernel.device"]["count"] == 1
        c = exp._busy.counters()
        assert c["busy_samples"] == 1 and c["busy_samples_timed_out"] == 2
        assert exp._gate_timeouts == {"dict:n8": 2}
    finally:
        exp.close()
