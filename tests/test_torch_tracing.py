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
- The port's always-on stages: written with the tracer off, summing to
  their whole close and worker call on CPU runs of both exporters,
  counting a held state lock, and exported onto a `torch.profiler`
  trace's timebase.
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
    # the port's own always-on stages (enabled, they feed the sketches
    # too) besides the reference's
    own = {s for s in stages if s.startswith("l4.")}
    assert {"l4.coerce", "l4.keymap", "l4.lock_wait", "l4.pack",
            "l4.feed_put", "l4.audit", "l4.dispatch", "l4.close",
            "l4.close.lock_wait", "l4.close.drain",
            "l4.close.readout"} <= own
    stages -= own
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
    events = profiler.default_profiler().to_chrome_trace()["traceEvents"]
    names = {e["name"] for e in events if e["ph"] == "X" and e["pid"] == 1}
    jnames = {e["name"] for e in jprofiler.default_profiler()
              .to_chrome_trace()["traceEvents"] if e["ph"] == "X"}
    assert names == jnames == {"shard:ShardedFlowSuite"}
    # the port's export also lays the tracer's spans out by thread
    assert {e["name"] for e in events if e["ph"] == "X"
            and e["pid"] == 2} == {"shard.h2d", "shard.update",
                                   "shard.flush"}


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


# -- the always-on stages (the port's own) --------------------------------

def test_stages_are_recorded_with_the_tracer_disabled():
    """A stage adds to its stream's totals and writes a ring entry with
    its thread's name and wall-clock start, the tracer off; no latency
    sketch is made, and `span()` stays the shared no-op."""
    import threading
    import time
    tr = tracing.Tracer()
    assert not tr.enabled
    w0 = time.time()
    t0 = time.perf_counter()
    tr.stage("l4.pack", t0, t0 + 0.25, rows=4096, stream="tpu_sketch")

    def other():
        t = time.perf_counter()
        tr.stage("l4.pack", t - 0.5, t, rows=10, stream="tpu_sketch")
        tr.stage("red.cut", t - 0.125, t, stream="app_red")

    th = threading.Thread(target=other, name="stage-writer")
    th.start()
    th.join()
    assert tr.stage_counters("tpu_sketch") == {
        "l4_pack_count": 2, "l4_pack_sum_s": pytest.approx(0.75)}
    assert tr.stage_counters("app_red") == {
        "red_cut_count": 1, "red_cut_sum_s": pytest.approx(0.125)}
    assert tr.stage_counters("nothing") == {}
    assert tr.spans_recorded == 3 and tr.latency() == {}
    first, second, third = tr.ring()
    assert first[:3] == ("l4.pack", "tpu_sketch", -1)
    assert first[3] == pytest.approx(w0, abs=0.05)
    assert first[4:] == (pytest.approx(0.25), 4096,
                         threading.current_thread().name)
    assert second[6] == third[6] == "stage-writer"
    assert second[3] == pytest.approx(time.time() - 0.5, abs=1.0)
    assert [s["thread"] for s in tr.recent(2)] == ["stage-writer"] * 2
    assert tr.span("l4.pack") is tr.span("export")
    tr.enable()
    tr.stage("l4.pack", t0, t0 + 0.01, stream="tpu_sketch")
    assert tr.latency()["l4.pack"]["count"] == 1
    assert tr.stage_counters("tpu_sketch")["l4_pack_count"] == 3


def test_stage_totals_hold_under_racing_threads():
    """More writers than cores, switching every microsecond, on one
    stage: no add is lost (metrics read the totals)."""
    import os
    import sys
    import threading
    tr = tracing.Tracer(ring=64)
    n, per = 2 * (os.cpu_count() or 4) + 2, 2000

    def write():
        for _ in range(per):
            tr.stage("export", 0.0, 0.5, stream="x")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=write) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert tr.stage_counters("x") == {"export_count": n * per,
                                      "export_sum_s": 0.5 * n * per}


def _l4_chunks(rng, n, rows=4096):
    names = ("ip_src", "ip_dst", "port_src", "port_dst", "proto",
             "packet_tx", "packet_rx", "byte_tx", "byte_rx")
    return [{k: rng.integers(0, 1 << 12, rows).astype(np.uint32)
             for k in names} for _ in range(n)]


def _wait_processed(exp, n, timeout=60.0):
    import time
    deadline = time.perf_counter() + timeout
    while exp.processed < n and time.perf_counter() < deadline:
        time.sleep(0.005)
    assert exp.processed == n


def _parts(c, whole, parts):
    return sum(c.get(f"{p}_sum_s", 0.0) for p in parts), c[f"{whole}_sum_s"]


L4_WORKER = ("l4_coerce", "l4_keymap", "l4_lock_wait", "l4_pack",
             "l4_feed_put", "l4_audit")
L4_CLOSE = tuple(f"l4_close_{p}" for p in (
    "lock_wait", "drain", "snapshot_copy", "snapshot_write", "readout",
    "store"))


def test_l4_stages_sum_to_the_close_and_the_worker(tmp_path):
    """The benchmark's l4 exporter on the CPU (dict wire, zero-copy
    staging, the feed, the auditor at 1/64, a Store, a snapshot every
    window): each close's six phases sum to within 10% of `l4.close`,
    and the worker's stages to within 10% of `export`, its `process`
    call; every stage of the path is counted, and the ring holds them
    by thread."""
    from deepflow_tpu_torch.store.db import Store
    tracing.default_tracer().reset()
    exp = TpuSketchExporter(
        cfg=flow_suite.FlowSuiteConfig(**_SMALL), batch_rows=8192,
        window_seconds=3600, checkpoint_dir=str(tmp_path / "ckpt"),
        wire="dict", prefetch_depth=2, zero_copy=True, audit_rate=1 / 64,
        store=Store(str(tmp_path / "store")), device="cpu")
    rng = np.random.default_rng(7)
    exp.start()
    try:
        for w in range(3):
            for cols in _l4_chunks(rng, 6):
                exp.put("l4_flow_log", 0, cols)
            _wait_processed(exp, 6 * (w + 1))
            exp.flush_window(now=1000.0 + w)
        c = exp.counters()
        # the shutdown checkpoint publishes too, but is no close
        assert exp.checkpoint_now()
        snaps = {k: exp.counters()[k] for k in (
            "l4_close_snapshot_copy_count", "l4_close_snapshot_write_count")}
    finally:
        exp.close()
    assert snaps == {"l4_close_snapshot_copy_count": 3,
                     "l4_close_snapshot_write_count": 3}
    for stage in L4_WORKER + L4_CLOSE + ("l4_dispatch", "export",
                                         "l4_close"):
        assert c[f"{stage}_count"] > 0, stage
    assert c["l4_close_count"] == c["l4_close_readout_count"] == 3
    assert c["l4_coerce_count"] == 18
    parts, whole = _parts(c, "l4_close", L4_CLOSE)
    assert abs(parts - whole) <= 0.1 * whole
    parts, whole = _parts(c, "export", L4_WORKER)
    assert abs(parts - whole) <= 0.1 * whole
    threads = {s[6] for s in tracing.default_tracer().ring()}
    assert {"tpu_sketch-0", "tpu-sketch-feed", "MainThread"} <= threads


RED_WORKER = ("red_cut", "red_lock_wait", "red_stage", "red_update")
RED_CLOSE = ("red_close_lock_wait", "red_close_drain", "red_close_readout",
             "red_close_store")


def test_red_stages_sum_to_the_close_and_the_worker(tmp_path):
    """The RED exporter on the CPU with a Store: each close's phases sum
    to within 10% of `red.close`, the worker's stages to within 10% of
    `export`; `red.stage` and `red.update` count every batch, those the
    close cuts (its `red.close.drain`) too."""
    from deepflow_tpu_torch.runtime.app_red import AppRedExporter
    from deepflow_tpu_torch.store.db import Store
    tracing.default_tracer().reset()
    exp = AppRedExporter(store=Store(str(tmp_path / "store")),
                         batch_rows=4096, window_seconds=3600, device="cpu")
    rng = np.random.default_rng(8)
    exp.start()
    try:
        for w in range(3):
            for _ in range(5):
                exp.put("l7_flow_log", 0, {
                    "ip_dst": rng.integers(0, 64, 3000).astype(np.uint32),
                    "port_dst": np.full(3000, 80, np.uint32),
                    "protocol": np.full(3000, 20, np.uint32),
                    "status": rng.integers(0, 3, 3000).astype(np.uint32),
                    "rrt_us": rng.integers(1, 1 << 16, 3000).astype(
                        np.uint32)})
            _wait_processed(exp, 5 * (w + 1))
            exp.flush_window(now=1000.0 + w)
        c = exp.counters()
    finally:
        exp.close()
    assert c["red_close_count"] == c["red_close_store_count"] == 3
    assert c["red_update_count"] == c["red_stage_count"] == c["batches"]
    # the cut and the lock are stages of each chunk list
    assert c["red_cut_count"] == c["red_lock_wait_count"] == \
        c["export_count"] >= 3
    parts, whole = _parts(c, "red_close", RED_CLOSE)
    assert abs(parts - whole) <= 0.1 * whole
    parts, whole = _parts(c, "export", RED_WORKER)
    parts -= c["red_close_drain_sum_s"]
    assert abs(parts - whole) <= 0.1 * whole


def test_lock_wait_counts_a_held_state_lock():
    """A put that meets `_state_lock` held by another thread counts at
    least the time it was held against it in `l4.lock_wait`."""
    import threading
    import time
    tracing.default_tracer().reset()
    exp = TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(**_SMALL),
                            batch_rows=B, window_seconds=3600, wire="dict",
                            prefetch_depth=2, zero_copy=True, device="cpu")
    (cols,) = _l4_chunks(np.random.default_rng(9), 1, rows=256)
    try:
        before = exp.counters().get("l4_lock_wait_sum_s", 0.0)
        worker = threading.Thread(
            target=exp.process, args=([("l4_flow_log", 0, cols, -1)],))
        with exp._state_lock:
            worker.start()
            # the put is queued on the lock once it has coerced its chunk
            while exp.counters().get("l4_coerce_count", 0) < 1:
                time.sleep(0.001)
            t0 = time.perf_counter()
            time.sleep(0.2)
            held = time.perf_counter() - t0
        worker.join()
        waited = exp.counters()["l4_lock_wait_sum_s"] - before
    finally:
        exp.close()
    assert waited >= held


def test_stage_run_records_each_stage_of_a_call_site():
    """`stage_run` records several stages at once, as `stage` would
    each: totals, ring entries in order, one thread and rows."""
    import time
    tr = tracing.Tracer()
    t0 = time.perf_counter()
    tr.stage_run("app_red", 16384, (("red.stage", t0, t0 + 0.25),
                                    ("red.update", t0 + 0.25, t0 + 1.0)))
    tr.stage("red.stage", t0, t0 + 0.5, 8, "app_red")
    assert tr.stage_counters("app_red") == {
        "red_stage_count": 2, "red_stage_sum_s": pytest.approx(0.75),
        "red_update_count": 1, "red_update_sum_s": pytest.approx(0.75)}
    first, second, _ = tr.ring()
    assert [first[0], second[0]] == ["red.stage", "red.update"]
    assert first[5] == second[5] == 16384 and first[6] == second[6]
    assert second[3] - first[3] == pytest.approx(0.25)


def test_trace_export_fits_one_datagram_with_full_rings():
    """`df-ctl trace export` with both rings full, the stages at the
    longest names and thread the exporters use: the reply fits one
    datagram and holds the newest occupancy spans and stages alike."""
    import json
    import threading
    import time
    from deepflow_tpu_torch.runtime.debug import DebugServer, debug_request
    from deepflow_tpu_torch.runtime.stats import StatsRegistry
    prof = profiler.default_profiler()
    tr = tracing.default_tracer()
    prof.reset()
    tr.reset()

    def fill():
        for i in range(2 * tr._ring_cap):
            t = time.perf_counter()
            tr.stage(f"l4.close.snapshot_write{i % 7}", t - 0.0123, t,
                     rows=1 << 20, stream="tpu_sketch")

    for i in range(2 * 8192):
        prof.record("device", f"update:lanes_x{i % 7}", 0.0123, rows=65536)
    # the stages newest, from the longest of the exporters' thread names
    th = threading.Thread(target=fill, name="tpu-sketch-feed")
    th.start()
    th.join()
    srv = DebugServer(StatsRegistry(), port=0)
    srv.start()
    try:
        out = debug_request("trace-export", port=srv.port, limit=10_000,
                            timeout=10.0)
        assert out["ok"], out
        xs = [e for e in out["data"]["trace"]["traceEvents"]
              if e["ph"] == "X"]
        assert sum(e["pid"] == 1 for e in xs) == 175
        assert sum(e["pid"] == 2 for e in xs) == 175
        assert len(json.dumps(out).encode()) < 65000
    finally:
        srv.close()
        prof.reset()
        tr.reset()


def test_stage_overlays_a_torch_profiler_trace():
    """torch.profiler on the main thread sees only that thread's ranges;
    a stage recorded on another thread, exported with the profiler
    trace's `baseTimeNanoseconds`, falls inside the main thread's
    enclosing `record_function` range."""
    import json
    import threading
    import time
    from torch.profiler import ProfilerActivity, profile, record_function
    tr = tracing.Tracer()
    prof = profiler.OccupancyProfiler(tracer=tr)

    def work():
        t0 = time.perf_counter()
        time.sleep(0.03)
        tr.stage("l4.pack", t0, time.perf_counter(), stream="tpu_sketch")

    with profile(activities=[ProfilerActivity.CPU]) as p:
        with record_function("enclosing"):
            time.sleep(0.03)
            th = threading.Thread(target=work, name="worker")
            th.start()
            th.join()
            time.sleep(0.03)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/trace.json"
        p.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    outer, = [e for e in doc["traceEvents"] if e.get("name") == "enclosing"]
    assert not any(e.get("name") == "l4.pack" for e in doc["traceEvents"])
    mine = prof.to_chrome_trace(base_ns=int(doc["baseTimeNanoseconds"]))
    stage, = [e for e in mine["traceEvents"] if e["ph"] == "X"]
    assert stage["name"] == "l4.pack" and stage["pid"] == 2
    assert outer["ts"] < stage["ts"]
    assert stage["ts"] + stage["dur"] < outer["ts"] + outer["dur"]
    track, = [e for e in mine["traceEvents"] if e["name"] == "thread_name"]
    assert track["args"]["name"] == "worker" and track["tid"] == stage["tid"]
    # without a base the export stays on the wall clock, in microseconds
    wall = prof.to_chrome_trace()["traceEvents"][-1]
    assert wall["ts"] == pytest.approx(
        stage["ts"] + doc["baseTimeNanoseconds"] / 1e3)
