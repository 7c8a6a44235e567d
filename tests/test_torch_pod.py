"""The port's pod fault domains (`parallel/pod.py`) against the JAX
`PodFlowSuite` on the 8-device CPU mesh (tests/conftest.py).

One test for each case of the reference's `tests/test_pod.py`, both pods
fed the same planes (`SyntheticAgent`), the same wire and the same fault
spec (each package arms its own registry): the merged window outputs
(integer fields exact, float fields within rtol 1e-5 / atol 1e-6), the
merged pod-bus leaves and tags, the `EpochResult` fields and the
counters that do not depend on the clock. The straggler cases depend on
the clock: there the port's ledger equalities and late merge are held,
and the pods are compared once every contribution is in. Beside them:

- the fault-free pod against the port's own `ShardedFlowSuite` (the
  per-shard update is the sharded suite's own body);
- a degraded shard walked as on a CUDA device (`_host_fallback` off):
  its rows are shed and counted lost, and no host sketch runs;
- a `KernelError` from the per-shard update: its rows are counted lost,
  it surfaces at the next call, and no shard rolls back or degrades
  (also through the exporter, whose close still stops the shards);
- the exporter's `pod_shards` branch against the JAX exporter's, with
  the anomaly plane fed the epoch's participation tags;
- the ledger under concurrent producers and epoch closes on 16 shards
  (more than the cores) at a short thread switch interval.

The port's 8 shards all share the CPU (shard i on devices[i % 1]).
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from deepflow_tpu.models import flow_dict as jfd
from deepflow_tpu.models import flow_suite as jfs
from deepflow_tpu.parallel import PodFlowSuite as JPod
from deepflow_tpu.replay import SyntheticAgent
from deepflow_tpu.runtime.faults import default_faults as jfaults
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.models import flow_suite
from deepflow_tpu_torch.ops._build import KernelError
from deepflow_tpu_torch.parallel import PodFlowSuite, ShardedFlowSuite
from deepflow_tpu_torch.parallel import make_mesh, pod as tpod, sharded
from deepflow_tpu_torch.runtime.faults import default_faults as tfaults

F32 = dict(rtol=1e-5, atol=1e-6)
_SMALL = dict(cms_log2_width=10, ring_size=128, top_k=20, hll_groups=32,
              hll_precision=6, entropy_log2_buckets=8)
CFG, JCFG = flow_suite.FlowSuiteConfig(**_SMALL), jfs.FlowSuiteConfig(**_SMALL)
B = 2048
KEEP = ("ip_src", "ip_dst", "port_src", "port_dst", "proto", "packet_tx",
        "packet_rx")


def _plane(agent, n=B):
    cols = agent.l4_columns_pooled(n)
    lanes = flow_suite.pack_lanes({k: cols[k].astype(np.uint32)
                                   for k in KEEP})
    return np.stack([lanes[k] for k in flow_suite.SKETCH_LANE_NAMES])


def _pods(**kw):
    """(port pod on the CPU, JAX pod), same knobs."""
    return PodFlowSuite(CFG, device="cpu", **kw), JPod(JCFG, **kw)


def _feed(pods, agent, batches=4, valid=B):
    for _ in range(batches):
        plane = _plane(agent)
        for p in pods:
            # each pod owns the plane it is given
            p.put_lanes(plane.copy(), valid)
    return batches * valid


def _conserve(pod):
    c = pod.counters()
    assert c["pod_rows_sent"] == (c["pod_rows_delivered"]
                                  + c["pod_rows_host"] + c["pod_rows_lost"]
                                  + c["pod_rows_pending"]), c
    return c


def _assert_out(t, j, ctx=""):
    if j is None:
        assert t is None, ctx
        return
    np.testing.assert_array_equal(t.topk_keys.numpy().view(np.uint32),
                                  np.asarray(j.topk_keys), err_msg=ctx)
    for name in ("topk_counts", "rows"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=f"{ctx} {name}")
    for name in ("service_cardinality", "entropies"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)),
                                   err_msg=f"{ctx} {name}", **F32)


def _assert_result(tr, jr, ctx=""):
    for f in ("epoch", "participated", "missed", "degraded", "lost",
              "merged_rows", "lossy", "tags"):
        assert getattr(tr, f) == getattr(jr, f), (ctx, f, tr, jr)
    _assert_out(tr.out, jr.out, ctx)
    th, jh = sorted(tr.host_outputs, key=lambda x: x[0]), \
        sorted(jr.host_outputs, key=lambda x: x[0])
    assert [s for s, _ in th] == [s for s, _ in jh], ctx
    for (s, a), (_, b) in zip(th, jh):
        _assert_out(a, b, f"{ctx} host shard {s}")


def _assert_bus(t, j, ctx=""):
    """The merged pod-bus snapshots: every leaf exact, the tags equal."""
    ts, js = t.bus.latest(), j.bus.latest()
    assert (ts is None) == (js is None), ctx
    if ts is None:
        return
    assert ts.step == js.step and ts.tags == js.tags, (ctx, ts.tags, js.tags)
    assert len(ts.leaves) == len(js.leaves)
    for i, (a, b) in enumerate(zip(ts.leaves, js.leaves)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx} leaf {i}")


_CLOCK = ("pod_merge_epoch_s",)


def _assert_counters(t, j, ctx=""):
    tc, jc = _conserve(t), _conserve(j)
    want = {k: v for k, v in jc.items() if k not in _CLOCK}
    assert {k: tc[k] for k in want} == want, ctx
    return tc


def _assert_status(t, j):
    keys = ("shard", "status", "rows_in", "rows_lost", "rows_dropped",
            "host_rows", "device_errors", "recoveries",
            "last_contributed_epoch")
    assert [{k: s[k] for k in keys} for s in t.shard_status()] == \
        [{k: s[k] for k in keys} for s in j.shard_status()]


@pytest.fixture
def faults():
    armed = []

    def arm(spec):
        armed.extend(tfaults().arm_spec(spec))
        jfaults().arm_spec(spec)
    yield arm
    for site in armed:
        tfaults().disarm(site)
        jfaults().disarm(site)


# The straggler cases: the merge deadline sits well above an epoch merge
# on a loaded host (all shards present, whatever the load), and the
# stalled contribution is held until the test releases it (the stall
# outlasts the deadline by construction, not by the clock).
DEADLINE_S = 3.0


@pytest.fixture
def stall_gate():
    """Both fault registries' `merge.stall` sleep waits on one event
    instead of its delay; the test sets it once the straggler is
    excluded (and the fixture sets it on the way out)."""
    gate = threading.Event()
    regs = (tfaults(), jfaults())
    saved = [r._sleep for r in regs]
    for r in regs:
        r._sleep = lambda _delay: gate.wait(60)
    yield gate
    gate.set()
    for r, s in zip(regs, saved):
        r._sleep = s


def _close(pods, **kw):
    for p in pods:
        p.close(**kw)


def test_pod_lanes_matches_jax_pod_and_sharded_suite():
    """No faults: the port's 8-shard epoch merge equals the JAX pod's and
    the port's sharded suite's merged flush, leaf for leaf (an unaligned
    valid count exercises the per-shard masks)."""
    t, j = _pods(n_shards=8, merge_deadline_s=30.0)
    suite = ShardedFlowSuite(CFG, make_mesh(8, device="cpu"))
    st = suite.init()
    agent = SyntheticAgent(seed=3)
    n = B - 37
    try:
        for _ in range(3):
            plane = _plane(agent)
            st = suite.update_lanes(st, suite.put_lanes(plane), n)
            t.put_lanes(plane.copy(), n)
            j.put_lanes(plane.copy(), n)
        merged = sharded.rescore_ring(sharded._merge_axis0(st))
        st, out_sharded = suite.flush(st)
        assert t.drain(30) and j.drain(30)
        tr, jr = t.close_epoch(), j.close_epoch()
        assert tr.participated == list(range(8)) and not tr.missed
        assert not tr.tags["lossy"]
        _assert_result(tr, jr)
        _assert_bus(t, j)
        for a, b in zip(tr.out, out_sharded):
            assert torch.equal(a, b)
        for a, b in zip(t.bus.latest().leaves, convert.state_to_numpy(merged)):
            np.testing.assert_array_equal(a, b)
        c = _assert_counters(t, j)
        assert c["pod_rows_delivered"] == 3 * n
    finally:
        _close((t, j))
    assert _assert_counters(t, j)["pod_rows_pending"] == 0


def test_pod_dict_matches_jax_pod():
    """Dict wire: replicated news (interleaved count masks) and sharded
    hits, the same wire into both pods, merge to the same output."""
    t, j = _pods(n_shards=8, wire="dict", dict_capacity=8192,
                 merge_deadline_s=30.0)
    agent = SyntheticAgent(seed=5)
    packer = jfd.FlowDictPacker(capacity=8192, hits_batch=4096,
                                news_batch=512)
    wire = []
    for _ in range(3):
        cols = agent.l4_columns_pooled(4096)
        wire.extend(packer.pack({k: cols[k].astype(np.uint32)
                                 for k in KEEP}))
    wire.extend(packer.flush())
    try:
        t.put_wire([(k, np.array(p), n) for k, p, n in wire])
        j.put_wire(wire)
        assert t.drain(60) and j.drain(60)
        tr, jr = t.close_epoch(), j.close_epoch()
        assert tr.participated == list(range(8))
        _assert_result(tr, jr)
        _assert_bus(t, j)
        for a, b in zip(t._shards, j._shards):
            np.testing.assert_array_equal(
                a.dtable.table.numpy().view(np.uint32), np.asarray(b.dtable))
    finally:
        _close((t, j))
    assert _assert_counters(t, j)["pod_rows_pending"] == 0


def test_shard_device_error_rollback_matches_jax(faults):
    """One injected device error on shard 3 rolls only that shard back
    from its bus snapshot: the same counted loss, participation and
    merged output as the JAX pod."""
    pods = t, j = _pods(n_shards=8, merge_deadline_s=30.0,
                        snapshot_batches=2)
    faults("shard.device_error:count=1,match=shard3;seed=7")
    try:
        sent = _feed(pods, SyntheticAgent(seed=7), batches=6)
        assert t.drain(30) and j.drain(30)
        tr, jr = t.close_epoch(), j.close_epoch()
        _assert_result(tr, jr)
        _assert_bus(t, j)
        c = _assert_counters(t, j)
        _assert_status(t, j)
        assert c["pod_device_errors"] == 1
        assert 0 < c["pod_rows_lost"] <= 3 * (B // 8)
        assert len(tr.participated) == 8 and tr.tags["lossy"]
        assert c["pod_rows_delivered"] == sent - c["pod_rows_lost"]
        st = {s["shard"]: s for s in t.shard_status()}
        assert st[3]["device_errors"] == 1 and st[3]["status"] == "active"
    finally:
        _close(pods)
    assert _assert_counters(t, j)["pod_rows_pending"] == 0


def test_straggler_excluded_at_deadline(faults, stall_gate):
    """A merge.stall straggler past the deadline is excluded, counted and
    tagged, while the other 7 shards merge on time and ingest keeps
    flowing; its contribution merges late next epoch. Once every
    contribution is in, both pods agree."""
    pods = t, j = _pods(n_shards=8, merge_deadline_s=DEADLINE_S)
    faults("merge.stall:count=1,delay_s=1.5,match=shard5;seed=7")
    agent = SyntheticAgent(seed=9)
    try:
        sent = _feed(pods, agent, batches=4)
        assert t.drain(30) and j.drain(30)
        j.close_epoch()
        t0 = time.monotonic()
        tr = t.close_epoch()
        assert time.monotonic() - t0 < DEADLINE_S + 0.9, \
            "deadline not enforced"
        assert tr.missed == [5] and tr.tags["pod_shards_participated"] == 7
        assert 5 in tr.tags["pod_missing"] and tr.tags["lossy"]
        c = _conserve(t)
        assert c["pod_merge_missed"] == 1
        assert c["pod_rows_excluded"] == sent // 8
        assert c["pod_rows_delivered"] == sent - sent // 8
        t0 = time.monotonic()
        _feed([t], agent, batches=2)
        assert time.monotonic() - t0 < 0.5, "ingest blocked on a straggler"
        stall_gate.set()            # the stalled contribution posts
        assert t.drain(30)
        tr2 = t.close_epoch()
        c = _conserve(t)
        assert c["pod_late_merges"] >= 1 and c["pod_rows_pending"] == 0
        assert c["pod_rows_delivered"] == c["pod_rows_sent"]
        assert not tr2.missed
    finally:
        _close(pods)
    # the same rows, all delivered: the JAX pod's final ledger agrees
    tc, jc = _conserve(t), _conserve(j)
    assert tc["pod_rows_delivered"] == sent + 2 * B
    assert jc["pod_rows_delivered"] == jc["pod_rows_sent"] == sent


def test_shard_kill_and_snapshot_rejoin_matches_jax():
    """Kill shard 2 mid-ingest: unsnapshotted rows counted lost,
    snapshotted rows delivered late at rejoin, full participation two
    epochs later; every epoch equal to the JAX pod's."""
    pods = t, j = _pods(n_shards=8, merge_deadline_s=30.0,
                        snapshot_batches=2)
    agent = SyntheticAgent(seed=11)
    try:
        _feed(pods, agent, batches=6)
        assert t.drain(30) and j.drain(30)
        t.kill(2)
        j.kill(2)
        _feed(pods, agent, batches=2)
        tr, jr = t.close_epoch(), j.close_epoch()
        _assert_result(tr, jr, "kill epoch")
        assert 2 in tr.lost and tr.tags["pod_shards_participated"] == 7
        c = _assert_counters(t, j)
        assert c["pod_rejoins"] == 1 and c["pod_shards_lost"] == 0
        assert c["pod_rows_lost"] == 2 * (B // 8)
        tr, jr = t.close_epoch(), j.close_epoch()
        _assert_result(tr, jr, "rejoin epoch")
        _assert_bus(t, j, "rejoin epoch")
        c = _assert_counters(t, j)
        assert c["pod_late_merges"] >= 1 and c["pod_rows_pending"] == 0
        assert c["pod_rows_sent"] == c["pod_rows_delivered"] \
            + c["pod_rows_lost"]
        _feed(pods, agent, batches=2)
        assert t.drain(30) and j.drain(30)
        tr, jr = t.close_epoch(), j.close_epoch()
        _assert_result(tr, jr, "after rejoin")
        assert len(tr.participated) == 8
    finally:
        _close(pods)
    assert _assert_counters(t, j)["pod_rows_pending"] == 0


def test_degraded_shard_host_fallback_and_probe_recovery(faults):
    """Past degrade_after errors shard 1 drops to the host fallback (its
    rows host rows, the epoch tagged degraded, its host output equal to
    the JAX pod's); the epoch-boundary probe brings it back once the
    fault clears."""
    pods = t, j = _pods(n_shards=8, merge_deadline_s=30.0, degrade_after=1,
                        snapshot_batches=100)
    faults("shard.device_error:count=2,match=shard1;seed=3")
    agent = SyntheticAgent(seed=13)
    try:
        _feed(pods, agent, batches=6)
        assert t.drain(30) and j.drain(30)
        assert {s["shard"]: s["status"] for s in t.shard_status()}[1] \
            == "degraded"
        _feed(pods, agent, batches=2)
        assert t.drain(30) and j.drain(30)
        tr, jr = t.close_epoch(), j.close_epoch()
        _assert_result(tr, jr, "degraded epoch")
        c = _assert_counters(t, j)
        assert tr.degraded == [1] and tr.tags["pod_degraded"] == [1]
        assert c["pod_rows_lost"] == B // 8
        assert c["pod_rows_host"] == 7 * (B // 8)
        tfaults().disarm("shard.device_error")
        jfaults().disarm("shard.device_error")
        # the probe runs on the shard's worker after its contribution is
        # posted, so whether this epoch still reads shard 1 degraded
        # depends on the clock, in either package: its result is not
        # compared
        t.close_epoch()
        j.close_epoch()
        _feed(pods, agent, batches=2)
        assert t.drain(30) and j.drain(30)
        tr, jr = t.close_epoch(), j.close_epoch()
        _assert_result(tr, jr, "recovered")
        assert not tr.degraded and len(tr.participated) == 8
        _assert_status(t, j)
    finally:
        _close(pods)
    assert _assert_counters(t, j)["pod_rows_pending"] == 0


def test_degraded_shard_sheds_as_on_cuda(faults):
    """The same ladder walked as a CUDA device walks it: the degraded
    shard's rows are shed and counted lost (`pod_rows_shed`), no host
    sketch runs, no host output is made, and the ledger still closes."""
    t = PodFlowSuite(CFG, n_shards=8, merge_deadline_s=30.0, degrade_after=1,
                     snapshot_batches=100, device="cpu")
    t._host_fallback = False
    faults("shard.device_error:count=2,match=shard1;seed=3")
    agent = SyntheticAgent(seed=13)
    try:
        _feed([t], agent, batches=8)
        assert t.drain(30)
        res = t.close_epoch()
        c = _conserve(t)
        assert res.degraded == [1] and res.host_outputs == []
        assert c["pod_rows_host"] == 0
        assert c["pod_rows_shed"] == 7 * (B // 8)
        assert c["pod_rows_lost"] == 8 * (B // 8)
        assert t._shards[1]._host is None
        tfaults().disarm("shard.device_error")
        t.close_epoch()
        _feed([t], agent, batches=1)
        assert t.drain(30)
        assert len(t.close_epoch().participated) == 8
    finally:
        t.close()
    assert _conserve(t)["pod_rows_pending"] == 0


def test_pod_audit_tags_shard_loss_lossy(faults, stall_gate):
    """The shadow absorbs every row, and an epoch that excluded a shard
    (then the epoch of its late merge) closes the audit lossy; the
    alarm never fires. The window verdicts equal the JAX auditor's."""
    from deepflow_tpu.runtime.audit import ShadowAuditor as JAuditor
    from deepflow_tpu_torch.runtime.audit import ShadowAuditor

    pods = t, j = _pods(n_shards=8, merge_deadline_s=DEADLINE_S)
    ta = ShadowAuditor(CFG, rate=1.0, trip_windows=1)
    ja = JAuditor(JCFG, rate=1.0, trip_windows=1)
    t.attach_auditor(ta)
    j.attach_auditor(ja)
    faults("merge.stall:count=1,delay_s=1.0,match=shard4;seed=7")
    try:
        sent = _feed(pods, SyntheticAgent(seed=17), batches=4)
        assert t.drain(30) and j.drain(30)
        t.close_epoch()
        j.close_epoch()
        for a in (ta, ja):
            assert a.rows_seen_total == sent
            assert a.lossy_windows == 1 and a.last_window["lossy"]
            assert not a.alarm and a._violations == 0
        stall_gate.set()            # the stalled contributions post
        assert t.drain(30) and j.drain(30)
        t.close_epoch()
        j.close_epoch()
        for a in (ta, ja):
            assert a.windows == 2 and a.lossy_windows == 2 and not a.alarm
        for k in ("window", "rows", "sampled_rows", "sampled_keys",
                  "degraded", "lossy"):
            assert ta.last_window[k] == ja.last_window[k], k
    finally:
        _close(pods, final_epoch=False)
    _conserve(t)


def test_pod_ingest_never_blocks_on_lost_shard():
    """put_lanes against a pod with a LOST shard returns at once: its
    slices drop counted while every other shard keeps absorbing; the
    manual rejoin works with auto_rejoin off."""
    pods = t, j = _pods(n_shards=8, merge_deadline_s=30.0,
                        auto_rejoin=False)
    agent = SyntheticAgent(seed=19)
    try:
        _feed(pods, agent, batches=2)
        assert t.drain(30) and j.drain(30)
        t.kill(0)
        j.kill(0)
        planes = [_plane(agent) for _ in range(8)]
        t0 = time.monotonic()
        for p in planes:
            t.put_lanes(p.copy(), B)
        assert time.monotonic() - t0 < 1.0, "ingest blocked on a lost shard"
        for p in planes:
            j.put_lanes(p, B)
        sent = 8 * B
        assert t.drain(30) and j.drain(30)
        tr, jr = t.close_epoch(), j.close_epoch()
        _assert_result(tr, jr)
        assert 0 in tr.lost and tr.tags["pod_shards_participated"] == 7
        _assert_counters(t, j)
        st = {s["shard"]: s for s in t.shard_status()}
        assert st[0]["rows_dropped"] == sent // 8
        assert t.rejoin(0) and j.rejoin(0)
        tr, jr = t.close_epoch(), j.close_epoch()
        _assert_result(tr, jr, "manual rejoin")
        assert _assert_counters(t, j)["pod_rejoins"] == 1
    finally:
        _close(pods)
    assert _assert_counters(t, j)["pod_rows_pending"] == 0


def test_pod_kernel_error_surfaces_and_is_never_worked_around(monkeypatch):
    """A KernelError from one shard's update: that batch's rows are
    counted lost, nothing rolls back or degrades, whatever the shards
    have not run yet is shed (counted), and the error is raised by the
    next put_lanes, close_epoch and close."""
    real = sharded.update_lanes_shard

    def broken(state, plane, off, n, cfg):
        if off == 2 * plane.shape[1]:
            raise KernelError("hist: launch failed")
        return real(state, plane, off, n, cfg)

    monkeypatch.setattr(tpod.sharded, "update_lanes_shard", broken)
    t = PodFlowSuite(CFG, n_shards=8, merge_deadline_s=30.0, device="cpu")
    agent = SyntheticAgent(seed=23)
    try:
        t.put_lanes(_plane(agent), B)
        assert t.drain(30)
        c = _conserve(t)
        st = {s["shard"]: s for s in t.shard_status()}
        assert st[2]["rows_lost"] == B // 8 and st[2]["rows_shed"] == 0
        # the error is the pod's: shards that had not run the batch yet
        # shed their slices, counted
        assert c["pod_rows_lost"] == B // 8 + c["pod_rows_shed"]
        assert c["pod_device_errors"] == 0 and c["pod_shards_active"] == 8
        with pytest.raises(KernelError):
            t.put_lanes(_plane(agent), B)
        with pytest.raises(KernelError):
            t.close_epoch()
        st = {s["shard"]: s for s in t.shard_status()}
        assert st[2]["status"] == "active" and st[2]["device_errors"] == 0
        assert st[2]["recoveries"] == 0
    finally:
        with pytest.raises(KernelError):
            t.close()
    assert all(not sh.handle.is_alive() for sh in t._shards)
    _conserve(t)


def test_pod_exporter_matches_jax_exporter(faults, stall_gate):
    """The exporter's pod_shards branch against the JAX exporter's: the
    chunks fan over 8 shard queues, a window flush closes a merge epoch
    whose output and merged bus snapshot (with participation tags) equal
    the JAX exporter's; the JAX serving tables read the port's bus; the
    anomaly plane scores the merged output with the epoch's
    participation tags; the ledger closes at exporter close."""
    from deepflow_tpu.batch.schema import L4_SCHEMA
    from deepflow_tpu.runtime.tpu_sketch import TpuSketchExporter as JExp
    from deepflow_tpu.serving import SketchTables, SnapshotCache
    from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter

    texp = TpuSketchExporter(cfg=CFG, window_seconds=3600, batch_rows=B,
                             pod_shards=8, pod_merge_deadline_s=DEADLINE_S,
                             anomaly=True, device="cpu")
    jexp = JExp(store=None, cfg=JCFG, window_seconds=3600, batch_rows=B,
                pod_shards=8, pod_merge_deadline_s=DEADLINE_S, anomaly=True)
    assert texp.pod is not None and texp.snapshot_bus is texp.pod.bus
    assert texp.wire == "lanes" and texp.checkpointer is None
    cache = SnapshotCache(texp.snapshot_bus, max_staleness_s=3600)
    tables = SketchTables(cache)
    rng = np.random.default_rng(0)
    cols = {name: rng.integers(0, 1 << 10, 3 * B).astype(dt)
            for name, dt in L4_SCHEMA.columns}
    try:
        texp.process([("l4_flow_log", 0, dict(cols), -1)])
        jexp.process([("l4_flow_log", 0, dict(cols))])
        assert texp.pod.drain(30) and jexp.pod.drain(30)
        tout = texp.flush_window(now=1000.0)
        jout = jexp.flush_window(now=1000.0)
        _assert_out(tout, jout)
        _assert_bus(texp.pod, jexp.pod)
        rows = tables.topk(5)
        assert rows and rows[0]["shards_active"] == 8
        assert rows[0]["shards_missing"] == []
        tags = texp.anomaly.bus.latest().tags
        assert tags["pod_shards_participated"] == 8
        assert tags["pod_shards"] == 8 and tags["pod_missing"] == []
        # a straggler: the next window closes without shard 6, lossy
        faults("merge.stall:count=1,delay_s=1.0,match=shard6;seed=7")
        texp.process([("l4_flow_log", 0, dict(cols), -1)])
        assert texp.pod.drain(30)
        texp.flush_window(now=1001.0)
        snap = cache.latest()
        assert snap.tags["pod_shards_participated"] == 7
        assert snap.tags["lossy"] and tables.topk(5)[0]["shards_missing"] \
            == [6]
        assert texp.anomaly.bus.latest().tags["pod_missing"] == [6]
        c = texp.counters()
        assert c["pod_merge_missed"] == 1
        assert c["pod_rows_sent"] == c["rows_in"] == 6 * B
        stall_gate.set()            # the stalled contribution posts
        assert texp.pod.drain(30)
    finally:
        texp.close()
        jexp.close()
        cache.close()
    c = texp.counters()
    assert c["pod_rows_pending"] == 0
    assert c["pod_rows_delivered"] == c["pod_rows_sent"] == 6 * B


def test_pod_ledger_under_concurrent_ingest_and_closes():
    """Three producer threads put while this thread closes epochs, on 16
    shards, with a short thread switch interval: every counters()
    snapshot conserves, and after close every row is delivered."""
    planes = [_plane(SyntheticAgent(seed=s)) for s in range(3)]
    errors = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    pod = PodFlowSuite(CFG, n_shards=16, merge_deadline_s=30.0,
                       queue_batches=128, device="cpu")

    def producer(plane):
        try:
            for _ in range(8):
                pod.put_lanes(plane.copy(), B)
        except Exception as e:      # surfaced by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(p,)) for p in planes]
    try:
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            _conserve(pod)
            pod.close_epoch()
            time.sleep(0.01)
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
        pod.close()
    assert not errors, errors
    c = _conserve(pod)
    assert c["pod_rows_pending"] == 0 and c["pod_rows_lost"] == 0
    assert c["pod_rows_delivered"] == c["pod_rows_sent"] == 3 * 8 * B


def test_pod_exporter_kernel_error_surfaces_and_close_stops_the_shards(
        monkeypatch):
    """The exporter's pod branch with a kernel that fails to launch: the
    next process() raises the KernelError, close() raises it too and
    still stops every shard worker."""
    from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter

    def broken(*a, **k):
        raise KernelError("hist: launch failed")

    monkeypatch.setattr(tpod.sharded, "update_lanes_shard", broken)
    exp = TpuSketchExporter(cfg=CFG, window_seconds=3600, batch_rows=B,
                            pod_shards=8, device="cpu")
    rng = np.random.default_rng(1)
    cols = {k: rng.integers(0, 1 << 10, B).astype(np.uint32) for k in KEEP}
    exp.process([("l4_flow_log", 0, dict(cols), -1)])
    assert exp.pod.drain(30)
    with pytest.raises(KernelError):
        exp.process([("l4_flow_log", 0, dict(cols), -1)])
    with pytest.raises(KernelError):
        exp.close()
    for sh in exp.pod._shards:
        sh.handle.join(timeout=5)
        assert not sh.handle.is_alive()
    c = _conserve(exp.pod)
    assert c["pod_rows_lost"] == B and c["pod_device_errors"] == 0


@pytest.fixture
def tracers():
    """Both packages' process tracers, emptied and enabled; disabled and
    emptied again after the test."""
    from deepflow_tpu.runtime.tracing import default_tracer as jtracer
    from deepflow_tpu_torch.runtime.tracing import default_tracer as ttracer
    both = (ttracer(), jtracer())
    for tr in both:
        tr.reset()
        tr.enable()
    yield both
    for tr in both:
        tr.disable()
        tr.reset()


def test_pod_tracer_gauges_match_jax(tracers):
    """Each epoch close sets pod_shards_active, pod_merge_missed and
    pod_merge_epoch_s under the tracer, as the JAX pod does: a kill
    epoch reads 7 active shards, the rejoin epoch 8; none is set with
    the tracer off."""
    pods = t, j = _pods(n_shards=8, merge_deadline_s=30.0,
                        snapshot_batches=2)
    tt, jt = tracers
    names = ("pod_shards_active", "pod_merge_missed")
    agent = SyntheticAgent(seed=11)
    try:
        _feed(pods, agent, batches=4)
        assert t.drain(30) and j.drain(30)
        t.kill(2)
        j.kill(2)
        _feed(pods, agent, batches=2)
        t.close_epoch()
        j.close_epoch()
        tg, jg = tt.gauges(), jt.gauges()
        assert {k: tg[k] for k in names} == {k: jg[k] for k in names}
        assert tg["pod_shards_active"] == 7.0
        assert tg["pod_merge_epoch_s"] > 0
        t.close_epoch()
        j.close_epoch()
        tg, jg = tt.gauges(), jt.gauges()
        assert {k: tg[k] for k in names} == {k: jg[k] for k in names}
        assert tg["pod_shards_active"] == 8.0
        tt.disable()
        tt.reset()
        _feed((t,), agent, batches=1)
        assert t.drain(30)
        t.close_epoch()
        assert not set(tt.gauges()) & set(names)
    finally:
        _close(pods)
