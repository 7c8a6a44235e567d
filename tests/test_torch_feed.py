"""The port's exporter as the ingester runs it, on the CPU: the
overlapped feed with zero-copy staging and the TensorBatch feed
(`zero_copy=False`) on both wires against the JAX package's exporter
with the same knobs and against the port's own inline path, the drain
ladder with a group in flight, the device-error ladder,
feed-thread crashes and poisoned pack groups, and the exporter contract
inside the JAX package's `Exporters` registry.

Inputs are `replay/generator.py` ddos_ramp windows (a baseline window
and the first ramp windows, whose src-spoofed rows bring news flows),
cut into unaligned chunks. Integer state leaves are compared exactly at
every window close (through each exporter's snapshot bus); float window
readouts within rtol 1e-5, atol 1e-6 (XLA-CPU and ATen round log/sqrt
apart in the last ulp). Every exporter is closed in a `finally`."""

import threading
import time

import numpy as np
import pytest
import torch

from deepflow_tpu.models import flow_suite as jfs
from deepflow_tpu.replay.generator import ddos_ramp
from deepflow_tpu.runtime import tpu_sketch as jts
from deepflow_tpu.runtime.exporters import Exporters
from deepflow_tpu_torch.batch import staging
from deepflow_tpu_torch.models import flow_suite
from deepflow_tpu_torch.ops._build import KernelError
from deepflow_tpu_torch.runtime.faults import default_faults
from deepflow_tpu_torch.runtime.supervisor import default_supervisor
from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter

F32_TOL = dict(rtol=1e-5, atol=1e-6)
_SMALL = dict(cms_log2_width=12, ring_size=256, hll_groups=64,
              hll_precision=8, entropy_log2_buckets=10)
B = 512


@pytest.fixture(autouse=True)
def _clean_faults():
    default_faults().disarm()
    yield
    default_faults().disarm()


def _windows(first=11, n=2, rows=1500, chunk=700):
    """ddos_ramp windows `first`.. as lists of unaligned chunks."""
    ramp = ddos_ramp(rows_per_window=rows)
    out = []
    for w in range(first, first + n):
        _, cols = ramp.window_cols(w)
        total = len(cols["ip_src"])
        out.append([{k: v[s:s + chunk] for k, v in cols.items()}
                    for s in range(0, total, chunk)])
    return out


def _port(**kw):
    kw.setdefault("cfg", flow_suite.FlowSuiteConfig(**_SMALL))
    kw.setdefault("batch_rows", B)
    kw.setdefault("window_seconds", 3600)
    return TpuSketchExporter(device="cpu", **kw)


def _subscribe(exp):
    snaps = []
    exp.snapshot_bus.subscribe(lambda s: snaps.append(
        [np.asarray(a) for a in s.leaves]))
    return snaps


def _feed(exp, chunks):
    for c in chunks:
        exp.process([("l4_flow_log", 0, c, -1)])
    return sum(len(c["ip_src"]) for c in chunks)


def _assert_leaves_equal(a, b):
    assert len(a) == len(b) == 9
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _assert_output_equal(tout, jout):
    np.testing.assert_array_equal(tout.topk_keys.numpy().view(np.uint32),
                                  np.asarray(jout.topk_keys))
    np.testing.assert_array_equal(tout.topk_counts.numpy(),
                                  np.asarray(jout.topk_counts))
    assert int(tout.rows) == int(np.asarray(jout.rows))
    np.testing.assert_allclose(tout.service_cardinality.numpy(),
                               np.asarray(jout.service_cardinality),
                               **F32_TOL)
    np.testing.assert_allclose(tout.entropies.numpy(),
                               np.asarray(jout.entropies), **F32_TOL)


@pytest.mark.parametrize("wire,fused", [("dict", None), ("lanes", None),
                                        ("dict", True)])
def test_feed_exporter_matches_jax_every_window(wire, fused):
    """Feed + zero-copy staging, both wires: state leaves at every window
    close and the window outputs equal the JAX exporter's."""
    jexp = jts.TpuSketchExporter(
        store=None, cfg=jfs.FlowSuiteConfig(**_SMALL), batch_rows=B,
        window_seconds=3600, wire=wire, prefetch_depth=2,
        coalesce_batches=2, zero_copy=True)
    texp = _port(cfg=flow_suite.FlowSuiteConfig(**_SMALL, fused_hists=fused),
                 wire=wire, prefetch_depth=2, coalesce_batches=2)
    try:
        assert texp.zero_copy and texp._stager is not None
        jsnaps = []
        jexp.snapshot_bus.subscribe(lambda s: jsnaps.append(
            [np.asarray(a) for a in s.leaves]))
        tsnaps = _subscribe(texp)
        for chunks in _windows():
            for c in chunks:
                jexp.process([("l4_flow_log", 0, c, -1)])
            _feed(texp, chunks)
            jout, tout = jexp.flush_window(), texp.flush_window()
            _assert_leaves_equal(tsnaps[-1], jsnaps[-1])
            _assert_output_equal(tout, jout)
        assert len(tsnaps) == len(jsnaps) == 2
        assert texp.rows_in == jexp.rows_in
        assert texp.counters()["batches"] == jexp.counters()["batches"]
    finally:
        jexp.close()
        texp.close()


@pytest.mark.parametrize("wire", ["dict", "lanes"])
def test_feed_paths_match_inline(wire):
    """The port's feed paths (zero-copy, zero-copy with a pack pool)
    equal its inline path leaf by leaf at every window close, the dict
    table word by word, outputs exactly."""
    exps = [_port(wire=wire, coalesce_batches=2),
            _port(wire=wire, prefetch_depth=2, coalesce_batches=2),
            _port(wire=wire, prefetch_depth=2, coalesce_batches=2,
                  pack_workers=2)]
    try:
        snaps = [_subscribe(e) for e in exps]
        for chunks in _windows(first=12):
            for e in exps:
                _feed(e, chunks)
            outs = [e.flush_window() for e in exps]
            for s, o in zip(snaps[1:], outs[1:]):
                _assert_leaves_equal(s[-1], snaps[0][-1])
                for a, b in zip(o, outs[0]):
                    assert torch.equal(a, b)
            if wire == "dict":
                ref = exps[0]._dict_state.table
                for e in exps[1:]:
                    assert torch.equal(e._dict_state.table, ref)
        assert exps[2].counters()["pack_task_errors"] == 0
    finally:
        for e in exps:
            e.close()


@pytest.mark.parametrize("coalesce", [1, 4])
@pytest.mark.parametrize("wire", ["dict", "lanes"])
def test_tensorbatch_feed_is_refused(wire, coalesce):
    """The name is historical: the feed was once refused, and this test
    now checks parity. The TensorBatch feed (a feed without zero-copy
    staging: the feed thread packs K TensorBatches into one staging
    buffer) runs: state leaves at every window close and the window outputs
    equal the JAX exporter's with the same arguments, and equal the
    port's inline path exactly (the dict table word for word)."""
    jexp = jts.TpuSketchExporter(
        store=None, cfg=jfs.FlowSuiteConfig(**_SMALL), batch_rows=B,
        window_seconds=3600, wire=wire, prefetch_depth=2,
        coalesce_batches=coalesce, zero_copy=False)
    texp = _port(wire=wire, prefetch_depth=2, coalesce_batches=coalesce,
                 zero_copy=False)
    inline = _port(wire=wire, coalesce_batches=coalesce)
    try:
        assert not texp.zero_copy and texp._stager is None
        assert texp._feed is not None and texp._feed.coalesce == coalesce
        assert not jexp.zero_copy and jexp._feed is not None
        jsnaps = []
        jexp.snapshot_bus.subscribe(lambda s: jsnaps.append(
            [np.asarray(a) for a in s.leaves]))
        tsnaps, isnaps = _subscribe(texp), _subscribe(inline)
        for chunks in _windows():
            for c in chunks:
                jexp.process([("l4_flow_log", 0, c, -1)])
            _feed(texp, chunks)
            _feed(inline, chunks)
            jout, tout, iout = (jexp.flush_window(), texp.flush_window(),
                                inline.flush_window())
            _assert_leaves_equal(tsnaps[-1], jsnaps[-1])
            _assert_leaves_equal(tsnaps[-1], isnaps[-1])
            _assert_output_equal(tout, jout)
            for a, b in zip(tout, iout):
                assert torch.equal(a, b)
            if wire == "dict":
                assert torch.equal(texp._dict_state.table,
                                   inline._dict_state.table)
        assert len(tsnaps) == len(jsnaps) == 2
        assert texp.rows_in == jexp.rows_in == inline.rows_in
        assert texp.counters()["batches"] == jexp.counters()["batches"]
        assert texp.counters()["feed_groups"] > 0
        assert texp._staging_pool.buffers()   # recycled at their fences
    finally:
        jexp.close()
        texp.close()
        inline.close()


@pytest.mark.parametrize("wire", ["dict", "lanes"])
def test_tensorbatch_feed_drain_conservation_with_groups_in_flight(wire):
    """delivered + lost == sent through close() on the TensorBatch feed,
    with groups in the prefetch window and a partial batch in the
    batcher when the drain starts."""
    e = _port(wire=wire, prefetch_depth=3, coalesce_batches=2,
              zero_copy=False)
    try:
        sent = sum(_feed(e, chunks) for chunks in _windows(n=1))
        assert e.pending_extra() >= 1
        assert len(next(iter(e.batcher._buf.values()))) == B
    finally:
        e.close()
    assert e.rows_in == sent
    assert int(e.last_output.rows) + e.lost_rows == sent
    assert e.lost_rows == 0 and e.pending_extra() == 0


@pytest.mark.parametrize("wire", ["dict", "lanes"])
def test_tensorbatch_feed_ladder_sheds_on_the_card(wire, tmp_path):
    """The TensorBatch feed's device-error ladder as a CUDA device walks
    it: a rollback, then the second error degrades the lane, the groups
    still queued and later batches are shed and counted lost, the probe
    recovers, and close() with groups in flight conserves: delivered +
    counted loss == sent (the restored snapshot replays window A)."""
    e = _port(wire=wire, prefetch_depth=2, coalesce_batches=2,
              zero_copy=False, checkpoint_dir=str(tmp_path))
    e._host_fallback = False                  # what device="cuda" sets
    faults = default_faults()
    try:
        (a,) = _windows(first=10, n=1)
        sent = _feed(e, a)
        out_a = e.flush_window()
        faults.arm("tpu.device_error", count=2, match=wire)
        b1, b2 = _windows(first=12, n=2)
        queued = threading.Event()           # b1's batches all queued
        _gate(e, queued)
        sent_b = _feed(e, b1)
        queued.set()
        assert e._feed.drain(30)
        assert e.degraded and e.device_errors == 2
        sent_b += _feed(e, b2)
        out_b = e.flush_window()             # sheds what is queued, probes
        assert e.shed_rows >= sum(len(c["ip_src"]) for c in b2)
        assert out_b is None and e.recoveries == 1 and not e.degraded
        assert e.host_rows == 0 and e._host is None
        assert int(out_a.rows) + e.lost_rows == sent + sent_b
        (c,) = _windows(first=14, n=1)
        sent_c = _feed(e, c)
        assert e.pending_extra() >= 1
    finally:
        faults.disarm()
        e.close()
    assert e.rows_in == sent + sent_b + sent_c
    assert int(e.last_output.rows) == sent_c + int(out_a.rows)


@pytest.mark.parametrize("wire", ["dict", "lanes"])
def test_drain_conservation_with_group_in_flight(wire):
    """delivered + lost == sent through close(), with groups in the
    prefetch window when the drain ladder starts."""
    e = _port(wire=wire, prefetch_depth=3, coalesce_batches=2)
    try:
        sent = sum(_feed(e, chunks) for chunks in _windows(n=1))
        # the window keeps dispatched groups until a barrier fences them
        assert e.pending_extra() >= 1
    finally:
        e.close()
    assert e.rows_in == sent
    assert int(e.last_output.rows) + e.lost_rows == sent
    assert e.lost_rows == 0 and e.pending_extra() == 0


def _gate(exp, release=None):
    """Hold the feed thread's first group until the feed queue is full
    (or until the `release` event is set), so that several groups are
    staged before the first one dispatches."""
    orig = exp._feed._process_group
    held = [True]

    def gated(group):
        deadline = time.monotonic() + 30
        while held[0] and not (release.is_set() if release is not None
                               else exp._feed._q.full()):
            assert time.monotonic() < deadline
            time.sleep(0.001)
        held[0] = False
        return orig(group)

    exp._feed._process_group = gated


@pytest.mark.parametrize("wire", ["dict", "lanes"])
def test_device_error_ladder(wire, tmp_path):
    """Window A is clean and checkpointed. In window B the first two
    dispatches fail: a rollback from A's snapshot into fresh tensors,
    then the host fallback (dict: groups of the dead packer generation
    dropped as counted loss). The probe at B's flush recovers, and the
    restored snapshot replays A's window into C at least once, as the
    reference's restore does. Conservation over A and B is exact."""
    e = _port(wire=wire, prefetch_depth=2, coalesce_batches=1,
              checkpoint_dir=str(tmp_path))
    faults = default_faults()
    try:
        (a,) = _windows(first=10, n=1)
        sent = _feed(e, a)
        out_a = e.flush_window()
        snap_a = e.snapshot_bus.latest()
        assert snap_a.step == 1 and int(out_a.rows) == sent
        faults.arm("tpu.device_error", count=2, match=wire)
        b1, b2 = _windows(first=12, n=2)     # 3000 rows each: 5+ groups
        _gate(e)
        sent_b = _feed(e, b1)
        assert e._feed.drain(30)
        assert e.degraded and e.device_errors == 2
        assert e.counters()["restores"] >= 2
        assert e.snapshot_bus.last_restored_step == 1
        sent_b += _feed(e, b2)               # live groups: host fallback
        out_b = e.flush_window()             # probe: faults spent
        assert e.recoveries == 1 and not e.degraded
        assert e.host_rows > 0 and e.lost_rows > 0
        if wire == "dict":
            assert e.counters()["dict_epoch_drops"] >= 1
        assert int(out_a.rows) + int(out_b.rows) + e.lost_rows \
            == sent + sent_b
        (c,) = _windows(first=14, n=1)
        sent_c = _feed(e, c)
        out_c = e.flush_window()
        assert int(out_c.rows) == sent_c + int(snap_a.leaves[7])
    finally:
        faults.disarm()
        e.close()


@pytest.mark.parametrize("wire", ["dict", "lanes"])
def test_device_error_ladder_sheds_on_the_card(wire, tmp_path):
    """The ladder as a CUDA device walks it (no host fallback there):
    after the rollback and the second error, rows are shed and counted
    lost rather than computed on the CPU, the degraded window yields no
    output, and the probe recovers. delivered + lost == sent."""
    e = _port(wire=wire, prefetch_depth=2, coalesce_batches=1,
              checkpoint_dir=str(tmp_path))
    e._host_fallback = False                  # what device="cuda" sets
    faults = default_faults()
    try:
        (a,) = _windows(first=10, n=1)
        sent = _feed(e, a)
        out_a = e.flush_window()
        faults.arm("tpu.device_error", count=2, match=wire)
        b1, b2 = _windows(first=12, n=2)
        _gate(e)
        sent_b = _feed(e, b1)
        assert e._feed.drain(30)
        assert e.degraded and e.device_errors == 2
        sent_b += _feed(e, b2)
        out_b = e.flush_window()             # sheds what is staged, probes
        assert e.shed_rows >= sum(len(c["ip_src"]) for c in b2)
        assert out_b is None and e.recoveries == 1 and not e.degraded
        assert e.host_rows == 0 and e._host is None
        assert int(out_a.rows) + e.lost_rows == sent + sent_b
        (c,) = _windows(first=14, n=1)
        sent_c = _feed(e, c)
        assert int(e.flush_window().rows) == sent_c + int(out_a.rows)
    finally:
        faults.disarm()
        e.close()


def _break_kernels(exp):
    """Every later dispatch fails as a kernel that cannot launch does."""
    def broken(*_args):
        raise KernelError("df_fused_lane_hists: CUDA error 98 at launch")
    exp._apply_wire = exp._apply_lanes = broken


@pytest.mark.parametrize("wire", ["dict", "lanes"])
@pytest.mark.parametrize("depth", [0, 2])
def test_kernel_error_raises_and_is_never_worked_around(wire, depth):
    """A kernel that fails to build or launch is no device error: no
    rollback, no degraded mode, no host rows. Inline, process() raises
    it; on the feed, the queued groups are shed (counted lost) and the
    producer's next flush_window, process or close raises it."""
    e = _port(wire=wire, prefetch_depth=depth, coalesce_batches=1)
    closed = False
    try:
        a, b = _windows(first=10, n=2)
        sent = _feed(e, a)
        out_a = e.flush_window()
        _break_kernels(e)
        if depth == 0:
            with pytest.raises(KernelError):
                _feed(e, b)
        else:
            for c in b:
                try:                       # staged; the feed thread fails,
                    sent += _feed(e, [c])  # maybe before the last chunk
                except KernelError:
                    pass
            with pytest.raises(KernelError):
                e.flush_window()
            assert e.shed_rows == e.lost_rows > 0
            assert int(out_a.rows) + e.lost_rows == sent == e.rows_in
        with pytest.raises(KernelError):
            _feed(e, b)
        assert e.device_errors == 0 and not e.degraded
        assert e.host_rows == 0 and e._host is None
        closed = True
        with pytest.raises(KernelError):
            e.close()
        assert e._feed is None or not e._feed._handle.is_alive()
    finally:
        if not closed:
            e.close()


def test_feed_thread_crash_is_restarted_and_counted():
    """A crashing feed thread is a supervisor restart: the group it held
    is counted lost, the state restored, and the feed keeps going;
    delivered + lost == sent."""
    e = _port(wire="lanes", prefetch_depth=2)
    orig = e._feed._process_group
    boom = [True]

    def flaky(group):
        if boom[0]:
            boom[0] = False
            raise ValueError("injected feed crash")
        return orig(group)

    e._feed._process_group = flaky
    try:
        (chunks,) = _windows(n=1)
        sent = _feed(e, chunks)
        assert e._feed.drain(30)
        rows = [t for t in default_supervisor().threads()
                if t["name"] == "tpu-sketch-feed" and t["alive"]]
        assert rows and any(t["crashes"] >= 1 for t in rows)
        assert e._feed.crash_recoveries == 1
        assert e.lost_rows == B and e.lost_windows == 1
        out = e.flush_window()
    finally:
        e.close()
    assert int(out.rows) + e.lost_rows == sent


def test_poisoned_pack_group_counted_lost(monkeypatch):
    """A pack task that fails poisons its group only: the feed thread
    crashes into the supervisor on StagingPackError, the group's rows
    are counted lost, the pool keeps serving, and the rest delivers."""
    real = flow_suite.pack_lanes_into
    (chunks,) = _windows(n=1)
    first = chunks[0]["ip_src"].__array_interface__["data"][0]

    def flaky_pack(cols, out):
        # the first rows of the window: the first group's first pack
        if cols["ip_src"].__array_interface__["data"][0] == first:
            raise ValueError("bad chunk")
        real(cols, out)

    monkeypatch.setattr(staging.flow_suite, "pack_lanes_into", flaky_pack)
    e = _port(wire="lanes", prefetch_depth=2, pack_workers=2)
    try:
        sent = _feed(e, chunks)
        assert e._feed.drain(30)
        c = e.counters()
        assert c["pack_task_errors"] == 1
        assert c["feed_crash_recoveries"] == 1
        assert e.lost_rows == B
        out = e.flush_window()
    finally:
        e.close()
    assert int(out.rows) + e.lost_rows == sent


def test_exporter_contract_in_jax_registry():
    """Registered in the JAX package's Exporters registry: chunks
    arrive through put() and the worker thread, other streams are
    filtered, pending() counts the feed window through pending_extra,
    and the window thread closes windows."""
    e = _port(wire="dict", prefetch_depth=2, window_seconds=3600)
    ex = Exporters(breaker_cfg=None)
    ex.register(e)
    ex.start()
    try:
        (chunks,) = _windows(n=1)
        sent = 0
        for c in chunks:
            ex.put("l4_flow_log", 0, c)
            ex.put("l7_flow_log", 0, c)
            sent += len(c["ip_src"])
        deadline = time.monotonic() + 30
        while e.processed < len(chunks) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert e.processed == len(chunks) and ex.filtered_count == len(chunks)
        assert e.pending_extra() >= 1
        assert ex.pending() == len(e.queue) + e.pending_extra()
        out = e.flush_window()
        assert int(out.rows) == sent and ex.pending() == 0
    finally:
        ex.close()
    assert e.counters()["rows_in"] == sent


def test_window_thread_closes_windows():
    e = _port(wire="lanes", prefetch_depth=2, window_seconds=0.05)
    e.start()
    try:
        (chunks,) = _windows(n=1)
        for c in chunks:
            e.put("l4_flow_log", 0, c)
        deadline = time.monotonic() + 30
        while e.windows < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert e.windows >= 2
        names = {t["name"] for t in default_supervisor().threads()
                 if t["alive"]}
        assert {"tpu_sketch-0", "tpu-sketch-window"} <= names
    finally:
        e.close()
    assert e.rows_in == sum(len(c["ip_src"]) for c in chunks)


# -- the runtime pieces on their own ------------------------------------------

def test_supervisor_restarts_with_backoff_and_flags_a_stale_worker():
    import threading

    from deepflow_tpu_torch.runtime.supervisor import Supervisor

    sup = Supervisor(backoff_base_s=0.01, backoff_cap_s=0.05,
                     deadman_s=0.05, monitor_interval_s=0.01)
    runs, release = [], threading.Event()

    def target():
        runs.append(1)
        if len(runs) < 3:
            raise ValueError("boom")
        release.wait(10)                  # alive, never beating

    h = sup.spawn("worker", target)
    try:
        deadline = time.monotonic() + 10
        while not (len(runs) == 3 and "worker" in sup.check_deadman()):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert h.restarts == 2 and h.crashes == 2
        log = sup.crash_log()
        assert len(log) == 2 and "ValueError" in log[0]["traceback"]
        assert sup.counters()["stale"] == 1
    finally:
        release.set()
        h.join(10)
        sup.close()
    assert not h.is_alive() and h.done


def test_fault_spec_schedule_is_seeded_and_strict():
    from deepflow_tpu_torch.runtime.faults import FaultRegistry, InjectedFault

    reg = FaultRegistry()
    assert reg.arm_spec("tpu.device_error:count=2,after=1,match=dict;"
                        "seed=7") == ["tpu.device_error"]
    fired = [reg.should_fire("tpu.device_error", k)
             for k in ("lanes", "dict", "dict", "dict", "dict")]
    assert fired == [False, False, True, True, False]
    once = FaultRegistry()
    once.arm("checkpoint.torn", count=1)
    with pytest.raises(InjectedFault):
        once.maybe_raise("checkpoint.torn")
    once.maybe_raise("checkpoint.torn")       # the count is spent
    probs = [FaultRegistry(seed=3), FaultRegistry(seed=3)]
    for r in probs:
        r.arm("exporter.process", p=0.5)
    assert [probs[0].should_fire("exporter.process") for _ in range(32)] \
        == [probs[1].should_fire("exporter.process") for _ in range(32)]
    for bad in ("tpu.device_error", "x:count", "x:bogus=1"):
        with pytest.raises(ValueError):
            FaultRegistry().arm_spec(bad)
    reg.disarm()
    assert not reg.enabled


def test_overwrite_queue_drops_oldest_counted():
    from deepflow_tpu_torch.runtime.queues import OverwriteQueue

    q = OverwriteQueue("q", 3)
    q.puts([1, 2, 3, 4, 5])
    assert len(q) == 3 and q.overwritten == 2
    assert q.gets(10, timeout=0) == [3, 4, 5]
    assert q.gets(10, timeout=0.01) == []
    q.close()
    q.put(6)
    assert q.counters()["closed_dropped"] == 1 and q.closed


def test_feed_releases_a_group_only_after_its_fence():
    """Depth 2: the third dispatch fences the first; a group's release
    (its staging buffers back to the pool) follows its fence's
    synchronize, never precedes it; drain fences the rest."""
    from deepflow_tpu_torch.runtime.feed import DeviceFeed, InFlight

    events = []

    class Fence:
        def __init__(self, i):
            self.i = i

        def synchronize(self):
            events.append(("sync", self.i))

    def process(group):
        (i, _), = group
        events.append(("dispatch", i))
        return InFlight(Fence(i), 10,
                        lambda: events.append(("release", i)))

    feed = DeviceFeed("test-feed", process, depth=2)
    try:
        for i in range(4):
            feed.put(i)
        assert feed.drain(10)
        assert feed.pending() == 0 and feed.fences == 4
    finally:
        feed.close()
    for i in range(4):
        assert events.index(("sync", i)) < events.index(("release", i))
    assert events.index(("sync", 0)) < events.index(("dispatch", 3))
    assert events.index(("dispatch", 2)) < events.index(("sync", 0))
