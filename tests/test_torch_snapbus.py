"""Snapshots in the reference's own format: a directory the port writes
restores through the JAX package's SnapshotBus and one the JAX package
writes restores through the port's; the JAX serving stack answers
`sketch.topk` off the port's snapshots as off its own; torn files are
skipped; an exporter restores its last snapshot at construction. Also
the leaf order `convert` relies on, and the copies `state_to_numpy`
must return."""

import os

import jax
import numpy as np
import pytest

from deepflow_tpu.models import flow_suite as jfs
from deepflow_tpu.replay.generator import ddos_ramp
from deepflow_tpu.runtime import tpu_sketch as jts
from deepflow_tpu.runtime.snapbus import SnapshotBus as JaxBus
from deepflow_tpu.serving import SketchTables, SnapshotCache
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.models import flow_suite
from deepflow_tpu_torch.runtime.faults import default_faults
from deepflow_tpu_torch.runtime.snapbus import SnapshotBus
from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter

_SMALL = dict(cms_log2_width=12, ring_size=256, hll_groups=64,
              hll_precision=8, entropy_log2_buckets=10)


@pytest.fixture(autouse=True)
def _clean_faults():
    default_faults().disarm()
    yield
    default_faults().disarm()


def _chunks(w, rows=1500, chunk=600):
    _, cols = ddos_ramp(rows_per_window=rows).window_cols(w)
    return [{k: v[s:s + chunk] for k, v in cols.items()}
            for s in range(0, len(cols["ip_src"]), chunk)]


def _run_port(ck, windows=(11, 12), **kw):
    e = TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(**_SMALL),
                          batch_rows=512, window_seconds=3600,
                          checkpoint_dir=ck, wire="dict", prefetch_depth=2,
                          device="cpu", **kw)
    try:
        for w in windows:
            for c in _chunks(w):
                e.process([("l4_flow_log", 0, c, -1)])
            e.flush_window(now=1000.0 + w)
    finally:
        e.close()
    return e


def _run_jax(ck, windows=(11, 12)):
    e = jts.TpuSketchExporter(store=None, cfg=jfs.FlowSuiteConfig(**_SMALL),
                              batch_rows=512, window_seconds=3600,
                              checkpoint_dir=ck, wire="dict",
                              prefetch_depth=2)
    try:
        for w in windows:
            for c in _chunks(w):
                e.process([("l4_flow_log", 0, c, -1)])
            e.flush_window(now=1000.0 + w)
    finally:
        e.close()
    return e


def test_suite_leaves_match_the_jax_leaf_order():
    js = jfs.init(jfs.FlowSuiteConfig(**_SMALL))
    paths, _ = jax.tree_util.tree_flatten_with_path(js)
    names = [".".join(p.name for p in path) for path, _ in paths]
    assert names == [name for name, _ in convert.SUITE_LEAVES]
    assert [np.asarray(x).dtype for _, x in paths] == \
        [np.dtype(dt) for _, dt in convert.SUITE_LEAVES]


def test_state_to_numpy_returns_copies():
    """On the CPU `.cpu()` is the live tensor; leaves taken before an
    in-place update must not change with it."""
    cfg = flow_suite.FlowSuiteConfig(**_SMALL)
    st = flow_suite.init(cfg, device="cpu")
    before = convert.state_to_numpy(st)
    st.sketch.counts.add_(1)
    st.services.registers.fill_(3)
    assert before[0].sum() == 0 and before[4].sum() == 0


def test_state_from_numpy_keeps_every_leaf_shape():
    """The 0-d leaves (rows_seen, batches_seen) stay 0-d: a restored
    state must have the shapes of a fresh one, or its window readout
    comes out with rows of shape (1,)."""
    cfg = flow_suite.FlowSuiteConfig(**_SMALL)
    leaves = convert.state_to_numpy(flow_suite.init(cfg, device="cpu"))
    st, _ = convert.state_from_numpy(leaves, device="cpu")
    assert [a.shape for a in convert.state_to_numpy(st)] == \
        [a.shape for a in leaves]
    assert st.rows_seen.shape == st.batches_seen.shape == ()
    _, out = flow_suite.flush(st, cfg)
    assert out.rows.shape == ()


def test_port_snapshots_restore_through_jax(tmp_path):
    ck = str(tmp_path / "port")
    e = _run_port(ck)
    files = sorted(os.listdir(ck))
    assert files == ["sketch-000000000001.npz", "sketch-000000000002.npz"]
    with np.load(os.path.join(ck, files[-1])) as z:
        assert {"leaf_0", "leaf_8", "__step", "__wall", "__tags"} \
            <= set(z.files)
        assert z["leaf_1"].dtype == np.uint32 and int(z["__step"]) == 2
    restored = JaxBus(ck).restore(jfs.init(jfs.FlowSuiteConfig(**_SMALL)))
    assert restored is not None
    ref = e.snapshot_bus.latest().leaves
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(restored)),
                    ref):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_jax_snapshots_restore_through_the_port(tmp_path):
    ck = str(tmp_path / "jax")
    je = _run_jax(ck)
    ref = [np.asarray(x) for x in je.snapshot_bus.latest().leaves]
    bus = SnapshotBus(ck)
    st = bus.restore(flow_suite.init(flow_suite.FlowSuiteConfig(**_SMALL),
                                     device="cpu"))
    assert st is not None and bus.last_restored_step == 2
    for a, b in zip(convert.state_to_numpy(st), ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_jax_serving_answers_off_port_snapshots(tmp_path, capsys):
    from deepflow_tpu.cli import main as cli_main

    port_ck, jax_ck = str(tmp_path / "port"), str(tmp_path / "jax")
    _run_port(port_ck)
    _run_jax(jax_ck)
    answers = []
    for ck in (port_ck, jax_ck):
        tables = SketchTables(SnapshotCache(JaxBus(ck),
                                            max_staleness_s=float("inf")))
        answers.append((tables.topk(10), tables.entropy(), tables.hll_card()))
    assert answers[0][0] == answers[1][0] and len(answers[0][0]) == 10
    assert answers[0][1] == answers[1][1] and answers[0][2] == answers[1][2]
    assert cli_main(["query", "--snapshots", port_ck,
                     "SELECT sketch.topk(3) FROM sketch"]) == 0
    out = capsys.readouterr().out
    assert "flow_key" in out and "1012" in out


def test_torn_snapshot_is_skipped(tmp_path):
    ck = str(tmp_path)
    cfg = flow_suite.FlowSuiteConfig(**_SMALL)
    bus = SnapshotBus(ck)
    st = flow_suite.init(cfg, device="cpu")
    st.sketch.counts.add_(5)
    good = bus.publish(st, 1)
    default_faults().arm("checkpoint.torn", count=1)
    bus.publish(flow_suite.init(cfg, device="cpu"), 2)
    assert os.path.getsize(os.path.join(ck, "sketch-000000000002.npz")) \
        < os.path.getsize(good.path)
    for reader in (SnapshotBus(ck), JaxBus(ck)):
        assert reader.read_latest().step == 1
    restored = SnapshotBus(ck).restore(flow_suite.init(cfg, device="cpu"))
    np.testing.assert_array_equal(convert.state_to_numpy(restored)[0],
                                  good.leaves[0])


def test_snapshot_of_another_config_is_refused(tmp_path):
    bus = SnapshotBus(str(tmp_path))
    bus.publish(flow_suite.init(flow_suite.FlowSuiteConfig(**_SMALL),
                                device="cpu"), 1)
    other = flow_suite.FlowSuiteConfig(**dict(_SMALL, cms_log2_width=11))
    assert bus.restore(flow_suite.init(other, device="cpu")) is None
    assert bus.restores == 0


def test_exporter_restores_its_last_snapshot(tmp_path):
    """A fresh exporter over the same checkpoint_dir resumes the last
    published window leaf for leaf, with its step counter past it."""
    ck = str(tmp_path)
    e = _run_port(ck)
    last = e.snapshot_bus.latest()
    fresh = TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(**_SMALL),
                              batch_rows=512, checkpoint_dir=ck,
                              wire="dict", prefetch_depth=2, device="cpu")
    try:
        assert fresh.windows == 2 and fresh.counters()["restores"] == 1
        for a, b in zip(convert.state_to_numpy(fresh.state), last.leaves):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    finally:
        fresh.close()
