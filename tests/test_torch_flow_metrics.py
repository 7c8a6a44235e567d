"""The port's flow_metrics pipeline store lane (deepflow_tpu_torch/pipelines/)
and its table schemas against the JAX package's, on the CPU.

The JAX pipeline takes its Documents from a receiver socket and decodes
them with protobuf; the port's starts at the decoded METRIC_SCHEMA chunk
those unmarshallers hand on. So the reference here is what the JAX
pipeline does with a decoded chunk: its StoreWriter and RollupManager
fed the same chunks. The base table is compared as a set of rows (two
unmarshallers interleave their appends); the rollup tier row for row,
in order.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from deepflow_tpu.batch import schema as jbatch
from deepflow_tpu.pipelines import schemas as jschemas
from deepflow_tpu.pipelines import tag_code as jtag
from deepflow_tpu.store import db as jdb
from deepflow_tpu.store import migrate as jmig
from deepflow_tpu.store import rollup as jr
from deepflow_tpu.store import writer as jwriter
from deepflow_tpu_torch.batch import schema as tbatch
from deepflow_tpu_torch.pipelines import flow_metrics as tfm
from deepflow_tpu_torch.pipelines import schemas as tschemas
from deepflow_tpu_torch.pipelines import tag_code as ttag
from deepflow_tpu_torch.store import db as tdb

DB = "flow_metrics"
BASE, TIER = "vtap_flow_port", "vtap_flow_port.1m"


def test_metrics_tables_match_jax():
    assert tschemas.METRICS_TABLE.to_json() == jschemas.METRICS_TABLE.to_json()
    assert tschemas.EDGE_METRICS_TABLE.to_json() == \
        jschemas.EDGE_METRICS_TABLE.to_json()
    t = tschemas.METRICS_TABLE
    assert len(t.columns) == 66
    keys = [c for c in t.columns if c.agg.value == "key"]
    assert len(keys) == 17 and t.spec("tag_code").dtype == np.uint64
    assert tbatch.METRIC_SCHEMA.columns == jbatch.METRIC_SCHEMA.columns
    assert tbatch.METRIC_SCHEMA.name == jbatch.METRIC_SCHEMA.name
    assert {c.name: int(c) for c in ttag.Code} == \
        {c.name: int(c) for c in jtag.Code}
    assert ttag.FLOW_METER == jtag.FLOW_METER
    assert int(ttag.VTAP_FLOW_PORT) == int(jtag.VTAP_FLOW_PORT)
    assert int(ttag.VTAP_FLOW_EDGE_PORT) == int(jtag.VTAP_FLOW_EDGE_PORT)
    assert ttag.has_edge_tag(ttag.VTAP_FLOW_EDGE_PORT)
    assert not ttag.has_edge_tag(ttag.VTAP_FLOW_PORT)
    code = ttag.Code.IP_PATH | ttag.Code.VTAP_ID | ttag.Code.ENDPOINT
    assert ttag.make_metrics_table("x", code, ttl_seconds=5).to_json() == \
        jtag.make_metrics_table("x", jtag.Code(int(code)),
                                ttl_seconds=5).to_json()
    with pytest.raises(ValueError, match="unmodeled"):
        ttag.tag_columns(ttag.Code(1 << 2))


def documents(rng, n, t0, span=120):
    """Decoded METRIC_SCHEMA chunk: few distinct tag tuples (so the 1m
    tier merges many rows per group), signed l3_epc_id with -1, u32
    meters near the top of the range (60 s sums saturate the clip)."""
    out = {name: np.zeros(n, dt) for name, dt in tbatch.METRIC_SCHEMA.columns}
    for name in ("ip", "server_port", "protocol"):
        out[name] = rng.integers(0, 3, n).astype(np.uint32)
    out["timestamp"] = (t0 + rng.integers(0, span, n)).astype(np.uint32)
    out["tag_code"] = np.full(n, int(ttag.VTAP_FLOW_PORT), np.uint64)
    out["l3_epc_id"] = rng.integers(-1, 2, n).astype(np.int32)
    for name in ttag.FLOW_METER:
        big = rng.random(n) < 0.05
        out[name] = np.where(
            big, np.uint32(0xFFFFFFF0),
            rng.integers(0, 1000, n)).astype(np.uint32)
    return out


def _chunks(seed=0, n_chunks=12, rows=200, t0=1_700_000_040):
    rng = np.random.default_rng(seed)
    return [documents(rng, rows, t0) for _ in range(n_chunks)]


class Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.calls = []

    def put(self, stream, index, cols):
        with self.lock:
            self.calls.append((stream, index, len(cols["timestamp"])))


def _jax_reference(root, chunks, old_schema=None):
    """What the JAX pipeline does with decoded chunks: migrations, its
    RollupManager and StoreWriter, the final advance."""
    store = jdb.Store(root)
    if old_schema is not None:
        store.create_table(DB, old_schema)
    issu = jmig.Issu(store, DB)
    jschemas.register_standard_migrations(issu)
    issu.run()
    mgr = jr.RollupManager(store, DB, jschemas.METRICS_TABLE,
                           intervals=(60,))
    w = jwriter.StoreWriter(mgr.base)
    for c in chunks:
        w.put(c)
    w.close()
    mgr.advance(time.time() + 120)
    return store


def rows_sorted(cols):
    order = np.lexsort(tuple(cols[k] for k in reversed(list(cols))))
    return {k: v[order] for k, v in cols.items()}


def assert_scan_equal(a, b, what=""):
    assert list(a) == list(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{what} {k}"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def _pipeline(root, **kw):
    kw.setdefault("rollup_period", 3600.0)
    return tfm.FlowMetricsPipeline(tdb.Store(root), device="cpu", **kw)


def test_pipeline_rows_match_jax(tmp_path):
    chunks = _chunks()
    rec = Recorder()
    pipe = _pipeline(str(tmp_path / "port"), exporters=rec,
                     n_unmarshallers=2)
    pipe.start()
    try:
        for c in chunks:
            pipe.put(c)
    finally:
        pipe.close()
    sent = sum(len(c["timestamp"]) for c in chunks)
    assert pipe.counters()["records"] == sent
    assert pipe.counters()["decode_errors"] == 0
    assert sorted(c[2] for c in rec.calls) == [200] * len(chunks)
    assert {c[0] for c in rec.calls} == {"flow_metrics"}
    assert {c[1] for c in rec.calls} == {0, 1}     # round robin
    js = _jax_reference(str(tmp_path / "jax"), chunks)
    ts = tdb.Store(str(tmp_path / "port"))
    assert ts.table(DB, BASE).row_count() == sent
    assert_scan_equal(rows_sorted(js.table(DB, BASE).scan()),
                      rows_sorted(ts.table(DB, BASE).scan()), "base")
    want = js.table(DB, TIER).scan()
    assert_scan_equal(want, ts.table(DB, TIER).scan(), "1m")
    assert_scan_equal(want, jdb.Store(str(tmp_path / "port"))
                      .table(DB, TIER).scan(), "1m via the JAX Store")
    assert (want["packet_tx"] == 0xFFFFFFFF).any()   # the u32 clip
    assert len(want["timestamp"]) < sent
    # a fresh manager recovers the watermark: nothing rebuilt
    assert pipe.rollups.advance(time.time() + 120) == {60: 0}
    pipe2 = _pipeline(str(tmp_path / "port"))
    assert pipe2.rollups.advance(time.time() + 120) == {60: 0}


def test_pipeline_decode_errors(tmp_path):
    chunks = _chunks(seed=1, n_chunks=4)
    missing = dict(chunks[0])
    del missing["rtt_max"]
    ragged = dict(chunks[1])
    ragged["ip"] = ragged["ip"][:-3]
    pipe = _pipeline(str(tmp_path), n_unmarshallers=1)
    pipe.start()
    try:
        for c in (missing, chunks[2], ragged, "not a chunk", chunks[3]):
            pipe.put(c)
    finally:
        pipe.close()
    assert pipe.counters()["decode_errors"] == 200 + 200 + 1
    assert pipe.counters()["records"] == 400
    assert pipe.rollups.base.row_count() == 400


def test_pipeline_close_drains(tmp_path):
    """close() drains the queues and the writer before its final
    advance: every row put lands, even with no wait before close."""
    chunks = _chunks(seed=2, n_chunks=40, rows=50)
    pipe = _pipeline(str(tmp_path), n_unmarshallers=3)
    pipe.start()
    for c in chunks:
        pipe.put(c)
    pipe.close()
    assert pipe.counters()["records"] == 2000
    assert pipe.rollups.base.row_count() == 2000
    tier = tdb.Store(str(tmp_path)).table(DB, TIER).scan()
    assert int(tier["new_flow"].astype(np.int64).sum()) > 0


def test_pipeline_upgrades_old_store(tmp_path):
    """A data root written before tag_code: the pipeline replays the
    standard migrations at startup, as the JAX pipeline does."""
    old = dataclasses.replace(
        tschemas.METRICS_TABLE,
        columns=tuple(c for c in tschemas.METRICS_TABLE.columns
                      if c.name != "tag_code"), version=1)
    rng = np.random.default_rng(5)
    pre = documents(rng, 100, 1_700_000_040)
    pre_old = {k: v for k, v in pre.items() if k != "tag_code"}
    for root in (tmp_path / "port", tmp_path / "jax"):
        tdb.Store(str(root)).create_table(DB, old).append(pre_old)
    chunks = [documents(rng, 100, 1_700_000_040) for _ in range(3)]
    pipe = _pipeline(str(tmp_path / "port"))
    assert pipe.rollups.base.schema.version == 2
    assert "tag_code" in pipe.rollups.base.schema.column_names
    pipe.start()
    try:
        for c in chunks:
            pipe.put(c)
    finally:
        pipe.close()
    js = _jax_reference(str(tmp_path / "jax"), chunks)
    ts = tdb.Store(str(tmp_path / "port"))
    base = ts.table(DB, BASE).scan()
    assert (base["tag_code"] == 0).sum() == 100     # old rows read 0
    assert_scan_equal(rows_sorted(js.table(DB, BASE).scan()),
                      rows_sorted(base))
    assert_scan_equal(js.table(DB, TIER).scan(), ts.table(DB, TIER).scan())


def test_pipeline_ticker_builds_rollups(tmp_path):
    """The supervised ticker advances the rollups on its period."""
    chunks = _chunks(seed=3, n_chunks=2)
    root = str(tmp_path / "port")
    pipe = _pipeline(root, rollup_period=0.05)
    for c in chunks:
        pipe.rollups.base.append(c)
    pipe.start()
    try:
        deadline = time.time() + 20
        while time.time() < deadline and not any(
                d["built_until"] for d in pipe.rollups.list_datasources()):
            time.sleep(0.05)
        assert any(d["built_until"] for d in pipe.rollups.list_datasources())
    finally:
        pipe.close()
    js = _jax_reference(str(tmp_path / "jax"), chunks)
    assert_scan_equal(js.table(DB, TIER).scan(),
                      tdb.Store(root).table(DB, TIER).scan())


def test_pipeline_without_store():
    rec = Recorder()
    pipe = tfm.FlowMetricsPipeline(None, exporters=rec, device="cpu")
    assert pipe.writer is None and pipe.rollups is None
    pipe.start()
    try:
        for c in _chunks(seed=4, n_chunks=3):
            pipe.put(c, key=7)
    finally:
        pipe.close()
    assert pipe.counters()["records"] == 600
    assert [c[1] for c in rec.calls] == [1, 1, 1]   # one key, one worker


def test_pipeline_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.FlowMetricsPipeline(tdb.Store(str(tmp_path)))


def test_pipeline_counters_under_contention(tmp_path):
    """More unmarshallers than cores and a short switch interval: no
    count is lost between the workers (records and decode_errors are
    read-modify-writes from every worker)."""
    import os
    import sys
    rng = np.random.default_rng(6)
    chunks = [documents(rng, 7, 1_700_000_040) for _ in range(300)]
    bad = {"timestamp": np.zeros(5, np.uint32)}
    workers = 2 * (os.cpu_count() or 1) + 1
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pipe = _pipeline(str(tmp_path), n_unmarshallers=workers)
        pipe.start()
        handles = list(pipe._handles)
        try:
            for c in chunks:
                pipe.put(c)
                pipe.put(bad)
        finally:
            pipe.close()
    finally:
        sys.setswitchinterval(old)
    assert len(handles) == workers + 1
    assert not any(h.is_alive() for h in handles)
    assert pipe.counters()["records"] == 300 * 7
    assert pipe.counters()["decode_errors"] == 300 * 5
    assert pipe.rollups.base.row_count() == 300 * 7
