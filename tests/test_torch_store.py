"""The port's store write half (deepflow_tpu_torch/store/) against the JAX
package's Store, and the l4 exporter's store writers against the JAX
exporter's, on the CPU.

The on-disk layout is shared: a JAX Store opened on the port's directory
reads its manifests back through its own `from_json` and scans its
segments. The exporters' rows are compared row for row: every integer
column exactly; the entropy columns within rtol 1e-5, atol 1e-6, and
`distinct_clients` (a float32 sum of HLL estimates cut to an integer)
within one, because XLA-CPU and ATen round log/exp apart in the last
ulp. Every exporter and writer is closed in a `finally`.
"""

import json
import os

import numpy as np
import pytest

from deepflow_tpu.models import flow_suite as jfs
from deepflow_tpu.replay.generator import ddos_ramp
from deepflow_tpu.runtime import tpu_sketch as jts
from deepflow_tpu.store import db as jdb
from deepflow_tpu.store import table as jtable
from deepflow_tpu_torch.models import flow_suite
from deepflow_tpu_torch.runtime import app_red as tred
from deepflow_tpu_torch.runtime import tpu_sketch as tts
from deepflow_tpu_torch.store import db as tdb
from deepflow_tpu_torch.store import table as ttable
from deepflow_tpu_torch.store.writer import StoreWriter
from deepflow_tpu_torch.utils.u32 import fold_columns_np

_SMALL = dict(cms_log2_width=12, ring_size=256, hll_groups=64,
              hll_precision=8, entropy_log2_buckets=10)
B = 512
F32_TOL = dict(rtol=1e-5, atol=1e-6)


def _schemas():
    """The port's tables, and one exercising every schema field."""
    custom = ttable.TableSchema(
        name="custom", columns=(
            ttable.ColumnSpec("ts", np.dtype(np.uint32),
                              ttable.AggKind.KEY),
            ttable.ColumnSpec("v", np.dtype(np.int64), ttable.AggKind.SUM,
                              default=7),
            ttable.ColumnSpec("f", np.dtype(np.float64),
                              ttable.AggKind.MIN),
            ttable.ColumnSpec("n", np.dtype(np.uint16),
                              ttable.AggKind.COUNT)),
        time_column="ts", partition_seconds=60, ttl_seconds=None, version=3,
        aliases=(("old_v", "v"),))
    return [tts.TOPK_TABLE, tts.WINDOW_TABLE, tred.APP_RED_TABLE,
            tred.app_red_table((0.9, 0.995)), custom]


def _jax_schema(s: ttable.TableSchema) -> jtable.TableSchema:
    """The same schema built with the JAX package's classes."""
    return jtable.TableSchema(
        name=s.name,
        columns=tuple(jtable.ColumnSpec(c.name, c.dtype,
                                        jtable.AggKind(c.agg.value),
                                        c.default) for c in s.columns),
        time_column=s.time_column, partition_seconds=s.partition_seconds,
        ttl_seconds=s.ttl_seconds, version=s.version, aliases=s.aliases)


@pytest.mark.parametrize("schema", _schemas(), ids=lambda s: s.name)
def test_manifest_json_equals_jax(schema, tmp_path):
    jschema = _jax_schema(schema)
    assert schema.to_json() == jschema.to_json()
    tdb.Store(str(tmp_path / "t")).create_table("db", schema)
    jdb.Store(str(tmp_path / "j")).create_table("db", jschema)
    rel = os.path.join("db", schema.name, "manifest.json")
    assert (tmp_path / "t" / rel).read_text() == \
        (tmp_path / "j" / rel).read_text()
    back = ttable.TableSchema.from_json(
        json.loads((tmp_path / "j" / rel).read_text()))
    assert back == schema


def _chunk(rng, n, t0, span):
    return {"ts": (t0 + rng.integers(0, span, n)).astype(np.uint32),
            "v": rng.integers(-5, 5, n).astype(np.int64),
            "f": rng.random(n),
            "n": rng.integers(0, 9, n).astype(np.uint16)}


def test_jax_store_scans_the_ports_segments(tmp_path):
    """Chunks split by partition, the sequence resumes on reopen (a
    crash's .tmp cleared), and a fresh JAX Store scans every row."""
    schema = _schemas()[-1]
    rng = np.random.default_rng(21)
    root = str(tmp_path)
    store = tdb.Store(root)
    t = store.create_table("db", schema)
    chunks = [_chunk(rng, 100, 6000, 150), _chunk(rng, 50, 6100, 30)]
    assert t.append(chunks[0]) == 100
    assert t.append(chunks[1]) == 50
    parts = t.partitions()
    assert parts == sorted({int(x) // 60 * 60 for c in chunks
                            for x in c["ts"]})
    assert t.segments_written == sum(len({int(x) // 60 for x in c["ts"]})
                                     for c in chunks)
    pdir = os.path.join(root, "db", "custom", f"p{parts[0]:012d}")
    open(os.path.join(pdir, "seg-00009999.npz.tmp"), "wb").close()
    reopened = tdb.Store(root)
    assert reopened.has_table("db", "custom")
    assert not reopened.has_table("db", "nope")
    t2 = reopened.table("db", "custom")
    assert t2.schema == schema
    assert not any(f.endswith(".tmp") for f in os.listdir(pdir))
    assert t2._seq == t.segments_written
    chunks.append(_chunk(rng, 40, 5990, 20))
    t2.append(chunks[2])
    names = sorted(f for p in t2.partitions() for f in os.listdir(
        os.path.join(root, "db", "custom", f"p{p:012d}")))
    assert len(names) == len(set(names))
    rows = jdb.Store(root).table("db", "custom").scan()
    want = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    order = np.lexsort((rows["v"], rows["f"], rows["ts"]))
    worder = np.lexsort((want["v"], want["f"], want["ts"]))
    for k in want:
        assert rows[k].dtype == want[k].dtype
        np.testing.assert_array_equal(rows[k][order], want[k][worder])


def test_validate_chunk_raises_where_jax_does(tmp_path):
    schema = _schemas()[-1]
    jschema = _jax_schema(schema)
    rng = np.random.default_rng(22)
    good = _chunk(rng, 10, 0, 10)
    missing = {k: v for k, v in good.items() if k != "f"}
    ragged = dict(good, n=good["n"][:3])
    for table in (schema, jschema):
        assert table.validate_chunk(good) == 10
        assert table.validate_chunk(dict(good, extra=np.zeros(2))) == 10
        with pytest.raises(KeyError):
            table.validate_chunk(missing)
        with pytest.raises(ValueError):
            table.validate_chunk(ragged)
    t = tdb.Store(str(tmp_path)).create_table("db", schema)
    with pytest.raises(KeyError):
        t.append(missing)
    assert t.append({k: v[:0] for k, v in good.items()}) == 0
    with pytest.raises(ValueError):
        ttable.TableSchema("x", (ttable.ColumnSpec("a", np.dtype(np.uint32)),))


def test_store_writer_batches_and_drains(tmp_path):
    """Below the batch nothing is written; crossing it writes one merged
    segment (inline without a thread, on the flush thread with one);
    close() drains the rest."""
    schema = _schemas()[-1]
    rng = np.random.default_rng(23)
    t = tdb.Store(str(tmp_path)).create_table("db", schema)
    w = StoreWriter(t, batch_rows=100, flush_interval=3600)
    w.put(_chunk(rng, 60, 0, 10))
    assert t.rows_written == 0 and w.counters()["pending_rows"] == 60
    w.put(_chunk(rng, 60, 0, 10))
    assert t.rows_written == 120 and t.segments_written == 1
    w.start()
    try:
        w.put(_chunk(rng, 150, 0, 10))
        for _ in range(200):
            if t.rows_written == 270:
                break
            import time
            time.sleep(0.01)
        assert t.rows_written == 270
        w.put(_chunk(rng, 5, 0, 10))
    finally:
        w.close()
    assert t.rows_written == 275 and w.counters()["flushes"] == 3
    assert len(jdb.Store(str(tmp_path)).table("db", "custom").scan()["ts"]) \
        == 275


# -- the l4 exporter's writers against the JAX exporter's --------------------

def _windows(first=11, n=2, rows=1500, chunk=700):
    ramp = ddos_ramp(rows_per_window=rows)
    out = []
    for w in range(first, first + n):
        _, cols = ramp.window_cols(w)
        total = len(cols["ip_src"])
        out.append([{k: v[s:s + chunk] for k, v in cols.items()}
                    for s in range(0, total, chunk)])
    return out


def _scan(root, table):
    return jdb.Store(root).table(tts.SKETCH_DB, table).scan()


@pytest.mark.parametrize("wire", ["dict", "lanes"])
@pytest.mark.parametrize("depth", [0, 2], ids=["inline", "feed"])
def test_sketch_rows_match_jax_exporter(wire, depth, tmp_path):
    """topk_flows and window_signals, written by both exporters over the
    same windows with pinned window times, scanned by a fresh JAX Store
    from each directory: row for row equal; every resolved 5-tuple folds
    back to its flow key."""
    knobs = dict(wire=wire, prefetch_depth=depth, coalesce_batches=2,
                 batch_rows=B, window_seconds=3600)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jexp = jts.TpuSketchExporter(
        store=jdb.Store(jroot), cfg=jfs.FlowSuiteConfig(**_SMALL),
        zero_copy=True, **knobs)
    texp = tts.TpuSketchExporter(
        store=tdb.Store(troot), cfg=flow_suite.FlowSuiteConfig(**_SMALL),
        device="cpu", **knobs)
    try:
        for w, chunks in enumerate(_windows()):
            for c in chunks:
                jexp.process([("l4_flow_log", 0, c, -1)])
                texp.process([("l4_flow_log", 0, c, -1)])
            jexp.flush_window(now=5000.0 + w)
            texp.flush_window(now=5000.0 + w)
    finally:
        jexp.close()
        texp.close()
    jt, tt = _scan(jroot, "topk_flows"), _scan(troot, "topk_flows")
    assert len(tt["flow_key"]) > 0
    for name in ("timestamp", "rank", "flow_key", "count", "ip_src",
                 "ip_dst", "port_src", "port_dst", "proto"):
        assert tt[name].dtype == jt[name].dtype == np.uint32
        np.testing.assert_array_equal(tt[name], jt[name], err_msg=name)
    resolved = tt["proto"] > 0
    assert resolved.any()
    np.testing.assert_array_equal(
        fold_columns_np([tt[k][resolved] for k in
                         ("ip_src", "ip_dst", "port_src", "port_dst",
                          "proto")]), tt["flow_key"][resolved])
    jw, tw = _scan(jroot, "window_signals"), _scan(troot, "window_signals")
    # the two pinned windows, then the empty window close() flushes at
    # the wall clock
    for rows in (tw, jw):
        assert rows["timestamp"][:2].tolist() == [5000, 5001]
        assert len(rows["timestamp"]) == 3 and rows["rows"][2] == 0
    assert abs(int(tw["timestamp"][2]) - int(jw["timestamp"][2])) < 60
    np.testing.assert_array_equal(tw["rows"], jw["rows"])
    for name in ("entropy_ip_src", "entropy_ip_dst", "entropy_port_src",
                 "entropy_port_dst"):
        np.testing.assert_allclose(tw[name], jw[name], **F32_TOL)
    assert np.all(np.abs(tw["distinct_clients"].astype(np.int64)
                         - jw["distinct_clients"].astype(np.int64)) <= 1)


def test_writers_on_the_degraded_host_window(tmp_path):
    """A CPU device degraded onto the host fallback still writes its
    window; flush() drains without closing."""
    from deepflow_tpu_torch.runtime.faults import default_faults
    texp = tts.TpuSketchExporter(
        store=tdb.Store(str(tmp_path)),
        cfg=flow_suite.FlowSuiteConfig(**_SMALL), batch_rows=B,
        window_seconds=3600, wire="dict", device="cpu")
    faults = default_faults()
    try:
        faults.arm("tpu.device_error", count=2, match="dict")
        (chunks,) = _windows(n=1)
        for c in chunks:
            texp.process([("l4_flow_log", 0, c, -1)])
        assert texp.degraded
        out = texp.flush_window(now=7000.0)
        assert out is not None and texp.host_rows > 0
        texp.flush()
        rows = _scan(str(tmp_path), "window_signals")
        assert rows["timestamp"].tolist() == [7000]
        assert rows["rows"].tolist() == [int(out.rows)]
        assert len(_scan(str(tmp_path), "topk_flows")["rank"]) > 0
    finally:
        faults.disarm()
        texp.close()
