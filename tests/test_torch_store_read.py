"""The port's store read half (deepflow_tpu_torch/store/db.py scans,
compaction, quarantine, TTL; store/migrate.py; store/monitor.py) against
the JAX package's, on the CPU.

Both packages share one on-disk layout, so each case runs the two
packages on copies of one directory (or on the same one) and compares
scans exactly, column for column, and the counters and partitions each
side leaves. Segments, compacted partitions and migrated manifests
written by either package are scanned by the other.
"""

import dataclasses
import os
import shutil
import threading
import time

import numpy as np
import pytest

from deepflow_tpu.store import db as jdb
from deepflow_tpu.store import migrate as jmig
from deepflow_tpu.store import monitor as jmon
from deepflow_tpu.store import table as jtable
from deepflow_tpu_torch.store import db as tdb
from deepflow_tpu_torch.store import migrate as tmig
from deepflow_tpu_torch.store import monitor as tmon
from deepflow_tpu_torch.store import table as ttable

U32 = np.dtype(np.uint32)


def _schema(ttl=None, partition=60):
    return ttable.TableSchema(
        name="t", columns=(
            ttable.ColumnSpec("timestamp", U32, ttable.AggKind.KEY),
            ttable.ColumnSpec("ip", U32, ttable.AggKind.KEY),
            ttable.ColumnSpec("bytes", np.dtype(np.uint64),
                              ttable.AggKind.SUM),
            ttable.ColumnSpec("rtt_max", U32, ttable.AggKind.MAX)),
        ttl_seconds=ttl, partition_seconds=partition)


def _jschema(s):
    return jtable.TableSchema.from_json(s.to_json())


def _rows(rng, n, t0=0, span=600):
    return {"timestamp": (t0 + rng.integers(0, span, n)).astype(np.uint32),
            "ip": rng.integers(0, 1 << 32, n, dtype=np.uint64)
            .astype(np.uint32),
            "bytes": rng.integers(0, 1 << 63, n, dtype=np.uint64),
            "rtt_max": rng.integers(0, 1 << 32, n, dtype=np.uint64)
            .astype(np.uint32)}


def assert_scan_equal(a, b, what=""):
    assert list(a) == list(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{what} {k}"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def _filled(root, writer="port", chunks=12, seed=0, schema=None):
    """A store with `chunks` appends (each spread over ~10 partitions),
    written by one package; returns its root."""
    schema = schema or _schema()
    rng = np.random.default_rng(seed)
    store = tdb.Store(root) if writer == "port" else jdb.Store(root)
    t = store.create_table("db", schema if writer == "port"
                           else _jschema(schema))
    for _ in range(chunks):
        t.append(_rows(rng, 300))
    return root


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("time_range", [None, (0, 600), (125, 333),
                                        (59, 61), (600, 900), (300, 300)])
def test_scan_matches_jax(tmp_path, writer, time_range):
    """Partition pruning then row filtering, every column and a subset
    without the time column, on segments either package wrote."""
    root = _filled(str(tmp_path / "s"), writer)
    tt = tdb.Store(root).table("db", "t")
    jt = jdb.Store(root).table("db", "t")
    for cols in (None, ["bytes", "ip"]):
        assert_scan_equal(jt.scan(cols, time_range),
                          tt.scan(cols, time_range), f"{cols} {time_range}")
    assert tt.row_count() == jt.row_count() == 12 * 300
    assert tt.partitions() == jt.partitions()
    with pytest.raises(KeyError):
        tt.scan(["nope"])


def test_scan_empty_table_dtypes(tmp_path):
    tt = tdb.Store(str(tmp_path)).create_table("db", _schema())
    jt = jdb.Store(str(tmp_path)).table("db", "t")
    assert_scan_equal(jt.scan(), tt.scan())
    assert_scan_equal(jt.scan(time_range=(0, 10)), tt.scan(time_range=(0, 10)))
    assert tt.row_count() == 0


@pytest.mark.parametrize("compactor", ["port", "jax"])
def test_compaction_keeps_rows_across_packages(tmp_path, compactor):
    """One package compacts (merge, then the next sweep deletes the
    superseded sources); scans by both stay equal to the scan before,
    in between the two sweeps too (merged.json skips the sources)."""
    root = str(tmp_path / "c")
    t = tdb.Store(root).create_table("db", _schema(partition=3600))
    rng = np.random.default_rng(2)
    for _ in range(12):
        t.append(_rows(rng, 200))
    before = jdb.Store(root).table("db", "t").scan()
    tt, jt = tdb.Store(root).table("db", "t"), jdb.Store(root).table("db", "t")
    c = tt if compactor == "port" else jt
    assert c.compact(min_segments=8) == 12
    pdir = os.path.join(root, "db", "t", "p000000000000")
    assert os.path.exists(os.path.join(pdir, "merged.json"))
    for reader in (tt, jt):
        assert_scan_equal(before, reader.scan())
        assert len(reader._segment_files(reader.partitions())) == 1
    assert c.compact(min_segments=8) == 0       # sources deleted now
    assert not os.path.exists(os.path.join(pdir, "merged.json"))
    assert sorted(os.listdir(pdir)) == ["seg-00000012.npz"]
    for reader in (tt, jt):
        assert_scan_equal(before, reader.scan())
    assert c.counters()["segments_compacted"] == 12


def test_compaction_bounds_and_counters_match_jax(tmp_path):
    """The bounded merge (max_sources, max_segment_bytes, min_segments)
    makes the same choices in both packages on copies of one store."""
    src = _filled(str(tmp_path / "src"), "port", chunks=30, seed=5,
                  schema=_schema(partition=3600))
    shutil.copytree(src, str(tmp_path / "j"))
    tt = tdb.Store(src).table("db", "t")
    jt = jdb.Store(str(tmp_path / "j")).table("db", "t")
    for kw in (dict(max_sources=7), dict(min_segments=100),
               dict(max_segment_bytes=40_000), dict()):
        assert tt.compact(**kw) == jt.compact(**kw), kw
        assert sorted(os.listdir(os.path.join(tt.root, "p000000000000"))) \
            == sorted(os.listdir(os.path.join(jt.root, "p000000000000")))
        assert_scan_equal(jt.scan(), tt.scan())
    assert tt.counters() == jt.counters()


def test_corrupt_segment_skipped_and_quarantined(tmp_path):
    """A torn segment: scan and row_count serve around it and count it;
    compact quarantines it as .bad; the same in both packages."""
    src = str(tmp_path / "p")
    t = tdb.Store(src).create_table("db", _schema(partition=3600))
    for i in range(10):
        t.append({"timestamp": np.full(4, 100, np.uint32),
                  "ip": np.full(4, i, np.uint32),
                  "bytes": np.full(4, i, np.uint64),
                  "rtt_max": np.full(4, i, np.uint32)})
    pdir = os.path.join(t.root, "p000000000000")
    segs = sorted(os.listdir(pdir))
    with open(os.path.join(pdir, segs[3]), "rb+") as f:
        f.truncate(os.path.getsize(os.path.join(pdir, segs[3])) // 2)
    shutil.copytree(src, str(tmp_path / "j"))
    tt = tdb.Store(src).table("db", "t")
    jt = jdb.Store(str(tmp_path / "j")).table("db", "t")
    for x in (tt, jt):
        assert len(x.scan()["ip"]) == 36
        assert x.row_count() == 36
        assert x.counters()["segments_skipped_corrupt"] == 2
    assert tt.compact(min_segments=4) == jt.compact(min_segments=4) == 9
    assert tt.counters() == jt.counters()
    assert tt.counters()["segments_quarantined"] == 1
    assert segs[3] + ".bad" in os.listdir(pdir)
    assert_scan_equal(jt.scan(), tt.scan())
    assert tt.disk_bytes() == jt.disk_bytes() > 0    # .bad still counted
    assert tt.partition_bytes(0) == tt.disk_bytes()


def test_compaction_skips_when_sweep_in_flight(tmp_path):
    root = _filled(str(tmp_path), "port", chunks=10,
                   schema=_schema(partition=3600))
    t = tdb.Store(root).table("db", "t")
    assert t._compact_lock.acquire(blocking=False)
    try:
        assert t.compact(min_segments=4) == 0       # sweep "in flight"
    finally:
        t._compact_lock.release()
    assert t.compact(min_segments=4) == 10


def test_expire_drop_and_sizes_match_jax(tmp_path):
    src = _filled(str(tmp_path / "p"), "port", chunks=5, seed=7,
                  schema=_schema(ttl=300))
    shutil.copytree(src, str(tmp_path / "j"))
    ts, js = tdb.Store(src), jdb.Store(str(tmp_path / "j"))
    tt, jt = ts.table("db", "t"), js.table("db", "t")
    assert tt.disk_bytes() == jt.disk_bytes()
    assert [tt.partition_bytes(p) for p in tt.partitions()] == \
        [jt.partition_bytes(p) for p in jt.partitions()]
    assert tt.expire(now=500) == jt.expire(now=500) == 3   # p0..p120
    assert tt.partitions() == jt.partitions()
    assert_scan_equal(jt.scan(), tt.scan())
    tt.drop_partition(tt.partitions()[0])
    jt.drop_partition(jt.partitions()[0])
    assert_scan_equal(jt.scan(), tt.scan())
    tt.set_ttl(None)
    assert tt.expire(now=1e9) == 0
    assert jdb.Store(src).table("db", "t").schema.ttl_seconds is None
    tt.set_ttl(10)
    jt.set_ttl(10)
    assert ts.expire_all(now=1e9) == js.expire_all(now=1e9) > 0
    assert tt.partitions() == jt.partitions() == []


def test_store_reopen_tables_drop(tmp_path):
    """Reopen (`_load_existing`) picks up the JAX package's tables, and
    the JAX Store picks up the port's; tables/drop_table/expire_all/
    disk_bytes agree."""
    root = str(tmp_path)
    js = jdb.Store(root)
    js.create_table("a", _jschema(_schema(ttl=100))).append(
        _rows(np.random.default_rng(1), 50))
    ts = tdb.Store(root)
    ts.create_table("b", dataclasses.replace(_schema(), name="u")).append(
        _rows(np.random.default_rng(2), 50))
    ts2, js2 = tdb.Store(root), jdb.Store(root)
    assert ts2.tables() == js2.tables() == [("a", "t"), ("b", "u")]
    assert ts2.disk_bytes() == js2.disk_bytes() > 0
    assert [t.schema.to_json() for t in ts2._snapshot()] == \
        [t.schema.to_json() for t in js2._snapshot()]
    assert ts2.expire_all(now=10_000) == 10       # only a.t has a TTL
    assert ts2.table("a", "t").partitions() == []
    assert ts2.drop_table("b", "u") is True
    assert ts2.drop_table("b", "u") is False
    assert not os.path.exists(os.path.join(root, "b", "u"))
    assert jdb.Store(root).tables() == [("a", "t")]


def _ops(mod, spec_mod):
    return [(2, mod.AddColumn("t", spec_mod.ColumnSpec(
                "region", U32, spec_mod.AggKind.KEY, default=42))),
            (3, mod.RenameColumn("t", "bytes", "byte_total")),
            (4, mod.DropColumn("t", "rtt_max")),
            (5, mod.RenameColumn("t", "byte_total", "octets"))]


def test_migrations_match_jax(tmp_path):
    """AddColumn (defaults synthesized for old segments), RenameColumn
    (alias chain) and DropColumn, replayed by both packages' Issu on
    copies of one store: equal manifests, equal scans, and each package
    reads the other's upgraded table."""
    src = _filled(str(tmp_path / "p"), "jax", chunks=3)
    shutil.copytree(src, str(tmp_path / "j"))
    ts, js = tdb.Store(src), jdb.Store(str(tmp_path / "j"))
    ti, ji = tmig.Issu(ts, "db"), jmig.Issu(js, "db")
    for v, op in _ops(tmig, ttable):
        ti.register(v, op)
    for v, op in _ops(jmig, jtable):
        ji.register(v, op)
    ti.register(6, tmig.AddColumn("missing", ttable.ColumnSpec("x", U32)))
    assert ti.run() == ji.run() == {"t": 5}
    assert ti.run() == {}
    with open(os.path.join(src, "db", "t", "manifest.json")) as a, \
            open(os.path.join(str(tmp_path / "j"), "db", "t",
                              "manifest.json")) as b:
        assert a.read() == b.read()
    tt = tdb.Store(src).table("db", "t")
    out = tt.scan()
    assert list(out) == ["timestamp", "ip", "octets", "region"]
    assert (out["region"] == 42).all() and out["region"].dtype == U32
    assert_scan_equal(jdb.Store(str(tmp_path / "j")).table("db", "t").scan(),
                      out)
    assert_scan_equal(jdb.Store(src).table("db", "t").scan(), out)
    # new segments carry the new names; old ones resolve through aliases
    tt.append({"timestamp": np.array([5], np.uint32),
               "ip": np.array([1], np.uint32),
               "octets": np.array([9], np.uint64),
               "region": np.array([7], np.uint32)})
    assert_scan_equal(jdb.Store(src).table("db", "t").scan(), tt.scan())
    with pytest.raises(ValueError, match="time column"):
        tmig.DropColumn("t", "timestamp").apply(tt.schema)


def test_standard_migrations_upgrade_old_metrics_store(tmp_path):
    """A metrics store from before tag_code gains the column on replay
    (version 2); old segments read tag_code = 0; a re-run is a no-op;
    the JAX package's Store reads the upgraded table the same."""
    from deepflow_tpu_torch.pipelines.schemas import (
        METRICS_TABLE, register_standard_migrations)
    old = dataclasses.replace(
        METRICS_TABLE,
        columns=tuple(c for c in METRICS_TABLE.columns
                      if c.name != "tag_code"), version=1)
    store = tdb.Store(str(tmp_path))
    t = store.create_table("flow_metrics", old)
    t.append({c.name: np.full(3, 60, c.dtype) for c in old.columns})
    assert "tag_code" not in t.schema.column_names
    issu = tmig.Issu(store, "flow_metrics")
    register_standard_migrations(issu)
    assert issu.run() == {"vtap_flow_port": 2}
    t2 = store.table("flow_metrics", "vtap_flow_port")
    assert t2.schema.version == 2
    assert t2.schema.to_json() == METRICS_TABLE.to_json() | {
        "columns": [c.to_json() for c in old.columns]
        + [METRICS_TABLE.spec("tag_code").to_json()]}
    issu2 = tmig.Issu(store, "flow_metrics")
    register_standard_migrations(issu2)
    assert issu2.run() == {}
    out = t2.scan()
    assert out["tag_code"].tolist() == [0, 0, 0]
    assert out["tag_code"].dtype == np.uint64
    assert_scan_equal(jdb.Store(str(tmp_path)).table(
        "flow_metrics", "vtap_flow_port").scan(), out)


def test_disk_monitor_gc_and_sweep_match_jax(tmp_path):
    """Watermark GC drops the globally oldest partitions until under the
    low mark; the sweep expires TTL partitions and compacts; both
    packages' monitors leave the same partitions and counters."""
    src = str(tmp_path / "p")
    ts = tdb.Store(src)
    a = ts.create_table("db", _schema(partition=10))
    b = ts.create_table("db", dataclasses.replace(_schema(partition=10,
                                                         ttl=50), name="u"))
    rng = np.random.default_rng(3)
    for i in range(10):
        a.append(_rows(rng, 100, t0=i * 10, span=10))
        b.append(_rows(rng, 100, t0=i * 10 + 5, span=10))
    for _ in range(9):                   # one partition worth compacting
        a.append(_rows(rng, 5, t0=95, span=1))
    shutil.copytree(src, str(tmp_path / "j"))
    js = jdb.Store(str(tmp_path / "j"))
    total = ts.disk_bytes()
    assert total == js.disk_bytes()
    tm = tmon.DiskMonitor(ts, max_bytes=total // 2, low_fraction=0.9)
    jm = jmon.DiskMonitor(js, max_bytes=total // 2, low_fraction=0.9)
    assert tm.check_once(now=100) == jm.check_once(now=100) > 0
    assert ts.disk_bytes() <= total // 2
    got, want = tm.counters(), jm.counters()
    assert got == want
    assert got["ttl_dropped"] > 0 and got["segments_compacted"] > 0
    for tname in ("t", "u"):
        assert ts.table("db", tname).partitions() == \
            js.table("db", tname).partitions()
        assert_scan_equal(js.table("db", tname).scan(),
                          ts.table("db", tname).scan())
    assert min(ts.table("db", "t").partitions()) > 0    # oldest went


def test_disk_monitor_thread_survives_sweep_exception(tmp_path):
    mon = tmon.DiskMonitor(tdb.Store(str(tmp_path)), max_bytes=1 << 40,
                           interval=0.01)
    calls = {"n": 0}
    ok = threading.Event()

    def boom(now=None):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("sweep exploded")
        ok.set()
        return 0

    mon.check_once = boom
    mon.start()
    try:
        assert ok.wait(5.0)
    finally:
        mon.close()
    assert mon.sweep_errors == 1
    assert "sweep exploded" in mon.last_sweep_error


def test_monitor_sweep_compacts_recent_rows(tmp_path):
    root = str(tmp_path)
    t = tdb.Store(root).create_table("db", _schema(partition=3600, ttl=3600))
    now = int(time.time())
    for i in range(10):
        t.append(_rows(np.random.default_rng(i), 4, t0=now, span=1))
    before = t.scan()
    mon = tmon.DiskMonitor(tdb.Store(root), max_bytes=1 << 40)
    mon.check_once()
    assert mon.counters()["segments_compacted"] == 10
    t2 = tdb.Store(root).table("db", "t")
    assert len(t2._segment_files(t2.partitions())) == 1
    assert_scan_equal(before, t2.scan())
