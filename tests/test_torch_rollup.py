"""The port's GROUP BY and rollup manager (deepflow_tpu_torch/store/rollup.py)
against the JAX package's, on the CPU.

`group_reduce` runs both ways in both packages: the host path (host
lexsort, segment reduce) and the device path (XLA-CPU runs the JAX
device program; the port's runs on CPU tensors). Every output column is
compared exactly, group order and dtype included. The rollup tiers are
built by both packages from the same base rows and scanned back, each
package's tiers through the other package's Store too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepflow_tpu.store import db as jdb
from deepflow_tpu.store import rollup as jr
from deepflow_tpu.store import table as jtable
from deepflow_tpu_torch.store import db as tdb
from deepflow_tpu_torch.store import rollup as tr
from deepflow_tpu_torch.store import table as ttable

CPU = "cpu"


def assert_same(a, b, what=""):
    """Same columns in the same order, equal values and dtypes."""
    assert list(a) == list(b), what
    for k in a:
        ja = np.asarray(a[k])
        assert ja.dtype == b[k].dtype, f"{what} {k}: {ja.dtype} {b[k].dtype}"
        np.testing.assert_array_equal(ja, b[k], err_msg=f"{what} {k}")


def _cols(rng, n, k_card=8):
    return {
        "k1": rng.integers(0, k_card, n).astype(np.uint32),
        "k2": rng.integers(-3, 5, n).astype(np.int32),
        "k3": rng.integers(0, 3, n).astype(np.uint16),
        "s": rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        "mx": rng.integers(0, 1 << 31, n).astype(np.uint32),
        "mn": rng.integers(0, 1 << 31, n).astype(np.uint32),
        "c": np.ones(n, np.uint32),
        "l": rng.integers(0, 9, n).astype(np.uint32),
    }


# value columns deliberately interleave the agg kinds
AGGS = {"mx": "max", "s": "sum", "mn": "min", "c": "count", "l": "last"}
KEYS = ["k1", "k2", "k3"]


# -- group_reduce ----------------------------------------------------------

@pytest.mark.parametrize("method", ["host", "device"])
@pytest.mark.parametrize("n", [1, 7, 1024, 5000])
def test_group_reduce_matches_jax(n, method):
    cols = _cols(np.random.default_rng(n), n)
    want = jr.group_reduce(cols, KEYS, AGGS, method=method)
    got = tr.group_reduce(cols, KEYS, AGGS, method=method, device=CPU)
    assert_same(want, got, f"{method} n={n}")
    # and the two methods agree with each other
    assert_same(got, tr.group_reduce(cols, KEYS, AGGS, method="host",
                                     device=CPU))


@pytest.mark.parametrize("trial", range(6))
def test_group_reduce_property_trials(trial):
    """Random sizes, key cardinalities (singleton groups up to a few
    large ones) and agg subsets, both methods, against both JAX methods."""
    rng = np.random.default_rng((0xD0D0, trial))
    n = int(rng.integers(1, 5000))
    cols = _cols(rng, n, k_card=int(rng.integers(1, 50)))
    names = list(AGGS)
    pick = rng.permutation(names)[:int(rng.integers(1, len(names) + 1))]
    aggs = {nm: AGGS[nm] for nm in pick}
    keys = KEYS[:int(rng.integers(1, 4))]
    want = jr.group_reduce(dict(cols), keys, dict(aggs), method="host")
    for method in ("host", "device"):
        assert_same(want, tr.group_reduce(dict(cols), keys, dict(aggs),
                                          method=method, device=CPU),
                    f"trial {trial} {method}")
    assert_same(jr.group_reduce(dict(cols), keys, dict(aggs),
                                method="device"),
                tr.group_reduce(dict(cols), keys, dict(aggs),
                                method="device", device=CPU))


def test_device_group_reduce_signed_keys_order():
    """Signed keys (l3_epc_id = -1) come back in the host path's order:
    the u32 lanes carry them sign-bit-flipped, and the packed sort key's
    high half is offset by 2^31."""
    cols = {"epc": np.array([5, -1, 0, -1, 5, 0, -7], np.int32),
            "port": np.array([1, 2, 1, 2, 1, 1, 3], np.uint32),
            "v": np.arange(7, dtype=np.uint32)}
    for keys in (["epc"], ["epc", "port"], ["port", "epc"]):
        host = tr.group_reduce(cols, keys, {"v": "sum"}, method="host",
                               device=CPU)
        dev = tr.group_reduce_device(cols, keys, {"v": "sum"}, device=CPU)
        assert_same(host, dev, str(keys))
        assert_same(jr.group_reduce_device(cols, keys, {"v": "sum"}), dev)
    one = tr.group_reduce_device(cols, ["epc"], {"v": "sum"}, device=CPU)
    assert one["epc"].tolist() == [-7, -1, 0, 5]


def test_device_group_reduce_extreme_lanes():
    """Lanes at 0, 2^31 - 1, 2^31 and 2^32 - 1 in both halves of a packed
    key, and int32 extremes, order as the host path orders them."""
    edge_u = np.array([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1],
                      np.uint32)
    edge_i = np.array([-(1 << 31), -1, 0, 1, (1 << 31) - 1], np.int32)
    a, b, c = np.meshgrid(edge_u, edge_i, edge_u, indexing="ij")
    rng = np.random.default_rng(3)
    perm = rng.permutation(a.size)
    cols = {"a": a.ravel()[perm], "b": b.ravel()[perm],
            "c": c.ravel()[perm],
            "v": rng.integers(0, 100, a.size).astype(np.uint32)}
    cols = {k: np.concatenate([v, v]) for k, v in cols.items()}
    aggs = {"v": "sum"}
    want = jr.group_reduce(cols, ["a", "b", "c"], aggs, method="host")
    assert_same(want, tr.group_reduce(cols, ["a", "b", "c"], aggs,
                                      method="device", device=CPU))
    assert len(want["a"]) == a.size


@pytest.mark.parametrize("method", ["host", "device"])
def test_group_reduce_empty(method):
    cols = {"k": np.empty(0, np.uint32), "v": np.empty(0, np.uint32)}
    want = jr.group_reduce(cols, ["k"], {"v": "sum"}, method=method)
    got = tr.group_reduce(cols, ["k"], {"v": "sum"}, method=method,
                          device=CPU)
    assert_same(want, got)
    assert len(got["k"]) == 0 and len(got["v"]) == 0
    w, wi = jr.group_reduce(cols, ["k"], {"v": "sum"}, return_inverse=True,
                            method="host")
    g, gi = tr.group_reduce(cols, ["k"], {"v": "sum"}, return_inverse=True,
                            method="host", device=CPU)
    assert_same(w, g)
    assert gi.dtype == wi.dtype and len(gi) == 0


def test_group_reduce_no_aggregates_is_dedup():
    cols = {"k": np.array([3, 1, 3, 2, 1], np.uint32),
            "j": np.array([0, 0, 0, 1, 0], np.int32)}
    for method in ("host", "device", "auto"):
        got = tr.group_reduce(cols, ["k"], {}, method=method, device=CPU)
        assert got["k"].tolist() == [1, 2, 3]
        assert_same(jr.group_reduce(cols, ["k"], {}, method=method), got)
    got, inv = tr.group_reduce(cols, ["k", "j"], {}, return_inverse=True,
                               device=CPU)
    want, winv = jr.group_reduce(cols, ["k", "j"], {}, return_inverse=True)
    assert_same(want, got)
    np.testing.assert_array_equal(winv, inv)


def test_group_reduce_return_inverse_matches_jax():
    cols = _cols(np.random.default_rng(11), 3000)
    want, winv = jr.group_reduce(cols, KEYS, AGGS, return_inverse=True)
    got, inv = tr.group_reduce(cols, KEYS, AGGS, return_inverse=True,
                               device=CPU)
    assert_same(want, got)
    assert inv.dtype == np.int64
    np.testing.assert_array_equal(winv, inv)


def test_group_reduce_errors():
    wide = {"mac": np.zeros(4, np.uint64), "v": np.ones(4, np.uint32)}
    with pytest.raises(ValueError, match="64-bit"):
        tr.group_reduce_device(wide, ["mac"], {"v": "sum"}, device=CPU)
    with pytest.raises(ValueError, match="64-bit"):
        tr.group_reduce(wide, ["mac"], {"v": "sum"}, method="device",
                        device=CPU)
    flt = {"f": np.zeros(4, np.float32), "v": np.ones(4, np.uint32)}
    with pytest.raises(ValueError, match="32-bit integers"):
        tr.group_reduce_device(flt, ["f"], {"v": "sum"}, device=CPU)
    with pytest.raises(ValueError, match="row->group"):
        tr.group_reduce({"k": np.ones(4, np.uint32),
                         "v": np.ones(4, np.uint32)},
                        ["k"], {"v": "sum"}, return_inverse=True,
                        method="device", device=CPU)
    # the wide key groups exactly on the host path
    got = tr.group_reduce({"mac": np.array([1 << 40, 5, 1 << 40],
                                           np.uint64),
                           "v": np.array([1, 2, 3], np.uint32)},
                          ["mac"], {"v": "sum"}, device=CPU)
    assert got["mac"].tolist() == [5, 1 << 40] and got["v"].tolist() == [2, 4]


def test_segment_reduce_mask_and_empty_segments_match_jax():
    """Masked rows go to the trash segment with neutral values; empty
    segments hold each agg's identity; sums wrap in int64 as XLA's do."""
    from deepflow_tpu.store.rollup import _enable_x64
    rng = np.random.default_rng(5)
    n, S = 300, 17
    seg = rng.integers(0, S - 3, n).astype(np.int32)   # 14, 15, 16 empty
    mask = rng.random(n) < 0.8
    data = rng.integers(-(1 << 62), 1 << 62, (n, 5)).astype(np.int64)
    data[:4, 0] = np.iinfo(np.int64).max           # wraps when summed
    seg[:4] = 2
    mask[:4] = True
    aggs = ("sum", "max", "min", "count", "last")
    import jax.numpy as jnp
    with _enable_x64(True):
        want = np.asarray(jr._segment_reduce(
            jnp.asarray(seg), jnp.asarray(mask), jnp.asarray(data), aggs, S))
    got = tr._segment_reduce(torch.from_numpy(seg.astype(np.int64)),
                             torch.from_numpy(mask), torch.from_numpy(data),
                             aggs, S).numpy()
    np.testing.assert_array_equal(want, got)


def test_device_group_reduce_masked_rows_match_jax():
    """The device program with padding rows masked out: the same groups
    in the same slots, the trash segment untouched by the output."""
    from deepflow_tpu.store.rollup import _enable_x64
    import jax.numpy as jnp
    rng = np.random.default_rng(9)
    n = 500
    lanes = np.stack([rng.integers(0, 6, n), rng.integers(0, 1 << 32, n)
                      % 5 + (1 << 31)]).astype(np.uint32)
    data = rng.integers(0, 1 << 40, (n, 3)).astype(np.int64)
    mask = rng.random(n) < 0.7
    aggs = ("sum", "min", "max")
    with _enable_x64(True):
        k, v, g = jr._device_group_reduce(
            tuple(jnp.asarray(x) for x in lanes), jnp.asarray(data),
            jnp.asarray(mask), aggs, n + 1)
        g = int(g)
        wk, wv = np.asarray(k)[:, :g], np.asarray(v)[:g]
    tk, tv, tg = tr._device_group_reduce(
        torch.from_numpy(lanes.astype(np.int64)), torch.from_numpy(data),
        torch.from_numpy(mask), aggs)
    assert tg == g
    np.testing.assert_array_equal(wk.astype(np.int64), tk.numpy())
    np.testing.assert_array_equal(wv, tv.numpy())


class _Device(Exception):
    pass


class _Host(Exception):
    pass


def _auto_picks_device(monkeypatch, cols, key_names, device_type):
    """Whether `auto` takes the device path for a call on a device of
    `device_type` (both paths replaced by probes at their entry)."""
    def probe(exc):
        def raiser(*a, **k):
            raise exc
        return raiser
    monkeypatch.setattr(tr, "group_reduce_device", probe(_Device))
    monkeypatch.setattr(tr, "_unique_rows", probe(_Host))
    monkeypatch.setattr(tr, "check_device",
                        lambda d: torch.device(device_type))
    try:
        tr.group_reduce(cols, key_names, {"v": "sum"}, method="auto")
    except _Device:
        return True
    except _Host:
        return False
    raise AssertionError("neither path was taken")


def test_auto_rule(monkeypatch):
    """`auto` takes the device path only on CUDA, from 2^18 rows, with
    every key within u32 and no inverse; never on the CPU."""
    n = tr.AUTO_DEVICE_ROWS
    cols = {"k": np.zeros(n, np.uint32), "j": np.zeros(n, np.int16),
            "w": np.zeros(n, np.uint64), "v": np.ones(n, np.uint32)}
    assert _auto_picks_device(monkeypatch, cols, ["k", "j"], "cuda")
    assert not _auto_picks_device(monkeypatch, cols, ["k", "j"], "cpu")
    assert not _auto_picks_device(monkeypatch, cols, ["k", "w"], "cuda")
    short = {k: v[:n - 1] for k, v in cols.items()}
    assert not _auto_picks_device(monkeypatch, short, ["k"], "cuda")


def test_auto_rule_metrics_table_stays_on_host(monkeypatch):
    """tag_code is a uint64 KEY: the flow_metrics rollup never takes the
    device path, whatever its size."""
    from deepflow_tpu_torch.pipelines.schemas import METRICS_TABLE
    n = tr.AUTO_DEVICE_ROWS
    cols = {c.name: np.zeros(n, c.dtype) for c in METRICS_TABLE.columns}
    cols["v"] = np.ones(n, np.uint32)
    keys = [c.name for c in METRICS_TABLE.columns
            if c.agg is ttable.AggKind.KEY]
    assert "tag_code" in keys and len(keys) == 17
    assert not _auto_picks_device(monkeypatch, cols, keys, "cuda")


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    cols = {"k": np.ones(4, np.uint32), "v": np.ones(4, np.uint32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.group_reduce(cols, ["k"], {"v": "sum"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.group_reduce_device(cols, ["k"], {"v": "sum"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.RollupManager(tdb.Store(str(tmp_path)), "db", _tschema())


# -- RollupManager ---------------------------------------------------------

def _tschema(ttl=None, partition=3600):
    return ttable.TableSchema(
        name="t",
        columns=(
            ttable.ColumnSpec("timestamp", np.dtype(np.uint32),
                              ttable.AggKind.KEY),
            ttable.ColumnSpec("ip", np.dtype(np.uint32), ttable.AggKind.KEY),
            ttable.ColumnSpec("epc", np.dtype(np.int32), ttable.AggKind.KEY),
            ttable.ColumnSpec("bytes", np.dtype(np.uint32),
                              ttable.AggKind.SUM),
            ttable.ColumnSpec("rtt_max", np.dtype(np.uint32),
                              ttable.AggKind.MAX),
            ttable.ColumnSpec("rtt_min", np.dtype(np.uint32),
                              ttable.AggKind.MIN),
            ttable.ColumnSpec("n", np.dtype(np.uint32),
                              ttable.AggKind.COUNT),
            ttable.ColumnSpec("tag", np.dtype(np.uint32),
                              ttable.AggKind.LAST),
        ),
        ttl_seconds=ttl, partition_seconds=partition)


def _jschema(s):
    return jtable.TableSchema.from_json(s.to_json())


def _base_rows(rng, n, t0=0, span=7200):
    return {
        "timestamp": (t0 + rng.integers(0, span, n)).astype(np.uint32),
        "ip": rng.integers(0, 6, n).astype(np.uint32),
        "epc": rng.integers(-2, 2, n).astype(np.int32),
        "bytes": rng.integers(0, 1 << 32, n, dtype=np.uint64)
        .astype(np.uint32),        # 60 s sums pass 2^32: the u32 clip
        "rtt_max": rng.integers(0, 1 << 32, n, dtype=np.uint64)
        .astype(np.uint32),
        "rtt_min": rng.integers(0, 1000, n).astype(np.uint32),
        "n": np.ones(n, np.uint32),
        "tag": rng.integers(0, 3, n).astype(np.uint32),
    }


def _pair(tmp_path, schema=None, intervals=(60,), **kw):
    """A port manager and a JAX manager on two roots, same schema."""
    schema = schema or _tschema()
    ts = tdb.Store(str(tmp_path / "port"))
    js = jdb.Store(str(tmp_path / "jax"))
    tm = tr.RollupManager(ts, "db", schema, intervals=intervals,
                          device=CPU, **kw)
    jm = jr.RollupManager(js, "db", _jschema(schema), intervals=intervals,
                          **kw)
    return ts, js, tm, jm


def test_rollup_tiers_match_jax(tmp_path):
    """The 1m and 1h tiers of the same base rows equal the JAX tiers row
    for row (group order included), through either package's scan."""
    ts, js, tm, jm = _pair(tmp_path, intervals=(60, 3600),
                           allowance_seconds=5)
    rng = np.random.default_rng(21)
    for _ in range(3):
        rows = _base_rows(rng, 4000)
        tm.base.append(rows)
        jm.base.append(rows)
    now = 7200 + 5 + 60
    assert tm.advance(now) == jm.advance(now)
    for name in ("t.1m", "t.1h"):
        want = js.table("db", name).scan()
        assert_same(want, ts.table("db", name).scan(), name)
        # across packages: the JAX Store reads the port's tier, and back
        assert_same(want, jdb.Store(str(tmp_path / "port"))
                    .table("db", name).scan(), name)
        assert_same(want, tdb.Store(str(tmp_path / "jax"))
                    .table("db", name).scan(), name)
    one_m = ts.table("db", "t.1m").scan()
    assert (one_m["bytes"] == 0xFFFFFFFF).any()      # clipped sums
    assert tm.list_datasources() == jm.list_datasources()


def test_rollup_idempotent_and_restart(tmp_path):
    """A second advance emits nothing; a restarted manager recovers the
    watermark from the tier and never double-counts, then builds the
    next buckets as the JAX manager does."""
    ts, js, tm, jm = _pair(tmp_path, allowance_seconds=5)
    rng = np.random.default_rng(4)
    rows = _base_rows(rng, 2000, span=600)
    tm.base.append(rows)
    jm.base.append(rows)
    assert tm.advance(700.0) == jm.advance(700.0)
    assert tm.advance(700.0) == {60: 0}
    tm2 = tr.RollupManager(tdb.Store(str(tmp_path / "port")), "db",
                           _tschema(), intervals=(60,), allowance_seconds=5,
                           device=CPU)
    jm2 = jr.RollupManager(jdb.Store(str(tmp_path / "jax")), "db",
                           _jschema(_tschema()), intervals=(60,),
                           allowance_seconds=5)
    assert tm2._built_until == jm2._built_until == {60: 600}
    assert tm2.advance(700.0) == jm2.advance(700.0) == {60: 0}
    late = _base_rows(rng, 500, t0=600, span=300)
    tm2.base.append(late)
    jm2.base.append(late)
    assert tm2.advance(1000.0) == jm2.advance(1000.0)
    assert_same(js.table("db", "t.1m").scan(),
                tm2.store.table("db", "t.1m").scan())


def test_rollup_datasource_crud_matches_jax(tmp_path):
    """add_interval (backfill), set_retention, list_datasources, the
    DETACHED marker and remove_interval, step for step with the JAX
    manager, and the resulting tiers equal."""
    ts, js, tm, jm = _pair(tmp_path, allowance_seconds=5)
    rows = _base_rows(np.random.default_rng(8), 3000)
    tm.base.append(rows)
    jm.base.append(rows)
    assert tm.advance(7300.0) == jm.advance(7300.0)
    for bad in (90, 0, -60):
        with pytest.raises(ValueError, match="multiple of 60"):
            tm.add_interval(bad)
    with pytest.raises(ValueError, match="already exists"):
        tm.add_interval(60)
    assert tm.add_interval(3600, ttl_seconds=1234) == \
        jm.add_interval(3600, ttl_seconds=1234)
    assert tm.advance(7300.0) == jm.advance(7300.0)
    assert_same(js.table("db", "t.1h").scan(),
                ts.table("db", "t.1h").scan())
    assert tm.list_datasources() == jm.list_datasources()
    assert tm.set_retention(3600, 777) and jm.set_retention(3600, 777)
    assert tdb.Store(str(tmp_path / "port")).table(
        "db", "t.1h").schema.ttl_seconds == 777
    assert tm.set_retention(120, 5) is False
    # keep-data removal leaves the DETACHED marker: a restart skips it
    assert tm.remove_interval(3600, drop_data=False)
    assert (tmp_path / "port" / "db" / "t.1h" / "DETACHED").exists()
    tm2 = tr.RollupManager(ts, "db", _tschema(), intervals=(60,),
                           allowance_seconds=5, device=CPU)
    assert {iv for iv, _ in tm2.targets} == {60}
    assert ts.has_table("db", "t.1h")
    # the JAX manager honours the port's marker, and back
    jm2 = jr.RollupManager(jdb.Store(str(tmp_path / "port")), "db",
                           _jschema(_tschema()), intervals=(60,),
                           allowance_seconds=5)
    assert {iv for iv, _ in jm2.targets} == {60}
    # re-add clears the marker; dropping removes the table and its files
    assert tm2.add_interval(3600)["table"] == "t.1h"
    assert not (tmp_path / "port" / "db" / "t.1h" / "DETACHED").exists()
    assert tm2.remove_interval(3600)
    assert not ts.has_table("db", "t.1h")
    assert not (tmp_path / "port" / "db" / "t.1h").exists()
    assert tm2.remove_interval(3600) is False
    assert 3600 not in tm2.advance(7400.0)
    # a build draining for a removed tier refuses a re-add
    tm2._building.add(10800)
    tm2._drop_pending[10800] = str(tmp_path / "gone")
    with pytest.raises(ValueError, match="busy"):
        tm2.add_interval(10800)


def test_rollup_ttl_derive_keep_explicit(tmp_path):
    base = dataclasses.replace(_tschema(), ttl_seconds=1000)
    ts, js, tm, jm = _pair(tmp_path, schema=base, allowance_seconds=5)
    assert ts.table("db", "t.1m").schema.ttl_seconds == 30_000   # derive
    for iv, ttl in ((3600, 0), (7200, tr.TTL_DERIVE), (10800, 55),
                    (14400, None)):
        jttl = jr.TTL_DERIVE if ttl is tr.TTL_DERIVE else ttl
        assert tm.add_interval(iv, ttl_seconds=ttl) == \
            jm.add_interval(iv, ttl_seconds=jttl)
    got = {d["interval"]: d["ttl_seconds"] for d in tm.list_datasources()}
    assert got == {60: 30_000, 3600: None, 7200: 30_000, 10800: 55,
                   14400: None}
    with pytest.raises(ValueError, match=">= 0"):
        tm.add_interval(18000, ttl_seconds=-5)
    with pytest.raises(ValueError, match=">= 0"):
        tm.set_retention(3600, -1)
    # manifests byte-equal across packages
    for name in ("t.1m", "t.1h", "t.7200s", "t.10800s", "t.14400s"):
        a = (tmp_path / "port" / "db" / name / "manifest.json").read_text()
        b = (tmp_path / "jax" / "db" / name / "manifest.json").read_text()
        assert a == b, name
    # a restart re-discovers every runtime tier from disk
    tm2 = tr.RollupManager(tdb.Store(str(tmp_path / "port")), "db", base,
                           intervals=(60,), allowance_seconds=5, device=CPU)
    assert {iv for iv, _ in tm2.targets} == {60, 3600, 7200, 10800, 14400}


def test_interval_naming_and_external_datasources():
    for iv in (60, 3600, 86400, 120, 7200):
        name = tr.rollup_schema(_tschema(), iv).name
        assert name == jr.rollup_schema(_jschema(_tschema()), iv).name
        assert tr.interval_from_table_name("t", name) == iv
    assert tr.interval_from_table_name("t", "u.1m") is None
    assert tr.interval_from_table_name("t", "t.xs") is None
    assert tr.rollup_schema(_tschema(), 3600).to_json() == \
        jr.rollup_schema(_jschema(_tschema()), 3600).to_json()

    def broken():
        raise RuntimeError("boom")

    tr.register_datasource("sk", lambda: [{"table": "sk", "kind": "x"}])
    tr.register_datasource("zz", broken)
    try:
        rows = tr.external_datasources()
        assert rows[0] == {"table": "sk", "kind": "x"}
        assert rows[1]["table"] == "zz" and "boom" in rows[1]["error"]
    finally:
        tr.unregister_datasource("sk")
        tr.unregister_datasource("zz")
    assert tr.external_datasources() == []


def test_group_reduce_value_dtypes_match_jax():
    """Value columns of every width: 32-bit words cross as they are and
    widen on the device (unsigned masked, signed extended), wider ones
    as int64; u64 past 2^63 and floats cast as the reference's astype."""
    rng = np.random.default_rng(17)
    n = 2000
    cols = {"k": rng.integers(0, 40, n).astype(np.uint32),
            "u8": rng.integers(0, 256, n).astype(np.uint8),
            "u16": rng.integers(0, 1 << 16, n).astype(np.uint16),
            "i16": rng.integers(-(1 << 15), 1 << 15, n).astype(np.int16),
            "i32": rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
            "u32": rng.integers(0, 1 << 32, n, dtype=np.uint64)
            .astype(np.uint32),
            "u64": rng.integers(0, 1 << 64, n, dtype=np.uint64),
            "i64": rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64),
            "b": rng.random(n) < 0.5,
            "f": rng.normal(0, 1e6, n)}
    for agg in ("sum", "min", "max", "count", "last"):
        aggs = {nm: agg for nm in cols if nm != "k"}
        for method in ("host", "device"):
            assert_same(jr.group_reduce(cols, ["k"], aggs, method=method),
                        tr.group_reduce(cols, ["k"], aggs, method=method,
                                        device=CPU), f"{agg} {method}")
