"""The port's AppRedExporter (deepflow_tpu_torch/runtime/app_red.py)
against the JAX package's, on the CPU (the hist kernel's plain version).

Both exporters take the same unaligned l7 chunks and close windows at
pinned times; the window outputs are compared field by field (counts
exact, quantiles within rtol 2e-6), and the `app_red` rows that a fresh
JAX Store scans from the port's directory are compared with those the
JAX exporter wrote to its own. The stream's latencies hold no value on a
bucket boundary (checked; test_torch_ddsketch.py covers those). Every
exporter is closed in a `finally`.
"""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepflow_tpu.models import app_suite as jas
from deepflow_tpu.ops import ddsketch as jdd
from deepflow_tpu.runtime import app_red as jred
from deepflow_tpu.store import db as jdb
from deepflow_tpu_torch.models import app_suite as tas
from deepflow_tpu_torch.ops import cuda_hist
from deepflow_tpu_torch.ops._build import KernelError
from deepflow_tpu_torch.runtime import app_red as tred
from deepflow_tpu_torch.store import db as tdb

Q_RTOL = 2e-6
STATUS = np.array([0, 0, 0, 200, 200, 200, 204, 301, 404, 500, 503, 1, 7,
                   2**31, 2**32 - 1], np.uint32)


def _stream(rng, n, endpoints=200):
    """l7 request records: Zipf(1.1) server endpoints, log-normal rrt_us
    (median 2 ms) with 1% zeros and u32 edges, mixed status codes."""
    pool = {"ip_dst": (0x0A000000 + rng.permutation(endpoints)).astype(
                np.uint32),
            "port_dst": rng.choice(np.array([80, 443, 3306, 6379],
                                            np.uint32), endpoints),
            "protocol": rng.choice(np.array([6, 17], np.uint32), endpoints)}
    pick = (rng.zipf(1.1, n) - 1).clip(max=endpoints - 1)
    cols = {k: v[pick] for k, v in pool.items()}
    rrt = np.round(rng.lognormal(np.log(2000), 1.2, n)).astype(np.uint32)
    rrt[rng.random(n) < 0.01] = 0
    rrt[:4] = [2**31, 2**32 - 1, 1, 0]
    cols["rrt_us"] = rrt
    cols["status"] = rng.choice(STATUS, n)
    return cols


def _chunks(cols, size):
    n = len(cols["rrt_us"])
    return [{k: v[s:s + size] for k, v in cols.items()}
            for s in range(0, n, size)]


def _no_boundary_values(v, cfg):
    jb = np.asarray(jdd.bucket_index(jnp.asarray(v), cfg))
    w = np.maximum(v.astype(np.float32), np.float32(1)).astype(np.float64)
    exact = np.clip(np.ceil(np.log(w) / np.log(jdd.gamma(cfg))), 0,
                    cfg.buckets - 1)
    return bool(np.all(jb == exact))


def _assert_output_equal(to, jo):
    for name in jas.AppWindowOutput._fields:
        a, b = getattr(to, name).numpy(), np.asarray(getattr(jo, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name == "rrt_quantiles":
            np.testing.assert_allclose(a, b, rtol=Q_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def _assert_rows_equal(trows, jrows, quantiles):
    qcols = {tred.quantile_column(q) for q in quantiles}
    assert set(trows) == set(jrows) == {"timestamp", "service_group",
                                        "requests", "errors"} | qcols
    for name in jrows:
        assert trows[name].dtype == jrows[name].dtype, name
        if name in qcols:
            np.testing.assert_allclose(trows[name], jrows[name], rtol=Q_RTOL,
                                       atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(trows[name], jrows[name],
                                          err_msg=name)


def _scan(root):
    return jdb.Store(root).table(jred.APP_RED_DB, "app_red").scan()


@pytest.mark.parametrize("quantiles", [(0.5, 0.95, 0.99), (0.9, 0.995)])
def test_exporter_matches_jax_windows_and_rows(quantiles, tmp_path):
    """Three windows (the last in another partition hour) of unaligned
    chunks through process(): every window output equal, and the app_red
    rows a fresh JAX Store scans from the port's directory equal those of
    the JAX exporter's."""
    kw = dict(groups=64, quantiles=quantiles)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jexp = jred.AppRedExporter(store=jdb.Store(jroot), batch_rows=512,
                               cfg=jas.AppSuiteConfig(**kw),
                               window_seconds=3600)
    texp = tred.AppRedExporter(store=tdb.Store(troot), batch_rows=512,
                               cfg=tas.AppSuiteConfig(**kw),
                               window_seconds=3600, device="cpu")
    rng = np.random.default_rng(31)
    try:
        for w, now in enumerate((5000.0, 5001.0, 9000.0)):
            cols = _stream(rng, 3000 + 500 * w)
            assert _no_boundary_values(cols["rrt_us"],
                                       jas.AppSuiteConfig(**kw).dd)
            for c in _chunks(cols, 700):
                jexp.process([("l7_flow_log", 0, c, -1)])
                texp.process([("l7_flow_log", 0, c, -1)])
            _assert_output_equal(texp.flush_window(now=now),
                                 jexp.flush_window(now=now))
        c = texp.counters()
        assert c["rows_in"] == jexp.rows_in == 3000 + 3500 + 4000
        assert c["windows"] == 3 and c["d2h_transfers"] == 3
        assert c["h2d_transfers"] == c["batches"] == 6 + 7 + 8
    finally:
        jexp.close()
        texp.close()
    trows, jrows = _scan(troot), _scan(jroot)
    assert sorted(set(trows["timestamp"].tolist()))[:3] == [5000, 5001, 9000]
    keep_t, keep_j = trows["timestamp"] < 10000, jrows["timestamp"] < 10000
    _assert_rows_equal({k: v[keep_t] for k, v in trows.items()},
                       {k: v[keep_j] for k, v in jrows.items()}, quantiles)
    assert int(trows["requests"][keep_t].sum()) == 10500


def test_quantile_column_names_exact():
    assert tred.quantile_column(0.5) == "rrt_p50_us"
    assert tred.quantile_column(0.995) == "rrt_p99_5_us"
    assert tred.quantile_column(0.999) == "rrt_p99_9_us"
    for qs in ((0.5, 0.95, 0.99), (0.99, 0.995, 0.999), (0.9,)):
        assert tred.app_red_table(qs).to_json() == \
            jred.app_red_table(qs).to_json()
    assert tred.APP_RED_TABLE.to_json() == jred.APP_RED_TABLE.to_json()
    with pytest.raises(ValueError):
        tred.app_red_table((0.5, 0.5))


def test_exporter_through_put_and_its_threads(tmp_path):
    """start(): chunks through put() and the worker thread, windows
    closed by the window thread, rows written by the writer's thread;
    close() drains."""
    store = tdb.Store(str(tmp_path))
    exp = tred.AppRedExporter(
        store=store, batch_rows=256, window_seconds=0.05, device="cpu",
        cfg=tas.AppSuiteConfig(groups=8, dd_buckets=256,
                               quantiles=(0.9, 0.99)))
    n = 512
    cols = {"ip_dst": np.full(n, 1, np.uint32),
            "port_dst": np.full(n, 80, np.uint32),
            "protocol": np.full(n, 6, np.uint32),
            "status": np.zeros(n, np.uint32),
            "rrt_us": np.full(n, 5_000, np.uint32)}
    exp.start()
    try:
        assert exp.is_export_data("l7_flow_log", cols)
        assert not exp.is_export_data("l4_flow_log", cols)
        exp.put("l7_flow_log", 0, cols)
        deadline = time.monotonic() + 15
        while (exp.rows_in < n or exp.windows < 2) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert exp.rows_in == n and exp.windows >= 2
    finally:
        exp.close()
    rows = jdb.Store(str(tmp_path)).table("tpu_sketch", "app_red").scan()
    assert "rrt_p90_us" in rows and "rrt_p99_us" in rows
    assert "rrt_p50_us" not in rows
    assert rows["requests"].sum() == n and rows["errors"].sum() == 0
    assert np.all(np.abs(rows["rrt_p90_us"] - 5000) / 5000 < 0.1)
    assert exp.counters()["process_errors"] == 0


def test_exporter_in_a_live_jax_ingester(tmp_path):
    """Agent l7 traffic -> firehose -> the JAX Ingester, with the port's
    exporter registered in its Exporters: RED rows in the store."""
    from deepflow_tpu.agent.trident import Agent, AgentConfig
    from deepflow_tpu.pipelines import Ingester, IngesterConfig
    from deepflow_tpu.replay import eth_ipv4_tcp, ip4

    root = str(tmp_path / "st")
    ing = Ingester(IngesterConfig(listen_port=0, store_path=root))
    red = tred.AppRedExporter(store=tdb.Store(root), window_seconds=3600,
                              device="cpu")
    ing.exporters.register(red)
    ing.start()
    try:
        agent = Agent(AgentConfig(
            ingester_addr=f"127.0.0.1:{ing.port}", l7_enabled=True))
        agent.set_vtap_id(4)
        C, S = ip4(10, 0, 0, 1), ip4(10, 0, 0, 2)
        T0 = 1_700_000_000_000_000_000
        frames, stamps = [], []
        for i in range(5):
            frames.append(eth_ipv4_tcp(C, S, 41000 + i, 80, 0x10,
                                       b"GET /x HTTP/1.1\r\n\r\n", seq=1))
            stamps.append(T0 + i * 10_000_000)
            frames.append(eth_ipv4_tcp(S, C, 80, 41000 + i, 0x10,
                                       b"HTTP/1.1 500 Oops\r\n\r\n",
                                       seq=1))
            stamps.append(T0 + i * 10_000_000 + 2_000_000)
        agent.feed(frames, np.asarray(stamps, np.uint64))
        agent.tick(T0 + int(1e9))
        deadline = time.time() + 15
        while red.rows_in < 5 and time.time() < deadline:
            time.sleep(0.1)
        out = red.flush_window()
        agent.close()
        reqs = out.requests.numpy()
        g = int(np.nonzero(reqs)[0][0])
        assert reqs[g] == 5
        assert float(out.error_ratio[g]) == 1.0   # all 500s
        red.flush()
        rows = jdb.Store(root).table(tred.APP_RED_DB, "app_red").scan()
        assert rows["requests"].tolist() == [5]
        assert rows["errors"].tolist() == [5]
        assert abs(rows["rrt_p95_us"][0] - 2000) / 2000 < 0.05
    finally:
        ing.close()
    assert not red._handles


def test_unported_surfaces_raise():
    """The le-bucket surface is ported: without its store and tag
    dictionaries it refuses as the JAX exporter does (ValueError naming
    both); "cuda" without a card raises."""
    for mod, kw in ((jred, {}), (tred, {"device": "cpu"})):
        with pytest.raises(ValueError, match="store and tag_dicts"):
            mod.AppRedExporter(prom_bucket_stride=1, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tred.AppRedExporter()


# -- the Prometheus le-bucket surface ---------------------------------------
def _bucket_pair(tmp_path, stride=8, groups=64, batch_rows=512):
    """A JAX and a port exporter with le buckets, each over its own store
    and tag dictionaries."""
    from deepflow_tpu.store import dict_store as jdicts
    from deepflow_tpu_torch.store import dict_store as tdicts
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jreg, treg = jdicts.TagDictRegistry(jroot), tdicts.TagDictRegistry(troot)
    kw = dict(groups=groups)
    jexp = jred.AppRedExporter(jdb.Store(jroot), jas.AppSuiteConfig(**kw),
                               batch_rows, 3600.0, None, jreg, stride)
    texp = tred.AppRedExporter(tdb.Store(troot), tas.AppSuiteConfig(**kw),
                               batch_rows, 3600.0, None, treg, stride,
                               device="cpu")
    return (jexp, jreg, jroot), (texp, treg, troot)


def _feed_windows(jexp, texp, rng, nows, n=3000, groups=64):
    for w, now in enumerate(nows):
        cols = _stream(rng, n + 400 * w, endpoints=groups)
        assert _no_boundary_values(cols["rrt_us"], jexp.cfg.dd)
        for c in _chunks(cols, 700):
            jexp.process([("l7_flow_log", 0, c, -1)])
            texp.process([("l7_flow_log", 0, c, -1)])
        _assert_output_equal(texp.flush_window(now=now),
                             jexp.flush_window(now=now))


def _samples(root):
    from deepflow_tpu.pipelines.ext_metrics import EXT_METRICS_DB
    rows = jdb.Store(root).table(EXT_METRICS_DB, "ext_samples").scan()
    order = np.lexsort((rows["labels"], rows["metric"], rows["timestamp"]))
    return {k: v[order] for k, v in rows.items()}


def _close_pair(*pairs):
    for exp, reg, _ in pairs:
        exp.close()
        reg.flush()
        reg.close()


def test_le_buckets_match_jax_over_three_windows(tmp_path):
    """Three windows (the last in another partition hour): the
    ext_samples rows (timestamp, metric, labels, value) equal the JAX
    exporter's counter by counter, and both packages' persisted
    metric_name and label_set dictionaries hold the same entries."""
    (jexp, jreg, jroot), (texp, treg, troot) = _bucket_pair(tmp_path)
    try:
        _feed_windows(jexp, texp, np.random.default_rng(61),
                      (5000.0, 5001.0, 9000.0))
        np.testing.assert_array_equal(texp._bucket_cum, jexp._bucket_cum)
        assert texp.counters()["d2h_transfers"] == 6   # readout + gather
        assert texp.counters()["bucket_d2h_bytes"] > 0
    finally:
        _close_pair((jexp, jreg, jroot), (texp, treg, troot))
    t, j = _samples(troot), _samples(jroot)
    assert len(j["timestamp"]) > 0
    n_le = len(jexp._bucket_les)
    assert len(j["timestamp"]) % n_le == 0 and n_le == 512 // 8
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    for name in ("metric_name", "label_set"):
        rd = lambda root: sorted(
            open(f"{root}/flow_tag/{name}.jsonl").read().splitlines())
        assert rd(troot) == rd(jroot), name


def test_le_bucket_counter_reset_past_2_23(tmp_path):
    """Both exporters' running counters are preloaded identically before
    the first window (the preload stands in for the windows a long-lived
    service would have accumulated): groups 0-31 at 2^23 + 7 in every
    retained bucket (past the reset bound), groups 32-63 at 2^23 - 7
    (below it). After one window the rows equal the JAX exporter's; the
    preloaded-past-bound groups restart at this window's own counts, the
    others add to their preload."""
    (jexp, jreg, jroot), (texp, treg, troot) = _bucket_pair(tmp_path)
    pre = np.zeros_like(jexp._bucket_cum)
    pre[:32] = float((1 << 23) + 7)
    pre[32:] = float((1 << 23) - 7)
    jexp._bucket_cum[:] = pre
    texp._bucket_cum[:] = pre
    try:
        _feed_windows(jexp, texp, np.random.default_rng(62), (7000.0,),
                      n=6000)
        out = texp.last_output
        act = np.nonzero(out.requests.numpy() > 0)[0]
        cum = np.cumsum(out.rrt_hist.numpy()[act], axis=1)[
            :, texp._bucket_idx] + out.rrt_zeros.numpy()[act][:, None]
        want = np.where((act < 32)[:, None], cum, pre[act] + cum)
        np.testing.assert_array_equal(texp._bucket_cum[act], want)
        assert (act < 32).any() and (act >= 32).any()
        np.testing.assert_array_equal(texp._bucket_cum, jexp._bucket_cum)
    finally:
        _close_pair((jexp, jreg, jroot), (texp, treg, troot))
    t, j = _samples(troot), _samples(jroot)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_le_buckets_histogram_quantile_matches_jax(tmp_path):
    """`histogram_quantile(0.95, rate(app_rrt_bucket[2m]))` through the
    port's PromEngine on the port's store answers as the JAX engine on
    the JAX store (JSON text, instant and range)."""
    import json
    from deepflow_tpu.querier.promql import PromEngine as JProm
    from deepflow_tpu.store import dict_store as jdicts
    from deepflow_tpu_torch.querier.promql import PromEngine
    from deepflow_tpu_torch.store import dict_store as tdicts
    (jexp, jreg, jroot), (texp, treg, troot) = _bucket_pair(tmp_path)
    try:
        _feed_windows(jexp, texp, np.random.default_rng(63),
                      (5000.0, 5030.0, 5060.0, 5090.0))
    finally:
        _close_pair((jexp, jreg, jroot), (texp, treg, troot))
    jr, tr = jdicts.TagDictRegistry(jroot), tdicts.TagDictRegistry(troot)
    try:
        j = JProm(jdb.Store(jroot), jr)
        t = PromEngine(tdb.Store(troot), tr, device="cpu")
        for expr in ("histogram_quantile(0.95, rate(app_rrt_bucket[2m]))",
                     "histogram_quantile(0.5, sum by (le) "
                     "(rate(app_rrt_bucket[2m])))"):
            want = j.query(expr, at=5090)
            assert want
            assert json.dumps(t.query(expr, at=5090), sort_keys=True) == \
                json.dumps(want, sort_keys=True)
            want_r = j.query_range(expr, start=5030, end=5090, step=30)
            assert json.dumps(t.query_range(expr, start=5030, end=5090,
                                            step=30), sort_keys=True) == \
                json.dumps(want_r, sort_keys=True)
    finally:
        jr.close()
        tr.close()


def test_positional_signature_matches_jax(tmp_path):
    """The same positional arguments build the same exporter in both
    packages (store, cfg, batch_rows, window_seconds, stats, tag_dicts,
    prom_bucket_stride, prom_bucket_metric); `device` is keyword-only."""
    import inspect
    from deepflow_tpu.runtime.stats import StatsRegistry as JStats
    from deepflow_tpu_torch.runtime.stats import StatsRegistry as TStats
    jp = list(inspect.signature(jred.AppRedExporter.__init__).parameters)
    tsig = inspect.signature(tred.AppRedExporter.__init__).parameters
    assert list(tsig)[:-1] == jp
    assert tsig["device"].kind is inspect.Parameter.KEYWORD_ONLY
    (jexp, jreg, jroot), (texp, treg, troot) = _bucket_pair(
        tmp_path, stride=16, groups=32, batch_rows=256)
    jstats, tstats = JStats(), TStats()
    from deepflow_tpu.store import dict_store as jdicts
    from deepflow_tpu_torch.store import dict_store as tdicts
    j2 = jred.AppRedExporter(jdb.Store(jroot + "2"), None, 256, 2.5, jstats,
                             jdicts.TagDictRegistry(None), 16, "m_bucket")
    t2 = tred.AppRedExporter(tdb.Store(troot + "2"), None, 256, 2.5, tstats,
                             tdicts.TagDictRegistry(None), 16, "m_bucket",
                             device="cpu")
    try:
        for a, b in ((texp, jexp), (t2, j2)):
            assert a.batcher.capacity == b.batcher.capacity
            assert a.window_seconds == b.window_seconds
            assert a.cfg.groups == b.cfg.groups
            np.testing.assert_array_equal(a._bucket_idx, b._bucket_idx)
            assert a._bucket_les == b._bucket_les
            assert a._bucket_metric_h == b._bucket_metric_h
        assert [s.module for s in tstats._sources] == \
            [s.module for s in jstats._sources] == ["exporter.app_red"]
    finally:
        for e in (j2, t2):
            e.close()
        _close_pair((jexp, jreg, jroot), (texp, treg, troot))


def test_kernel_error_is_kept_and_raised(monkeypatch):
    """A kernel that cannot launch raises KernelError out of process(),
    and every later process(), flush_window() and close() raises it."""
    exp = tred.AppRedExporter(batch_rows=64, device="cpu",
                              cfg=tas.AppSuiteConfig(groups=8))
    rng = np.random.default_rng(32)
    cols = _stream(rng, 100, endpoints=8)
    closed = False
    try:
        exp.process([("l7_flow_log", 0, cols, -1)])

        def broken(*a, **k):
            raise KernelError("hist: no kernel")
        monkeypatch.setattr(cuda_hist, "hist_add_", broken)
        with pytest.raises(KernelError):
            exp.process([("l7_flow_log", 0, cols, -1)])
        with pytest.raises(KernelError):
            exp.flush_window()
        closed = True
        with pytest.raises(KernelError):
            exp.close()
    finally:
        if not closed:
            exp.close()


def test_no_store_reads_nothing_back():
    exp = tred.AppRedExporter(batch_rows=128, device="cpu",
                              cfg=tas.AppSuiteConfig(groups=16))
    try:
        exp.process([("l7_flow_log", 0,
                      _stream(np.random.default_rng(33), 300, 16), -1)])
        out = exp.flush_window(now=1.0)
        assert float(out.requests.sum()) == 300
        assert exp.counters()["d2h_transfers"] == 0
        assert exp.last_output is out
    finally:
        exp.close()
