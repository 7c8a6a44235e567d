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
    with pytest.raises(NotImplementedError, match="dict_store"):
        tred.AppRedExporter(prom_bucket_stride=1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tred.AppRedExporter()


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
