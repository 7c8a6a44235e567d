"""The port's server process (deepflow_tpu_torch/server.py) against the
JAX package's `Server`, on the CPU, with the controller off.

Both servers read one config file and take the same frames over
loopback TCP, one after the other (l7 PROTOCOLLOG, OTel, PROMETHEUS and
TELEGRAF, made from a seed with numpy); the same SQL and PromQL requests
through each querier's HTTP routes answer with the same JSON, and the
port's answers equal its engines queried directly on the same store.
Also: reload rebuilds and answers again; a config with the controller on
(or the JAX default, which enables it) raises NotImplementedError naming
`controller.enabled`; the config reads as JSON where PyYAML is missing;
the StatsShipper puts the same DFSTATS bytes on the wire as the JAX one
and its loop lands in deepflow_system; `python -m
deepflow_tpu_torch.server -f <json> --device cpu` serves and stops on
SIGTERM."""

import builtins
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from deepflow_tpu import server as jserver
from deepflow_tpu.runtime.stats import StatSample as JSample
from deepflow_tpu.runtime.stats import StatsRegistry as JRegistry
from deepflow_tpu.runtime.stats import StatsShipper as JShipper
from deepflow_tpu_torch import server as tserver
from deepflow_tpu_torch.pipelines import flow_log as tflow_log
from deepflow_tpu_torch.runtime.stats import StatSample as TSample
from deepflow_tpu_torch.runtime.stats import StatsRegistry as TRegistry
from deepflow_tpu_torch.runtime.stats import StatsShipper as TShipper

import torch_pair as tp
from test_torch_aux_pipelines import _ext_frames
from test_torch_otel import l7_frames, otel_frames

REPO = Path(__file__).resolve().parent.parent


def _req(url, form=None):
    data = None if form is None else urllib.parse.urlencode(form).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                timeout=10) as r:
        return json.load(r)


def _config(tmp_path, name, **over):
    cfg = {"controller": {"enabled": False},
           "ingester": {"port": 0, "store_path": str(tmp_path / name),
                        "n_decoders": 1, "app_red_window_s": 3600},
           "querier": {"enabled": True, "port": 0},
           "self_telemetry": False}
    for k, v in over.items():
        cfg[k] = v
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


SQL = [("flow_log", "SELECT Count(*) AS n FROM l7_flow_log"),
       ("flow_log", "SELECT port_dst, Count(*) AS n, Max(rrt_us) AS m "
                    "FROM l7_flow_log GROUP BY port_dst ORDER BY port_dst"),
       ("ext_metrics", "SELECT Count(*) AS n FROM ext_samples")]
PROMQL = ["sum(metric_1_total)", "count(cpu.usage_idle)",
          'metric_2_total{cluster="prod-a"}']


def _serve(srv, stages):
    """Drive a started server, then answer SQL and PromQL over HTTP."""
    tp.drive(srv.ingester, stages)
    srv.ingester.flush()
    base = f"http://127.0.0.1:{srv.querier.port}"
    sql = [_req(f"{base}/v1/query", form={"db": db, "sql": q})
           for db, q in SQL]
    prom = [_req(f"{base}/api/v1/query?" + urllib.parse.urlencode(
        {"query": q, "time": 1_700_000_100})) for q in PROMQL]
    return sql, prom


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("server")
    rng = np.random.default_rng(101)
    l7 = l7_frames(rng, 200)
    raw, comp, n = otel_frames(rng, 2)
    ext = _ext_frames(rng)[:4]
    stages = [
        (l7, lambda ing: tp.offered(ing, "l7_flow_log") == 200),
        (raw + comp, lambda ing: tp.offered(ing, "l7_flow_log.otel") == n),
        (ext, lambda ing: ing.ext_metrics.samples == 96 + 20 + 24 + 120),
    ]
    out = {}
    for package, mod, kw in (("jax", jserver, {}),
                             ("port", tserver, {"device": "cpu"})):
        path = _config(tmp, package)
        if package == "jax":
            from deepflow_tpu.pipelines import flow_log as jflow_log
            jflow_log._ID_NEXT[0] = 1
        else:
            tflow_log._ID_NEXT[0] = 1
        srv = mod.Server(path, **kw)
        srv.start()
        try:
            answers = _serve(srv, stages)
            direct = None
            if package == "port":
                from deepflow_tpu_torch.querier.engine import QueryEngine
                from deepflow_tpu_torch.querier.promql import PromEngine
                eng = QueryEngine(srv.ingester.store, srv.ingester.tag_dicts,
                                  device="cpu")
                prom = PromEngine(srv.ingester.store,
                                  srv.ingester.tag_dicts, device="cpu")
                direct = ([eng.execute(q, db=db) for db, q in SQL],
                          [prom.query(q, at=1_700_000_100) for q in PROMQL])
            out[package] = (answers, direct, srv.controller,
                            srv.ingester.receiver.counters())
        finally:
            srv.close()
    return out


def _text(x):
    return json.dumps(x, sort_keys=True)


def test_http_answers_match_jax_server(served):
    t, j = served["port"][0], served["jax"][0]
    assert _text(t) == _text(j)
    assert t[0][0]["result"]["values"][0][0] > 200
    assert all(p["status"] == "success" and p["data"]["result"]
               for p in t[1])
    assert served["port"][2] is None and served["jax"][2] is None
    assert served["port"][3] == served["jax"][3]
    assert served["port"][3]["no_handler"] == 0


def test_http_answers_equal_the_engines(served):
    (sql, prom), (dsql, dprom) = served["port"][0], served["port"][1]
    for got, want in zip(sql, dsql):
        assert _text(got["result"]) == _text(want.as_dict())
    for got, want in zip(prom, dprom):
        assert _text(got["data"]["result"]) == _text(want)


def test_reload_rebuilds_and_answers(tmp_path):
    """The querier off, then on with a new throttle: reload() rebuilds
    both roles and the new querier answers, as the JAX server's reload
    does; an unchanged config is a no-op."""
    res = {}
    for package, mod, kw in (("jax", jserver, {}),
                             ("port", tserver, {"device": "cpu"})):
        path = _config(tmp_path, package, querier={"enabled": False})
        srv = mod.Server(path, **kw)
        srv.start()
        try:
            assert srv.querier is None
            ing = srv.ingester
            srv.reload()
            assert srv.ingester is ing            # unchanged: no rebuild
            cfg = json.loads(Path(path).read_text())
            cfg["ingester"]["throttle_per_s"] = 9000
            cfg["querier"] = {"enabled": True, "port": 0}
            Path(path).write_text(json.dumps(cfg))
            srv.reload()
            assert srv.reload_error is None
            assert srv.ingester is not ing
            assert srv.ingester.cfg.throttle_per_s == 9000
            tp.drive(srv.ingester, [(l7_frames(
                np.random.default_rng(102), 50),
                lambda i: tp.offered(i, "l7_flow_log") == 50)])
            srv.ingester.flush()
            res[package] = _req(
                f"http://127.0.0.1:{srv.querier.port}/v1/query",
                form={"db": "flow_log",
                      "sql": "SELECT Count(*) AS n FROM l7_flow_log"})
        finally:
            srv.close()
    assert res["port"] == res["jax"]
    assert res["port"]["result"]["values"][0][0] == 50


@pytest.mark.parametrize("controller", [None, {}, {"enabled": True}])
def test_controller_on_raises(tmp_path, controller):
    """The controller role is not ported: the JAX default (no
    `controller` block, or one without `enabled`) and an explicit
    enabled: true raise NotImplementedError naming controller.enabled."""
    path = _config(tmp_path, "ctl")
    cfg = json.loads(Path(path).read_text())
    if controller is None:
        del cfg["controller"]
    else:
        cfg["controller"] = controller
    Path(path).write_text(json.dumps(cfg))
    with pytest.raises(NotImplementedError, match="controller.enabled"):
        tserver.Server(path, device="cpu")
    with pytest.raises(NotImplementedError, match="controller.enabled"):
        tserver.Server(None, device="cpu")


def test_json_config_without_yaml(tmp_path, monkeypatch):
    """Where PyYAML is missing the config reads as JSON (the same dict
    the JAX package's YAML reader gives), a text that is not JSON fails
    naming the file, and a missing or empty file reads as {}."""
    path = _config(tmp_path, "json", ingester={"port": 0, "n_decoders": 3,
                                               "app_red_prom_buckets": 8})
    want = jserver.load_config(path)
    assert tserver.load_config(path) == want          # through PyYAML
    real = builtins.__import__

    def no_yaml(name, *a, **k):
        if name == "yaml":
            raise ImportError("no yaml here")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_yaml)
    assert tserver.load_config(path) == want
    bad = tmp_path / "bad.yaml"
    bad.write_text("ingester:\n  port: 0\n")
    with pytest.raises(ValueError, match="bad.yaml.*JSON"):
        tserver.load_config(str(bad))
    empty = tmp_path / "empty.json"
    empty.write_text("  \n")
    assert tserver.load_config(str(empty)) == {}
    assert tserver.load_config(str(tmp_path / "missing.json")) == {}
    assert tserver.load_config(None) == {}
    # the keys the JAX server maps, and a passed-through field
    cfg = tserver.ingester_config(want["ingester"])
    assert (cfg.listen_port, cfg.n_decoders, cfg.app_red_prom_buckets,
            cfg.throttle_per_s) == (0, 3, 8, 50_000)


def _listen():
    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(1)
    got = bytearray()

    def pump():
        c, _ = ls.accept()
        with c:
            while True:
                b = c.recv(65536)
                if not b:
                    return
                got.extend(b)
    th = threading.Thread(target=pump, daemon=True)
    th.start()
    return ls, th, got


def test_stats_shipper_bytes_match_jax():
    """The same samples (numbers, bools and a descriptive string among
    them) through both shippers: the DFSTATS frames on the wire are
    byte for byte the same."""
    wire = {}
    for package, reg_cls, ship_cls, sample in (
            ("jax", JRegistry, JShipper, JSample),
            ("port", TRegistry, TShipper, TSample)):
        ls, th, got = _listen()
        reg = reg_cls()
        ship = ship_cls(reg, f"127.0.0.1:{ls.getsockname()[1]}", vtap_id=4)
        for i in range(150):
            ship._on_sample(sample(
                1_700_000_000 + i, f"mod.{i % 5}", {"host": "ing-1"},
                {"rx": i * 7, "ok": i % 2 == 0, "ratio": i / 3.0,
                 "mode": "local"}))
        ship.close()
        th.join(timeout=10)
        ls.close()
        wire[package] = (bytes(got), ship.sender.counters())
    assert wire["port"] == wire["jax"]
    assert wire["port"][1]["sent_records"] == 150
    assert len(wire["port"][0]) > 0


def test_stats_shipper_loop_lands_in_deepflow_system(tmp_path):
    """self_telemetry: the ingester's counters ship back through its own
    socket as DFSTATS and land in deepflow_system.ext_samples, under
    `<module>.<counter>` metric names."""
    path = _config(tmp_path, "selftel", self_telemetry=True)
    srv = tserver.Server(path, device="cpu")
    srv.start()
    try:
        assert srv.stats_shipper.sender.port == srv.ingester.port
        srv.ingester.stats.collect()
        srv.stats_shipper.flush()
        table = srv.ingester.store.table("deepflow_system", "ext_samples")
        md = srv.ingester.tag_dicts.get("metric_name")
        found = set()

        def landed():
            srv.ingester.flush()
            found.update(md.decode(int(h))
                         for h in set(table.scan()["metric"].tolist()))
            return "receiver.rx_frames" in found
        tp.wait(landed, "DFSTATS rows")
        assert "ext_metrics.samples" in found
        assert srv.ingester.receiver.counters()["no_handler"] == 0
    finally:
        srv.close()


def test_main_serves_and_stops(tmp_path):
    """`python -m deepflow_tpu_torch.server -f <json> --device cpu`
    starts both roles, answers a query, and exits 0 on SIGTERM."""
    path = _config(tmp_path, "main")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepflow_tpu_torch.server", "-f", path,
         "--device", "cpu"], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "server up" in line, (line, proc.stderr.read()
                                     if proc.poll() is not None else "")
        ing_port, q_port = [int(p) for p in re.findall(r":(\d+)", line)]
        assert _req(f"http://127.0.0.1:{q_port}/api/v1/labels")[
            "status"] == "success"
        tp.drive(None, [(l7_frames(np.random.default_rng(103), 50),
                         lambda _: True)], port=ing_port)
        out = {}

        def answered():
            out.update(_req(
                f"http://127.0.0.1:{q_port}/v1/query",
                form={"db": "flow_log",
                      "sql": "SELECT Count(*) AS n FROM l7_flow_log"}))
            vals = out.get("result", {}).get("values")
            return bool(vals) and vals[0][0] == 50
        # the throttler releases its bucket on the janitor's 1 s roll and
        # the writer flushes every 10 s
        tp.wait(answered, "the rows through the querier", timeout=60)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
