"""The port's `QuerierServer` (deepflow_tpu_torch/querier/server.py) against
the JAX package's, on the CPU, over HTTP.

One store directory, written once with the JAX package's schemas
(flow_metrics rows, `ext_samples`, an `in_process_profile` table and two
l7 traces), is opened by both servers, each through its own Store and
dictionaries. The sketch and anomaly tables of each package read the same
snapshot directories (written by the port's exporter), the timelines are
fed the same samples and the incident recorders share one bundle
directory. Both servers listen on port 0; every route must answer with
the same status, content type and body bytes.
"""

import json
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from deepflow_tpu.pipelines.ext_metrics import SAMPLE_TABLE
from deepflow_tpu.pipelines.profile import PROFILE_DB, PROFILE_TABLE
from deepflow_tpu.pipelines.schemas import L7_TABLE
from deepflow_tpu.querier.server import QuerierServer as JServer
from deepflow_tpu.replay.generator import ddos_ramp
from deepflow_tpu.runtime import incident as jinc
from deepflow_tpu.runtime import timeline as jtl
from deepflow_tpu.runtime.snapbus import SnapshotBus as JBus
from deepflow_tpu.serving import AnomalyTables as JAnomaly
from deepflow_tpu.serving import SketchTables as JTables
from deepflow_tpu.serving import SnapshotCache as JCache
from deepflow_tpu.store import db as jdb
from deepflow_tpu.store import dict_store as jdicts
from deepflow_tpu.store.table import AggKind, ColumnSpec, TableSchema
from deepflow_tpu_torch.anomaly.detectors import AnomalyConfig
from deepflow_tpu_torch.models import flow_suite
from deepflow_tpu_torch.querier.server import QuerierServer
from deepflow_tpu_torch.runtime import incident as tinc
from deepflow_tpu_torch.runtime import timeline as ttl
from deepflow_tpu_torch.runtime.faults import default_faults
from deepflow_tpu_torch.runtime.snapbus import SnapshotBus
from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter
from deepflow_tpu_torch.serving import (AnomalyTables, SketchTables,
                                        SnapshotCache)
from deepflow_tpu_torch.store import db as tdb
from deepflow_tpu_torch.store import dict_store as tdicts

NOW = 5000.0
T0 = 1_700_000_000


def _write_store(root):
    rng = np.random.default_rng(41)
    store = jdb.Store(root)
    reg = jdicts.TagDictRegistry(root)
    # a flow table
    flows = store.create_table("flow_metrics", TableSchema(
        name="flows",
        columns=(ColumnSpec("timestamp", np.dtype(np.uint32), AggKind.KEY),
                 ColumnSpec("ip", np.dtype(np.uint32), AggKind.KEY),
                 ColumnSpec("server_port", np.dtype(np.uint32), AggKind.KEY),
                 ColumnSpec("byte_tx", np.dtype(np.uint32), AggKind.SUM),
                 ColumnSpec("rtt_max", np.dtype(np.uint32), AggKind.MAX))))
    n = 3000
    flows.append({"timestamp": (T0 + rng.integers(0, 120, n)).astype(np.uint32),
                  "ip": rng.integers(1, 9, n).astype(np.uint32),
                  "server_port": rng.choice([80, 443, 53], n).astype(
                      np.uint32),
                  "byte_tx": rng.integers(0, 5000, n).astype(np.uint32),
                  "rtt_max": rng.integers(0, 9999, n).astype(np.uint32)})
    # ext_samples
    t = store.create_table("ext_metrics", SAMPLE_TABLE)
    md, ld = reg.get("metric_name"), reg.get("label_set")
    rows = []
    for job, start in (("api", 10.0), ("web", 100.0)):
        for inst in ("i1", "i2"):
            lh = ld.encode_one(f"instance={inst},job={job}")
            ctr = start + np.cumsum(rng.poisson(5, 30))
            for i in range(30):
                rows.append((1000 + i * 10, md.encode_one("rps"), lh,
                             ctr[i]))
    arr = np.array(rows)
    t.append({"timestamp": arr[:, 0].astype(np.uint32),
              "metric": arr[:, 1].astype(np.uint32),
              "labels": arr[:, 2].astype(np.uint32),
              "value": arr[:, 3].astype(np.float32)})
    # profile stacks
    p = store.create_table(PROFILE_DB, PROFILE_TABLE)
    stacks, names = reg.get("profile_stack"), reg.get("profile_name")
    prow = [("main;handler;db_query", 10), ("main;handler;db_query", 5),
            ("main;handler;render", 7), ("main;gc", 3)]
    k = len(prow)
    p.append({"timestamp": np.full(k, 1000, np.uint32),
              "app_service": np.full(k, names.encode_one("checkout"),
                                     np.uint32),
              "event_type": np.full(k, names.encode_one("on-cpu"),
                                    np.uint32),
              "stack": np.array([stacks.encode_one(s) for s, _ in prow],
                                np.uint32),
              "pid": np.full(k, 1, np.uint32),
              "vtap_id": np.full(k, 1, np.uint32),
              "pod_id": np.zeros(k, np.uint32),
              "value": np.array([v for _, v in prow], np.uint32)})
    # two traces in l7_flow_log
    l7 = store.create_table("flow_log", L7_TABLE)
    s = reg.get("l7_endpoint")
    spans = [("trace-a", "a1", "", "GET /api", "gateway", 1_000_000,
              1_050_000, 0),
             ("trace-a", "a2", "a1", "SELECT users", "backend", 1_010_000,
              1_030_000, 0),
             ("trace-b", "b1", "", "GET /slow", "gateway", 2_000_000,
              2_500_000, 1)]
    cols = {c.name: np.zeros(len(spans), c.dtype) for c in L7_TABLE.columns}
    for i, (tr, sp, par, ep, svc, st, en, status) in enumerate(spans):
        cols["trace_id_hash"][i] = s.encode_one(tr)
        cols["span_id_hash"][i] = s.encode_one(sp)
        cols["parent_span_id_hash"][i] = s.encode_one(par) if par else 0
        cols["endpoint_hash"][i] = s.encode_one(ep)
        cols["app_service_hash"][i] = s.encode_one(svc)
        cols["start_time_us"][i], cols["end_time_us"][i] = st, en
        cols["status"][i] = status
        cols["timestamp"][i] = st // 1_000_000
        cols["l7_protocol"][i] = 20
        cols["ip_src"][i], cols["ip_dst"][i] = 0x0A000001, 0x0A000002
        cols["port_dst"][i] = 80
        cols["rrt_us"][i] = en - st
        cols["_id"][i] = i + 1
    l7.append(cols)
    reg.flush()
    reg.close()


def _write_snapshots(sketch_dir, anomaly_dir):
    """Sketch windows and the ramp's alert windows from the port's
    exporters."""
    default_faults().disarm()
    rng = np.random.default_rng(43)
    from deepflow_tpu_torch.batch.schema import L4_SCHEMA
    exp = TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(
        cms_log2_width=12, ring_size=256, hll_groups=32, hll_precision=8,
        entropy_log2_buckets=8), batch_rows=2048, window_seconds=3600,
        checkpoint_dir=sketch_dir, wire="dict", device="cpu")
    try:
        for w in range(3):
            cols = {name: rng.integers(0, 64, 4000).astype(dt)
                    for name, dt in L4_SCHEMA.columns}
            exp.process([("l4_flow_log", 0, cols, -1)])
            exp.flush_window(now=1000.0 + w)
    finally:
        exp.close()
    exp = TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(), batch_rows=4096,
                            window_seconds=3600, wire="lanes", device="cpu",
                            anomaly=AnomalyConfig(), anomaly_dir=anomaly_dir)
    try:
        for w, _phase, cols in ddos_ramp(seed=7).windows():
            if w >= 16:
                break
            exp.process([("l4_flow_log", 0, cols, -1)])
            exp.flush_window(now=1000.0 + w)
    finally:
        exp.close()


def _timeline(mod):
    tl = mod.Timeline(sample_s=1.0, hot_samples=16, coarse_every=4)
    for i in range(40):
        tl.record("tpu_sketch_rows_in", 1000.0 * i * i, now=1000.0 + i)
        tl.record("querier_read_p99_s", 0.01 * (i % 7), now=1000.0 + i)
    return tl


def _incidents(d):
    rec = tinc.IncidentRecorder(d, min_interval_s=0.0,
                                clock=lambda: 1000.0)
    for i, kind in enumerate(("breaker_open", "health_degraded",
                              "anomaly_alert")):
        rec._clock = (lambda t: lambda: t)(1000.0 + 10 * i)
        rec.capture(kind, {"n": i})


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("querier_server")
    store, sk, an, inc = (str(root / x) for x in ("store", "sketch",
                                                  "anomaly", "incidents"))
    _write_store(store)
    _write_snapshots(sk, an)
    _incidents(inc)
    jreg, treg = jdicts.TagDictRegistry(store), tdicts.TagDictRegistry(store)
    j = JServer(jdb.Store(store), jreg, port=0,
                sketch=JTables(JCache(JBus(sk), clock=lambda: NOW)),
                anomaly=JAnomaly(JCache(JBus(an, name="anomaly"),
                                        clock=lambda: NOW)),
                timeline=_timeline(jtl),
                incidents=jinc.IncidentRecorder(inc))
    t = QuerierServer(tdb.Store(store), treg, port=0,
                      sketch=SketchTables(SnapshotCache(SnapshotBus(sk),
                                                        clock=lambda: NOW)),
                      anomaly=AnomalyTables(SnapshotCache(
                          SnapshotBus(an, name="anomaly"),
                          clock=lambda: NOW)),
                      timeline=_timeline(ttl),
                      incidents=tinc.IncidentRecorder(inc), device="cpu")
    try:
        j.start()
        t.start()
        yield j, t
    finally:
        j.close()
        t.close()
        jreg.close()
        treg.close()


def _call(port, method, path, body=None, ctype=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method=method)
    if ctype:
        req.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _form(**kw):
    return urllib.parse.urlencode(kw).encode()


def _sql(sql, db=None):
    return ("POST", "/v1/query",
            _form(sql=sql, **({"db": db} if db else {})), None)


def _q(path, **kw):
    return ("GET", f"{path}?{urllib.parse.urlencode(kw)}", None, None)


def _read_body():
    from deepflow_tpu_torch.utils import snappy
    from deepflow_tpu_torch.wire.gen import telemetry_pb2 as pb
    req = pb.ReadRequest()
    q = req.queries.add()
    q.start_timestamp_ms, q.end_timestamp_ms = 1_000_000, 1_200_000
    for typ, name, value in ((0, "__name__", "rps"), (2, "job", "a.*")):
        m = q.matchers.add()
        m.type, m.name, m.value = typ, name, value
    return snappy.compress(req.SerializeToString())


ROUTES = [
    ("GET", "/health", None, None),
    _sql("SELECT ip, Sum(byte_tx) AS b, Max(rtt_max) AS r FROM flows "
         "GROUP BY ip ORDER BY b DESC", "flow_metrics"),
    _sql(f"SELECT time(60), server_port, Count(*) AS n FROM flows WHERE "
         f"timestamp >= {T0} AND timestamp < {T0 + 90} "
         f"GROUP BY time(60), server_port", "flow_metrics"),
    _sql("SHOW TABLES"),
    _sql("SELECT sketch.topk(5) FROM sketch"),
    _sql("SELECT sketch.hll_card() FROM sketch WHERE time >= 1000"),
    _sql("SELECT * FROM anomaly WHERE time >= 1010"),
    _sql("SELECT * FROM timeline LIMIT 20"),
    _sql("SELECT * FROM incidents"),
    _sql("SELECT nope FROM flows", "flow_metrics"),
    ("POST", "/v1/query", json.dumps({"sql": "SELECT Count(*) AS n "
                                      "FROM flows", "db": "flow_metrics"})
     .encode(), "application/json"),
    _q("/api/v1/query", query='rate(rps{job="api"}[1m])', time=1200),
    _q("/api/v1/query", query="sketch_topk(3)", time=1002),
    _q("/api/v1/query", query='anomaly_score{detector="entropy_ddos"}',
       time=1012),
    _q("/api/v1/query", query="tpu_sketch_rows_in", time=1030),
    _q("/api/v1/query", query="sum(", time=1200),
    ("POST", "/api/v1/query", _form(query="sum by (job) (rps)", time=1200),
     "application/x-www-form-urlencoded"),
    _q("/api/v1/query_range", query="sum by (job) (rate(rps[1m]))",
       start=1060, end=1290, step=30),
    _q("/api/v1/query_range", query="querier_read_p99_s > bool 0.03",
       start=1000, end=1039, step=3),
    _q("/api/v1/query_range", query="sketch_hll_card()", start=1000,
       end=1010, step=1),
    ("POST", "/api/v1/query_range?start=1000&end=1290&step=60",
     _form(query="rps"), "application/x-www-form-urlencoded"),
    ("GET", "/api/v1/labels", None, None),
    ("GET", "/api/v1/label/job/values", None, None),
    ("GET", "/api/v1/label/__name__/values", None, None),
    _q("/api/v1/series", **{"match[]": 'rps{job="web"}', "start": 900,
                            "end": 1400}),
    ("GET", "/api/v1/series", None, None),
    ("POST", "/api/v1/read", _read_body(), "application/x-protobuf"),
    _q("/v1/profile/flame", app_service="checkout"),
    _q("/v1/profile/top", app_service="checkout", limit=2, start=900,
       end=1000),
    ("GET", "/api/echo", None, None),
    ("GET", "/api/traces/trace-a", None, None),
    ("GET", "/api/traces/trace-nope", None, None),
    ("GET", "/api/search", None, None),
    _q("/api/search", service="gateway", minDuration="100ms"),
    ("GET", "/api/search/tags", None, None),
    ("GET", "/api/search/tag/service.name/values", None, None),
    _q("/v1/l7_tracing", _id=2),
    ("GET", "/api/v1/adapter/tracing", None, None),
    ("GET", "/no/such/route", None, None),
]


@pytest.mark.parametrize("route", ROUTES,
                         ids=[f"r{i:02d}" for i in range(len(ROUTES))])
def test_route_matches_jax(servers, route):
    j, t = servers
    method, path, body, ctype = route
    want = _call(j.port, method, path, body, ctype)
    got = _call(t.port, method, path, body, ctype)
    assert got == want
    assert want[2]


def test_answers_are_not_empty(servers):
    """The routes above answer with data, not empty results."""
    _, t = servers
    for route in ROUTES[1:9]:
        status, _, body = _call(t.port, *route)
        assert status == 200 and json.loads(body)["result"]["values"], route
    status, _, body = _call(t.port, *ROUTES[12])
    assert status == 200 and json.loads(body)["data"]["result"]


def test_server_defaults_to_the_card(tmp_path):
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            QuerierServer(tdb.Store(str(tmp_path)),
                          tdicts.TagDictRegistry(None), port=0)
    srv = QuerierServer(tdb.Store(str(tmp_path)),
                        tdicts.TagDictRegistry(None), port=0, device="cpu")
    try:
        srv.start()
        assert _call(srv.port, "GET", "/health")[0] == 200
        assert srv.engine.device.type == srv.prom.device.type == "cpu"
    finally:
        srv.close()
