"""The port's SQL querier (deepflow_tpu_torch/querier/engine.py) against the
JAX package's, on the CPU.

One seeded flow_metrics data set (256 vtap_flow_port tag tuples reporting
once a second for 30 s) is written twice: by the port's StoreWriter and
RollupManager into one store, by the JAX package's into another. Each
statement goes through the JAX `QueryEngine` over the JAX store and the
port's `QueryEngine(device="cpu")` over the port's store; columns and
rows must be equal, exactly. Resource names resolve through one JAX
`TagRecorder` given to both engines (duck-typed: the port has no
controller). Every GROUP BY the port's engine issues is also run with
`method="device"` on CPU tensors and held against `method="host"`.
"""

import numpy as np
import pytest

from deepflow_tpu.controller import ResourceModel
from deepflow_tpu.controller.model import make_resource
from deepflow_tpu.controller.tagrecorder import TagRecorder
from deepflow_tpu.pipelines.schemas import METRICS_TABLE as J_METRICS
from deepflow_tpu.querier import QueryEngine as JEngine
from deepflow_tpu.store import db as jdb
from deepflow_tpu.store import dict_store as jdicts
from deepflow_tpu.store import rollup as jrollup
from deepflow_tpu.store import writer as jwriter
from deepflow_tpu_torch.pipelines.schemas import METRICS_TABLE
from deepflow_tpu_torch.querier import QueryEngine
from deepflow_tpu_torch.querier import engine as tengine
from deepflow_tpu_torch.store import db as tdb
from deepflow_tpu_torch.store import dict_store as tdicts
from deepflow_tpu_torch.store import rollup as trollup
from deepflow_tpu_torch.store import writer as twriter

DB = "flow_metrics"
T0 = 1_700_000_040                          # a minute boundary
SECONDS = 30
TUPLES = 256
ENDPOINTS = ["GET /api/users", "GET /api/orders", "POST /api/orders",
             "GET /health", "PUT /api/users/1", "DELETE /cart"]
PODS = {i: f"pod-{i % 5}" for i in range(1, 17)}    # names shared by ids


def make_rows(seed=12):
    """TUPLES distinct key tuples, each reporting once a second."""
    rng = np.random.default_rng(seed)
    keys = [c for c in METRICS_TABLE.columns if c.agg.value == "key"
            and c.name not in ("timestamp", "endpoint_hash")]
    t = {}
    for c in keys:
        hi = {"ip": 24, "server_port": 12, "vtap_id": 6, "l3_epc_id": 5,
              "pod_id": 17, "tag_code": 3}.get(c.name, 3)
        v = rng.integers(0, hi, TUPLES)
        if c.name == "ip":
            v = 0x0A000000 + v
        if c.name == "l3_epc_id":
            v = v - 1                               # -1 .. 3
        if c.name == "server_port":
            v = np.array([80, 443, 8080, 53, 22, 3306, 6379, 9092, 5432,
                          25, 110, 8443])[v]
        t[c.name] = v.astype(c.dtype)
    ep = rng.integers(0, len(ENDPOINTS), TUPLES)
    order = np.concatenate([rng.permutation(TUPLES)
                            for _ in range(SECONDS)])
    n = len(order)
    cols = {"timestamp": (T0 + np.repeat(np.arange(SECONDS), TUPLES))
            .astype(np.uint32)}
    for k, v in t.items():
        cols[k] = v[order]
    for c in METRICS_TABLE.columns:
        if c.agg.value != "key":
            med = 1000.0 if c.name.endswith(("_sum", "_max")) else 5.0
            cols[c.name] = np.round(rng.lognormal(np.log(med), 1.2, n)
                                    ).astype(c.dtype)
    return cols, ep[order]


def write_store(pkg, root, cols, ep_idx):
    """One package's store: the base table through its StoreWriter in
    two flushes, the 1m tier through its RollupManager."""
    db, dicts, rollup, writer = pkg
    reg = dicts.TagDictRegistry(root)
    hashes = np.array([reg.get("l7_endpoint").encode_one(s)
                       for s in ENDPOINTS], np.uint32)
    cols = dict(cols, endpoint_hash=hashes[ep_idx])
    store = db.Store(root)
    kw = {"device": "cpu"} if rollup is trollup else {}
    schema = METRICS_TABLE if rollup is trollup else J_METRICS
    mgr = rollup.RollupManager(store, DB, schema, intervals=(60,), **kw)
    w = writer.StoreWriter(mgr.base, batch_rows=1 << 30)
    half = len(cols["timestamp"]) // 2
    for sl in (slice(0, half), slice(half, None)):
        w.put({k: v[sl] for k, v in cols.items()})
        w.flush()
    assert mgr.advance(now=T0 + 3600)[60] > 0
    return store, reg, cols


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    raw, ep_idx = make_rows()
    model = ResourceModel()
    model.update_domain("d", [make_resource("pod", i, name, "d")
                              for i, name in PODS.items()])
    recorder = TagRecorder(model)
    jstore, jreg, cols = write_store((jdb, jdicts, jrollup, jwriter),
                                     str(tmp_path_factory.mktemp("jax")),
                                     raw, ep_idx)
    tstore, treg, tcols = write_store((tdb, tdicts, trollup, twriter),
                                      str(tmp_path_factory.mktemp("port")),
                                      raw, ep_idx)
    np.testing.assert_array_equal(cols["endpoint_hash"],
                                  tcols["endpoint_hash"])
    j = JEngine(jstore, jreg, tagrecorder=recorder)
    t = QueryEngine(tstore, treg, tagrecorder=recorder, device="cpu")
    yield j, t, cols
    jreg.close()
    treg.close()


B = "vtap_flow_port"
W = f"timestamp >= {T0 + 5} AND timestamp < {T0 + 20}"
STATEMENTS = [
    # GROUP BY over 1, 2 and 3 u32 tags
    f"SELECT ip, Sum(byte_tx) AS b, Max(rtt_max) AS r, Count(*) AS n "
    f"FROM {B} GROUP BY ip ORDER BY ip",
    f"SELECT vtap_id, server_port, Sum(packet_tx) AS p FROM {B} "
    f"GROUP BY vtap_id, server_port ORDER BY p DESC LIMIT 20",
    f"SELECT ip, server_port, vtap_id, Avg(rtt_sum) AS a, Min(srt_max) AS m "
    f"FROM {B} GROUP BY ip, server_port, vtap_id",
    # signed and 64-bit keys (the host sort lanes)
    f"SELECT l3_epc_id, Sum(byte_rx) AS b FROM {B} GROUP BY l3_epc_id",
    f"SELECT tag_code, protocol, Count(*) AS n FROM {B} "
    f"GROUP BY tag_code, protocol",
    # derived metrics: the library and inline arithmetic
    f"SELECT server_port, rtt_avg, byte, retrans_ratio FROM {B} "
    f"GROUP BY server_port",
    f"SELECT vtap_id, Sum(retrans_tx) / Sum(packet_tx) AS ratio, "
    f"Sum(byte_tx) * 8 AS bits FROM {B} GROUP BY vtap_id",
    f"SELECT Avg(byte_tx) AS a, Sum(byte_tx) / Count(*) AS d FROM {B}",
    # time pruning, time buckets, PerSecond
    f"SELECT Count(*) AS n, Sum(new_flow) AS f FROM {B} WHERE {W}",
    f"SELECT time(60) AS t, Sum(byte_tx) AS b FROM {B} GROUP BY time(60)",
    f"SELECT time(10), ip, Sum(packet_rx) AS p FROM {B} WHERE protocol = 1 "
    f"GROUP BY time(10), ip ORDER BY time",
    f"SELECT PerSecond(Sum(byte_tx)) AS r FROM {B} WHERE {W}",
    f"SELECT time(5), PerSecond(Sum(packet_tx)) AS r FROM {B} "
    f"GROUP BY time(5) ORDER BY time",
    # HAVING, ORDER BY, LIMIT and OFFSET
    f"SELECT ip, Sum(byte_tx) AS b FROM {B} GROUP BY ip HAVING b > 3000 "
    f"ORDER BY b DESC",
    f"SELECT server_port, Count(*) AS n FROM {B} GROUP BY server_port "
    f"HAVING n >= 600 AND n < 1500 ORDER BY n",
    f"SELECT ip, vtap_id, Count(*) AS n FROM {B} GROUP BY ip, vtap_id "
    f"ORDER BY n DESC, ip LIMIT 7 OFFSET 3",
    f"SELECT ip, byte_tx FROM {B} WHERE {W} AND vtap_id = 2 "
    f"ORDER BY byte_tx DESC LIMIT 10",
    f"SELECT * FROM {B} ORDER BY timestamp LIMIT 4",
    # boolean WHERE trees, IN
    f"SELECT Count(*) AS n FROM {B} WHERE vtap_id = 1 OR NOT "
    f"(protocol = 0 OR server_port IN (80, 443))",
    f"SELECT ip, Sum(byte_tx) AS b FROM {B} WHERE server_port NOT IN "
    f"(22, 53) AND {W} GROUP BY ip",
    # LIKE and REGEXP on a dictionary column, humanized GROUP BY
    f"SELECT endpoint_hash, Sum(l7_request) AS r FROM {B} WHERE "
    f"endpoint_hash LIKE 'GET /api/%' GROUP BY endpoint_hash",
    f"SELECT Count(*) AS n FROM {B} WHERE endpoint_hash NOT LIKE 'GET %'",
    f"SELECT endpoint_hash, Count(*) AS n FROM {B} WHERE endpoint_hash "
    f"REGEXP '(PUT|DELETE) /' GROUP BY endpoint_hash",
    f"SELECT endpoint_hash, Sum(l7_response) AS r FROM {B} "
    f"GROUP BY endpoint_hash HAVING endpoint_hash = 'GET /health'",
    # resource names through the tagrecorder (shared names widen =)
    f"SELECT Sum(byte_tx) AS b FROM {B} WHERE pod_id = 'pod-2'",
    f"SELECT Count(*) AS n FROM {B} WHERE pod_id IN ('pod-1', 'pod-4')",
    f"SELECT pod_id, Sum(byte_rx) AS b FROM {B} WHERE pod_id != 'pod-3' "
    f"GROUP BY pod_id",
    # Percentile: the row->group inverse path
    f"SELECT vtap_id, Percentile(rtt_max, 90) AS p FROM {B} "
    f"GROUP BY vtap_id",
    f"SELECT Percentile(byte_tx, 50) AS p FROM {B}",
    # WITH ... JOIN
    f"WITH q1 AS (SELECT ip, Sum(byte_tx) AS b FROM {B} WHERE protocol = 0 "
    f"GROUP BY ip), q2 AS (SELECT ip, Count(*) AS n FROM {B} "
    f"WHERE protocol = 2 GROUP BY ip) SELECT q1.ip, q1.b AS b, q2.n "
    f"FROM q1 LEFT JOIN q2 ON q1.ip = q2.ip ORDER BY b DESC",
    f"WITH a AS (SELECT vtap_id, Count(*) AS n FROM {B} WHERE vtap_id IN "
    f"(1, 2, 3) GROUP BY vtap_id), b AS (SELECT vtap_id, Max(rtt_max) AS m "
    f"FROM {B} WHERE vtap_id IN (2, 3, 4) GROUP BY vtap_id) "
    f"SELECT a.vtap_id, a.n AS left_n, b.m FROM a JOIN b "
    f"ON a.vtap_id = b.vtap_id",
    # the rollup tier by its names
    f"SELECT ip, Sum(byte_tx) AS b FROM {B}.1m GROUP BY ip",
    f"SELECT server_port, Max(rtt_max) AS m, Count(*) AS n "
    f"FROM flow_metrics.{B}.1m GROUP BY server_port",
    # SHOW
    "SHOW DATABASES",
    "SHOW TABLES",
    f"SHOW TAGS FROM {B}",
    f"SHOW METRICS FROM {B}",
    f"SHOW TAG vtap_id VALUES FROM {B}",
    f"SHOW TAG endpoint_hash VALUES FROM {B} LIMIT 3",
]

# statements both engines must refuse with the same error
ERRORS = [
    f"SELECT ip, byte_tx FROM {B} GROUP BY ip",
    f"SELECT PerSecond(Sum(byte_tx)) AS r FROM {B}",
    f"SELECT time(60), Sum(byte_tx) FROM {B} GROUP BY ip",
    f"SELECT ip FROM {B} GROUP BY ip HAVING nope > 1",
    f"SHOW TAG byte_tx VALUES FROM {B}",
    "SELECT Count(*) AS n FROM no_such_table",
]


@pytest.fixture
def device_checked(monkeypatch):
    """Run every GROUP BY of the port's engine that the device method
    takes (aggregates, no inverse, keys of at most 32 bits) both ways on
    CPU tensors: the device method must equal the host method."""
    calls = []
    real = trollup.group_reduce

    def both(cols, keys, aggs, return_inverse=False, method="auto",
             device="cuda"):
        out = real(cols, keys, aggs, return_inverse=return_inverse,
                   method=method, device=device)
        fits = all(np.asarray(cols[k]).dtype.itemsize <= 4 for k in keys)
        if aggs and not return_inverse and fits:
            dev = real(cols, keys, aggs, method="device", device="cpu")
            host = real(cols, keys, aggs, method="host", device="cpu")
            assert list(dev) == list(host)
            for k in host:
                assert dev[k].dtype == host[k].dtype, k
                np.testing.assert_array_equal(dev[k], host[k], err_msg=k)
        calls.append((tuple(keys), return_inverse))
        return out
    monkeypatch.setattr(tengine, "group_reduce", both)
    return calls


def _same(a, b):
    assert a.columns == b.columns
    assert len(a.values) == len(b.values)
    for ra, rb in zip(a.values, b.values):
        assert ra == rb
        assert [type(x) for x in ra] == [type(x) for x in rb]


@pytest.mark.parametrize("sql", STATEMENTS,
                         ids=[f"q{i:02d}" for i in range(len(STATEMENTS))])
def test_statement_matches_jax(engines, device_checked, sql):
    j, t, _ = engines
    want = j.execute(sql, db=DB)
    got = t.execute(sql, db=DB)
    _same(want, got)
    assert want.values, "the statement answers no rows"


@pytest.mark.parametrize("sql", ERRORS,
                         ids=[f"e{i}" for i in range(len(ERRORS))])
def test_refusals_match_jax(engines, sql):
    j, t, _ = engines
    with pytest.raises(Exception) as je:
        j.execute(sql, db=DB)
    with pytest.raises(Exception) as te:
        t.execute(sql, db=DB)
    assert type(te.value) is type(je.value)
    assert str(te.value) == str(je.value)


def test_groupby_equals_numpy(engines):
    """Two statements against a numpy GROUP BY of the rows written."""
    _, t, cols = engines
    res = t.execute(f"SELECT ip, vtap_id, Sum(byte_tx) AS b, "
                    f"Max(rtt_max) AS r, Count(*) AS n FROM {B} "
                    f"GROUP BY ip, vtap_id", db=DB)
    packed = np.stack([cols["ip"].astype(np.int64),
                       cols["vtap_id"].astype(np.int64)], axis=1)
    uniq, inv = np.unique(packed, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    b = np.bincount(inv, cols["byte_tx"].astype(np.float64))
    r = np.full(len(uniq), 0, np.int64)
    np.maximum.at(r, inv, cols["rtt_max"].astype(np.int64))
    n = np.bincount(inv)
    want = [[int(u[0]), int(u[1]), int(b[i]), int(r[i]), int(n[i])]
            for i, u in enumerate(uniq)]
    assert res.values == want
    res = t.execute(f"SELECT time(60) AS t, Sum(packet_tx) AS p FROM {B}.1m "
                    f"GROUP BY time(60)", db=DB)
    assert res.values == [[T0, int(cols["packet_tx"].astype(np.int64)
                                   .sum())]]


def test_paths_of_the_engine(engines, device_checked):
    """A Percentile asks for the row->group inverse; the others do not."""
    _, t, _ = engines
    t.execute(f"SELECT vtap_id, Percentile(rtt_max, 90) AS p FROM {B} "
              f"GROUP BY vtap_id", db=DB)
    t.execute(f"SELECT ip, Sum(byte_tx) AS b FROM {B} GROUP BY ip", db=DB)
    assert device_checked == [(("vtap_id",), True), (("ip",), False)]


def test_engine_defaults_to_the_card(tmp_path):
    import torch
    store = tdb.Store(str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            QueryEngine(store, tdicts.TagDictRegistry(None))
    assert QueryEngine(store, None, device="cpu").device.type == "cpu"
