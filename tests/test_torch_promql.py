"""The port's PromQL engine (deepflow_tpu_torch/querier/promql.py) against
the JAX package's, on the CPU.

One `ext_samples` store is written with the JAX package's schema and
dictionaries (seeded counters with resets, gauges, a cumulative `le`
histogram, half-integer gauges); the JAX `PromEngine` and the port's
`PromEngine(device="cpu")` each open it with their own Store and
dictionaries. Both evaluators are numpy float64, so every instant and
range result must be identical, compared as JSON text (floats by their
repr, NaN included). The remote read's snappy request and response bytes
are compared too.
"""

import json

import numpy as np
import pytest

from deepflow_tpu.pipelines.ext_metrics import SAMPLE_TABLE
from deepflow_tpu.querier.promql import PromEngine as JProm
from deepflow_tpu.store import db as jdb
from deepflow_tpu.store import dict_store as jdicts
from deepflow_tpu_torch.querier.promql import PromEngine
from deepflow_tpu_torch.store import db as tdb
from deepflow_tpu_torch.store import dict_store as tdicts

T0, T1, STEP = 1000, 1600, 10
LE = ("0.05", "0.1", "0.25", "0.5", "1", "+Inf")


def _series(rng):
    """(metric, labels string, values on the T0..T1 grid) triples."""
    ts = np.arange(T0, T1 + 1, STEP)
    n = len(ts)
    out = []
    for job in ("api", "web"):
        for inst in ("i1", "i2", "i3"):
            for code in ("200", "500"):
                inc = rng.poisson(20 if code == "200" else 2, n)
                ctr = np.cumsum(inc).astype(np.float64)
                if inst == "i2" and code == "200":
                    ctr[n // 2:] -= ctr[n // 2 - 1]      # a counter reset
                out.append(("http_requests_total",
                            f"code={code},instance={inst},job={job}", ctr))
            mem = 400 + np.cumsum(rng.normal(0, 20, n)).round(1)
            out.append(("mem_bytes", f"instance={inst},job={job}", mem))
        obs = np.cumsum(rng.poisson(30, n))
        frac = np.sort(rng.random((n, len(LE) - 1)), axis=1)
        for i, le in enumerate(LE):
            f = frac[:, i] if i < len(LE) - 1 else np.ones(n)
            out.append(("lat_bucket", f"job={job},le={le}",
                        np.floor(obs * f)))
    out.append(("temp", "room=a", 20.5 + (np.arange(n) % 7) - 3))
    return ts, out


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("prom"))
    ts, series = _series(np.random.default_rng(21))
    store = jdb.Store(root)
    reg = jdicts.TagDictRegistry(root)
    t = store.create_table("ext_metrics", SAMPLE_TABLE)
    md, ld = reg.get("metric_name"), reg.get("label_set")
    cols = {"timestamp": [], "metric": [], "labels": [], "value": []}
    for metric, labels, vs in series:
        cols["timestamp"].append(ts)
        cols["metric"].append(np.full(len(ts), md.encode_one(metric)))
        cols["labels"].append(np.full(len(ts), ld.encode_one(labels)))
        cols["value"].append(vs)
    t.append({k: np.concatenate(v).astype(SAMPLE_TABLE.spec(k).dtype)
              for k, v in cols.items()})
    reg.flush()
    reg.close()
    jreg = jdicts.TagDictRegistry(root)
    treg = tdicts.TagDictRegistry(root)
    yield (JProm(jdb.Store(root), jreg),
           PromEngine(tdb.Store(root), treg, device="cpu"))
    jreg.close()
    treg.close()


R = "http_requests_total"
EXPRESSIONS = [
    R,
    f'{R}{{job="api"}}',
    f'{R}{{job=~"a.*", code!="500"}}',
    f'{R}{{instance!~"i[12]"}}',
    f"rate({R}[1m])",
    f"increase({R}[2m])",
    f"irate({R}[1m])",
    f"{R} offset 30s",
    f"rate({R}[1m] offset 1m)",
    f"sum by (job) (rate({R}[1m]))",
    "sum without (instance) (mem_bytes)",
    "histogram_quantile(0.9, sum by (le) (rate(lat_bucket[1m])))",
    "histogram_quantile(0.5, lat_bucket)",
    'histogram_quantile(0.99, rate(lat_bucket{job="web"}[2m]))',
    "max_over_time(mem_bytes[1m:10s])",
    f"max_over_time(rate({R}[1m])[2m:20s])",
    "avg_over_time(mem_bytes[1m:])",
    "mem_bytes * 2 + 1",
    "mem_bytes % 7 ^ 2",
    f"rate({R}[1m]) / on (job, instance) group_left "
    f"sum by (job, instance) (rate({R}[1m]))",
    f'sum by (job, code) (rate({R}[1m])) / ignoring (code) group_left '
    f'sum by (job) (rate({R}[1m]))',
    "mem_bytes > 400",
    "mem_bytes > bool 400",
    'mem_bytes == bool mem_bytes{instance="i1"}',
    'mem_bytes{job="api"} or mem_bytes{job="web"}',
    'mem_bytes unless mem_bytes{instance="i1"}',
    f'mem_bytes and on (job, instance) {R}{{code="500"}}',
    "topk(2, mem_bytes)",
    "bottomk(1, mem_bytes)",
    "quantile(0.5, mem_bytes)",
    "max by (job) (topk(1, mem_bytes))",
    "count by (job) (mem_bytes)",
    "stddev(mem_bytes)",
    "stdvar without (job) (mem_bytes)",
    "avg_over_time(mem_bytes[1m])",
    "sum_over_time(mem_bytes[1m])",
    "count_over_time(mem_bytes[1m])",
    "min_over_time(mem_bytes[2m])",
    "last_over_time(mem_bytes[1m])",
    "present_over_time(mem_bytes[1m])",
    "stddev_over_time(mem_bytes[1m])",
    "stdvar_over_time(mem_bytes[1m])",
    "quantile_over_time(0.9, mem_bytes[2m])",
    'label_replace(mem_bytes, "host", "$1", "instance", "i(.*)")',
    'label_join(mem_bytes, "ji", "-", "job", "instance")',
    "absent(nope_metric)",
    "absent(mem_bytes)",
    "sort(mem_bytes)",
    "sort_desc(mem_bytes)",
    "round(temp)",
    "clamp_min(temp - 22, -1)",
    "clamp_max(mem_bytes, 420)",
    "sqrt(abs(temp - 20))",
    "ln(mem_bytes) + log2(mem_bytes)",
    "changes(temp[2m])",
    f"resets({R}[5m])",
    "deriv(mem_bytes[2m])",
    "predict_linear(mem_bytes[2m], 60)",
    "delta(temp[1m])",
    "timestamp(mem_bytes)",
    "vector(time())",
    "mem_bytes - scalar(sum(mem_bytes))",
    "vector(1)",
    f"sum(rate({R}[1m])) by (job) > bool 1",
]


def _text(x):
    return json.dumps(x, sort_keys=True)


@pytest.mark.parametrize("expr", EXPRESSIONS,
                         ids=[f"p{i:02d}" for i in range(len(EXPRESSIONS))])
def test_expression_matches_jax(engines, expr):
    j, t = engines
    want = j.query(expr, at=1400)
    assert _text(t.query(expr, at=1400)) == _text(want)
    want_r = j.query_range(expr, start=1100, end=1590, step=35)
    got_r = t.query_range(expr, start=1100, end=1590, step=35)
    assert _text(got_r) == _text(want_r)
    assert want or want_r or expr == "absent(mem_bytes)"


def test_discovery_matches_jax(engines):
    j, t = engines
    assert t.label_names() == j.label_names()
    for name in ("__name__", "job", "instance", "le", "code"):
        assert t.label_values(name) == j.label_values(name)
    for m in ([R], ['mem_bytes{job="web"}', "temp"]):
        assert t.series(m, start=T0, end=T1) == j.series(m, start=T0,
                                                         end=T1)


def test_errors_match_jax(engines):
    j, t = engines
    for bad, args in (("rate(mem_bytes)", {"at": 1400}),
                      ("sum(", {"at": 1400}),
                      (R, {"start": 100, "end": 50, "step": 10})):
        fn = "query" if "at" in args else "query_range"
        with pytest.raises(Exception) as je:
            getattr(j, fn)(bad, **args)
        with pytest.raises(Exception) as te:
            getattr(t, fn)(bad, **args)
        assert type(te.value) is type(je.value)
        assert str(te.value) == str(je.value)


def _read_request(pb, snappy, start_ms, end_ms, matchers):
    req = pb.ReadRequest()
    for lo, hi, ms in ((start_ms, end_ms, matchers),
                       (start_ms + 60_000, end_ms, matchers[:1])):
        q = req.queries.add()
        q.start_timestamp_ms, q.end_timestamp_ms = lo, hi
        for typ, name, value in ms:
            m = q.matchers.add()
            m.type, m.name, m.value = typ, name, value
    return snappy.compress(req.SerializeToString())


def test_remote_read_bytes_match_jax(engines):
    from deepflow_tpu.utils import snappy as jsnappy
    from deepflow_tpu.wire.gen import telemetry_pb2 as jpb
    from deepflow_tpu_torch.utils import snappy as tsnappy
    from deepflow_tpu_torch.wire.gen import telemetry_pb2 as tpb

    j, t = engines
    for matchers in ([(0, "__name__", R), (2, "job", "a.*")],
                     [(0, "__name__", "mem_bytes"), (1, "instance", "i2")],
                     [(2, "__name__", "lat_.*")]):
        jreq = _read_request(jpb, jsnappy, 1_100_000, 1_400_000, matchers)
        treq = _read_request(tpb, tsnappy, 1_100_000, 1_400_000, matchers)
        assert treq == jreq
        want = j.remote_read(jreq)
        assert t.remote_read(treq) == want
        resp = tpb.ReadResponse()
        resp.ParseFromString(tsnappy.decompress(want))
        assert resp.results[0].timeseries
    blob = bytes(np.random.default_rng(5).integers(0, 256, 4096,
                                                   dtype=np.uint8))
    assert tsnappy.compress(blob) == jsnappy.compress(blob)
    assert tsnappy.decompress(jsnappy.compress(blob)) == blob


def test_prom_engine_defaults_to_the_card(tmp_path):
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PromEngine(tdb.Store(str(tmp_path)), tdicts.TagDictRegistry(None))
