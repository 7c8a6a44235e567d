"""The port's ingester entry point (pipelines/ingester.py) against the
JAX package's `Ingester`, on the CPU.

Both ingesters get the same frames over a loopback TCP connection, one
after the other, at `n_decoders=1` with a store and the timeline off:
4,096 l4 records over both wires (TAGGEDFLOW protobuf records and planar
COLUMNAR_FLOW frames), 384 l7 requests (PROTOCOLLOG) and 320 metrics
Documents (METRICS). Each stream is sent after the one before it is
decoded, and both packages' row-id counters restart at 1, so `_id`s are
the same. Windows close with `flush_window(now)` once their rows are in
the exporter. Compared: the l4 and l7 table rows (sorted by `_id`),
every sketch leaf at every window close, the window outputs, the RED
outputs, the metrics 1m tier and the receiver, decoder and registry
counters: integers exactly, float readouts at rtol 1e-5 (RED quantiles
2e-6, as in test_torch_app_red.py). The port runs the same traffic once
more with the operations surface on (the timeline at its default
cadence, the Prometheus and debug listeners, a spill and an incident
directory): its sketch state equals the run with the surface off, and
the surface answers (a strict /metrics scrape, /healthz, debug round
trips). `IngesterConfig()`'s defaults build on the CPU, and so does every
field, `app_red_prom_buckets` included."""

import socket
import time

import jax.numpy as jnp
import numpy as np
import pytest

from deepflow_tpu.batch import schema as jschema
from deepflow_tpu.decode import columnar as jdec
from deepflow_tpu.ops import ddsketch as jdd
from deepflow_tpu.pipelines import flow_log as jflow_log
from deepflow_tpu.pipelines.ingester import Ingester as JIngester
from deepflow_tpu.pipelines.ingester import IngesterConfig as JConfig
from deepflow_tpu.replay.generator import SyntheticAgent
from deepflow_tpu.runtime import faults as jfaults
from deepflow_tpu.store import db as jdb
from deepflow_tpu.wire.gen import flow_log_pb2
from deepflow_tpu_torch.models import app_suite as tas
from deepflow_tpu_torch.pipelines import Ingester, IngesterConfig
from deepflow_tpu_torch.pipelines import flow_log as tflow_log
from deepflow_tpu_torch.runtime import faults as tfaults
from deepflow_tpu_torch.wire import (FlowHeader, MessageType, encode_frame,
                                     pack_pb_records)
from deepflow_tpu_torch.wire.columnar_wire import encode_columnar

F32_TOL = dict(rtol=1e-5, atol=1e-6)
Q_RTOL = 2e-6
L4_TAGGED, L4_COLUMNAR, L7_N, DOCS = 2048, 2048, 384, 320
NOWS = (1000.0, 1001.0)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    jfaults.default_faults().disarm()
    tfaults.default_faults().disarm()


def _rrt_off_boundaries(v):
    """rrt values on which the JAX package's float32 DDSketch bucket
    equals the exact float64 one (the port's; see
    test_torch_app_red.py), nudged up by one until they do."""
    from deepflow_tpu.models.app_suite import AppSuiteConfig
    cfg = AppSuiteConfig().dd
    for _ in range(8):
        jb = np.asarray(jdd.bucket_index(jnp.asarray(v), cfg))
        w = np.maximum(v.astype(np.float32), np.float32(1)).astype(
            np.float64)
        exact = np.clip(np.ceil(np.log(w) / np.log(jdd.gamma(cfg))), 0,
                        cfg.buckets - 1)
        bad = jb != exact
        if not bad.any():
            return v
        v = np.where(bad, v + 1, v).astype(np.uint32)
    raise AssertionError("boundary values remain")


def _l7_records(rng, n):
    pool_ip = (0xAC100000 + rng.permutation(512)[:40]).astype(np.uint32)
    pick = (rng.zipf(1.1, n) - 1).clip(max=39)
    rrt = _rrt_off_boundaries(np.round(rng.lognormal(
        np.log(2000), 1.2, n)).astype(np.uint32))
    status = rng.choice(np.array([0, 200, 200, 404, 500, 3], np.uint32), n)
    out = []
    for i in range(n):
        m = flow_log_pb2.AppProtoLogsData()
        b = m.base
        b.start_time = 1_700_000_000_000_000_000 + i * 1_000_000
        b.ip_src = int(0x0A000000 + rng.integers(0, 1 << 16))
        b.ip_dst = int(pool_ip[pick[i]])
        b.port_dst = int(80 + pick[i] % 3)
        b.protocol = 6 if pick[i] % 5 else 17
        b.head.proto = 20
        b.head.rrt = int(rrt[i]) * 1000
        b.l3_epc_id_src = 1
        m.req.endpoint = f"/api/{pick[i] % 9}"
        m.resp.status = int(status[i])
        out.append(m.SerializeToString())
    return out


def _traffic(seed=41):
    """(frames per stage, records per stage): the l4 windows, l7, docs.
    Window 0 is all of the TAGGEDFLOW frames and half of the columnar
    rows, window 1 the other half."""
    rng = np.random.default_rng(seed)
    agent = SyntheticAgent(seed=seed, vtap_id=5)
    n = L4_TAGGED + L4_COLUMNAR
    cols = agent.l4_columns_pooled(n, pool=512)
    recs = [agent.l4_record(cols, i) for i in range(n)]
    tagged = list(agent.frames(recs[:L4_TAGGED], MessageType.TAGGEDFLOW,
                               per_frame=128))
    # the columnar rows are the same records' full L4_SCHEMA columns
    wide = jdec.decode_l4_records(recs[L4_TAGGED:])
    for name, dt in jschema.L4_SCHEMA.columns:
        if not wide[name].any() and name != "_id":
            wide[name] = rng.integers(0, 1 << 16, L4_COLUMNAR).astype(dt)
    seq = [len(tagged)]

    def columnar(lo, hi, per=300):
        out = []
        for s in range(lo, hi, per):
            seq[0] += 1
            out.append(encode_frame(
                MessageType.COLUMNAR_FLOW,
                encode_columnar({k: v[s:min(hi, s + per)]
                                 for k, v in wide.items()}),
                FlowHeader(sequence=seq[0], vtap_id=5)))
        return out

    half = L4_COLUMNAR // 2
    l7 = _l7_records(rng, L7_N)
    docs = [agent.metric_record(
        DOC_T0 + i % 180, i, {"packet_tx": int(rng.integers(1, 1 << 20)),
                              "byte_tx": int(rng.integers(0, 1 << 30))})
        for i in range(DOCS)]
    fr7 = [encode_frame(MessageType.PROTOCOLLOG,
                        pack_pb_records(l7[s:s + 100]),
                        FlowHeader(sequence=s + 1, vtap_id=5))
           for s in range(0, L7_N, 100)]
    frm = [encode_frame(MessageType.METRICS,
                        pack_pb_records(docs[s:s + 64]),
                        FlowHeader(sequence=s + 1, vtap_id=5))
           for s in range(0, DOCS, 64)]
    return [tagged + columnar(0, half), columnar(half, L4_COLUMNAR),
            fr7, frm], [L4_TAGGED + half, L4_COLUMNAR - half, L7_N, DOCS]


# metrics timestamps: an hour boundary ahead of the wall clock, so the
# pipelines' tickers build no minute before its rows land
DOC_T0 = (int(time.time()) // 3600 + 2) * 3600


def _cfg(mod, root, **kw):
    return mod(**{**dict(listen_port=0, store_path=root, n_decoders=1,
                         tpu_sketch_window_s=3600, app_red_window_s=3600,
                         timeline_sample_s=0), **kw})


def _wait(fn, what, timeout=60):
    deadline = time.monotonic() + timeout
    while not fn():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _drive(ing, frames, counts, decoders):
    """Send each stage frame by frame, each once the one before it is
    decoded (so every chunk is one frame, in both ingesters), wait until
    the stage is in its exporter; close the sketch windows after stages
    0 and 1, the RED window after stage 2. Returns (sketch snapshots,
    sketch outputs, RED output)."""
    snaps = []
    ing.tpu_sketch.snapshot_bus.subscribe(
        lambda s: snaps.append([np.asarray(a) for a in s.leaves]))
    l4, l7 = decoders
    outs = []
    s = socket.create_connection(("127.0.0.1", ing.port))
    try:
        sent4 = 0
        for stage, (fs, n) in enumerate(zip(frames, counts)):
            for f in fs:
                before = ing.receiver.rx_frames, l4.frames + l7.frames, \
                    ing.flow_metrics.records
                s.sendall(f)
                _wait(lambda: ing.receiver.rx_frames > before[0]
                      and (l4.frames + l7.frames > before[1]
                           or ing.flow_metrics.records > before[2]),
                      "one frame decoded")
            if stage < 2:
                sent4 += n
                _wait(lambda: l4.records == sent4, "l4 decode")
                _wait(lambda: ing.tpu_sketch.rows_in == sent4, "l4 export")
                outs.append(ing.tpu_sketch.flush_window(now=NOWS[stage]))
            elif stage == 2:
                _wait(lambda: l7.records == n, "l7 decode")
                _wait(lambda: ing.app_red.rows_in == n, "l7 export")
                red = ing.app_red.flush_window(now=2000.0)
            else:
                _wait(lambda: ing.flow_metrics.records == n, "metrics")
    finally:
        s.close()
    ing.flush()
    ing.flow_metrics.rollups.advance(DOC_T0 + 600)
    return snaps, outs, red


def _counters(ing, decoders):
    rc = ing.receiver.counters()
    return {"receiver": rc, "decoders": [d.counters() for d in decoders],
            "exporters": ing.exporters.counters(),
            "breakers": ing.exporters.breakers(),
            "flow_metrics": {"records": ing.flow_metrics.records,
                             "decode_errors": ing.flow_metrics.decode_errors}}


def _run_jax(root, frames, counts):
    jflow_log._ID_NEXT[0] = 1
    ing = JIngester(_cfg(JConfig, root))
    ing.start()
    try:
        decs = [d for d in ing.flow_log.decoders
                if d.stream in ("l4_flow_log", "l7_flow_log")]
        res = _drive(ing, frames, counts, decs)
        return res + (_counters(ing, decs),)
    finally:
        ing.close()


def _run_port(root, frames, counts, probe=None, **kw):
    tflow_log._ID_NEXT[0] = 1
    ing = Ingester(_cfg(IngesterConfig, root, **kw), device="cpu")
    ing.start()
    try:
        decs = [d for d in ing.flow_log.decoders
                if d.stream in ("l4_flow_log", "l7_flow_log")]
        res = _drive(ing, frames, counts, decs)
        out = res + (_counters(ing, decs),)
        if probe is not None:
            out += (probe(ing),)
        return out
    finally:
        ing.close()


def _probe_surface(ing):
    """The operations surface of a running ingester: a strict /metrics
    scrape, /healthz, debug round trips, the timeline's own counters."""
    import json
    import urllib.request
    from deepflow_tpu_torch.runtime.debug import debug_request
    from deepflow_tpu_torch.runtime.promexpo import validate_exposition
    _wait(lambda: ing.timeline.ticks >= 2, "two timeline ticks")
    base = f"http://127.0.0.1:{ing.prom_port}"
    with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
        body = r.read().decode()
    with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
        health = json.loads(r.read())
    replies = {cmd: debug_request(cmd, port=ing.debug.port)
               for cmd in ("ping", "counters", "queues", "breakers",
                           "spill", "lint")}
    return {"problems": validate_exposition(body), "body": body,
            "health": health, "replies": replies,
            "timeline": ing.timeline.counters(),
            "series": ing.timeline.metric_names()}


def _scan(root, db, table):
    t = jdb.Store(root).table(db, table)
    return t.scan()


@pytest.fixture(scope="module")
def runs_surface(tmp_path_factory):
    """The port's run of `runs` with the operations surface on: the
    timeline at its default cadence, the listeners, a spill and an
    incident directory."""
    frames, counts = _traffic()
    root = tmp_path_factory.mktemp("surface")
    troot = str(root / "store")
    return _run_port(troot, frames, counts, probe=_probe_surface,
                     timeline_sample_s=IngesterConfig().timeline_sample_s,
                     prom_port=0, debug_port=0,
                     spill_dir=str(root / "spill"),
                     incident_dir=str(root / "incidents"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    frames, counts = _traffic()
    jroot = str(tmp_path_factory.mktemp("jax"))
    troot = str(tmp_path_factory.mktemp("port"))
    return {"jax": _run_jax(jroot, frames, counts) + (jroot,),
            "port": _run_port(troot, frames, counts) + (troot,),
            "counts": counts}


def test_sketch_leaves_and_outputs_equal(runs):
    (ts, to, _, _, _), (js, jo, _, _, _) = runs["port"], runs["jax"]
    # the two window closes, then the drain ladder's final checkpoint
    assert len(ts) == len(js) == 3
    for a, b in zip(ts, js):
        assert len(a) == len(b) == 9
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    for t, j in zip(to, jo):
        np.testing.assert_array_equal(t.topk_keys.numpy().view(np.uint32),
                                      np.asarray(j.topk_keys))
        np.testing.assert_array_equal(t.topk_counts.numpy(),
                                      np.asarray(j.topk_counts))
        assert int(t.rows) == int(np.asarray(j.rows))
        np.testing.assert_allclose(t.service_cardinality.numpy(),
                                   np.asarray(j.service_cardinality),
                                   **F32_TOL)
        np.testing.assert_allclose(t.entropies.numpy(),
                                   np.asarray(j.entropies), **F32_TOL)
    assert [int(t.rows) for t in to] == runs["counts"][:2]


def test_red_outputs_equal(runs):
    t, j = runs["port"][2], runs["jax"][2]
    for name in tas.AppWindowOutput._fields:
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name == "rrt_quantiles":
            np.testing.assert_allclose(a, b, rtol=Q_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert float(t.requests.sum()) == L7_N


@pytest.mark.parametrize("table", ["l4_flow_log", "l7_flow_log"])
def test_flow_log_rows_equal(runs, table):
    t = _scan(runs["port"][4], "flow_log", table)
    j = _scan(runs["jax"][4], "flow_log", table)
    n = sum(runs["counts"][:2]) if table == "l4_flow_log" else L7_N
    assert len(t["_id"]) == len(j["_id"]) == n
    assert len(np.unique(t["_id"])) == n
    ot, oj = np.argsort(t["_id"]), np.argsort(j["_id"])
    assert set(t) == set(j)
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k][ot], j[k][oj], err_msg=k)


def test_metrics_tiers_equal(runs):
    for table in ("vtap_flow_port", "vtap_flow_port.1m"):
        t = _scan(runs["port"][4], "flow_metrics", table)
        j = _scan(runs["jax"][4], "flow_metrics", table)
        assert set(t) == set(j) and len(j["timestamp"]) > 0
        keys = [k for k in sorted(j) if j[k].dtype.kind in "ui"]
        ot, oj = np.lexsort([t[k] for k in keys]), \
            np.lexsort([j[k] for k in keys])
        for k in j:
            np.testing.assert_array_equal(t[k][ot], j[k][oj], err_msg=k)
    assert len(_scan(runs["port"][4], "flow_metrics",
                     "vtap_flow_port")["timestamp"]) == DOCS


def test_counters_equal(runs):
    t, j = runs["port"][3], runs["jax"][3]
    assert t == j
    rc = t["receiver"]
    assert rc["no_handler"] == rc["rx_duplicate"] == rc["rx_errors"] == 0
    assert sum(d["records"] for d in t["decoders"]) == \
        sum(runs["counts"][:3])
    assert t["exporters"]["put_errors"] == t["exporters"]["shed"] == 0


@pytest.mark.parametrize("field,value", [
    ("spill_dir", "/nonexistent"), ("prom_port", 0), ("debug_port", 0),
    ("incident_dir", "/nonexistent"), ("timeline_sample_s", 1.0),
    ("app_red_prom_buckets", 4)])
def test_unported_settings_raise(field, value, tmp_path):
    """Every setting builds its subsystem (paths under tmp_path); the
    RED exporter's le buckets build its bucket writer over the store's
    ext_samples table with the reference's retained boundaries."""
    import deepflow_tpu_torch.pipelines.ingester as ting
    assert not hasattr(ting, "UNPORTED")
    if isinstance(value, str):
        value = str(tmp_path) + value
    kw = {"timeline_sample_s": 0, "listen_port": 0, field: value}
    if field == "app_red_prom_buckets":
        kw.update(store_path=str(tmp_path / "store"), app_red_window_s=1.0)
    ing = Ingester(IngesterConfig(**kw), device="cpu")
    try:
        built = {"spill_dir": ing.spill, "prom_port": ing.prom,
                 "debug_port": ing.debug, "incident_dir": ing.incidents,
                 "timeline_sample_s": ing.timeline,
                 "app_red_prom_buckets": getattr(
                     ing.app_red, "bucket_writer", None)}[field]
        assert built is not None or field == "incident_dir"
        if field == "app_red_prom_buckets":
            assert built.table.schema.name == "ext_samples"
            assert list(ing.app_red._bucket_idx[:2]) == [value - 1,
                                                         2 * value - 1]
            assert ing.app_red._bucket_les[-1] == "+Inf"
        if field == "incident_dir":
            # the recorder rides the timeline, off in this config
            assert ing.timeline is None and ing.incidents is None
    finally:
        ing.close()


def test_default_config_raises_and_cuda_needs_a_card():
    """`IngesterConfig()`'s defaults build on the CPU (the timeline on at
    1.0 s, no store: no incident recorder); "cuda" without a card
    raises."""
    import torch
    ing = Ingester(IngesterConfig(), device="cpu")
    try:
        assert ing.timeline is not None and ing.timeline.sample_s == 1.0
        assert ing.incidents is None and ing.prom is None
        assert ing.health()["slo_burning"] == []
    finally:
        ing.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Ingester(IngesterConfig())


def test_sketch_state_equal_with_operations_surface_on_and_off(
        runs, runs_surface):
    """Every sketch leaf at every window close, the window outputs and
    the RED output are the same with the operations surface on."""
    on, off = runs_surface, runs["port"]
    assert len(on[0]) == len(off[0])
    for a, b in zip(on[0], off[0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(on[1] + [on[2]], off[1] + [off[2]]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert on[3]["receiver"] == off[3]["receiver"]
    assert on[3]["exporters"] == off[3]["exporters"]


def test_operations_surface_live(runs, runs_surface):
    probe = runs_surface[4]
    assert probe["problems"] == []
    assert "deepflow_slo_burn_rate" in probe["body"]
    assert "deepflow_timeline_ticks" in probe["body"]
    assert probe["health"]["ok"] and probe["health"]["slo_burning"] == []
    r = probe["replies"]
    assert r["ping"] == {"ok": True, "data": "pong"}
    assert r["counters"]["data"]["exporter.tpu_sketch"]["rows_in"] == \
        sum(runs["counts"][:2])
    assert "ingest.l4_flow_log" in r["queues"]["data"]
    assert set(r["breakers"]["data"]) == {"tpu_sketch", "app_red"}
    assert r["spill"]["data"]["enabled"] is True
    assert r["lint"]["ok"] is False
    assert probe["timeline"]["ticks"] >= 2
    assert probe["timeline"]["rule_errors"] == 0
    assert {"tpu_sketch_rows_in", "receiver_rx_frames",
            "slo_burn_rate", "ingest_frames_per_s"} <= set(probe["series"])


def test_close_drains_pending_feed_groups(tmp_path):
    """Frames sent and close() called at once: the drain ladder lets the
    decoder, the exporter queue and the feed's groups in flight finish,
    so every row reaches the sketch (the exporter's close flushes the
    last window); a message type neither package claims (COMPRESS, 0)
    counts as no_handler in both."""
    frames, counts = _traffic(seed=43)
    ing = Ingester(_cfg(IngesterConfig, str(tmp_path),
                        coalesce_batches=2, drain_deadline_s=20.0),
                   device="cpu")
    snaps = []
    ing.tpu_sketch.snapshot_bus.subscribe(
        lambda s: snaps.append([np.asarray(a) for a in s.leaves]))
    ing.start()
    s = socket.create_connection(("127.0.0.1", ing.port))
    try:
        for f in frames[0] + frames[1]:
            s.sendall(f)
        s.sendall(encode_frame(MessageType.COMPRESS, b"x",
                               FlowHeader(sequence=1, vtap_id=9)))
        _wait(lambda: ing.receiver.rx_frames == len(frames[0])
              + len(frames[1]) + 1, "receive")
    finally:
        s.close()
    ing.close()
    assert ing.health()["drain"] == "drained"
    assert ing.exporters.pending() == 0
    assert ing.tpu_sketch.rows_in == sum(counts[:2])
    assert sum(int(x[7]) for x in snaps) == sum(counts[:2])
    assert ing.receiver.counters()["no_handler"] == 1
    jing = JIngester(_cfg(JConfig, str(tmp_path / "jax"),
                          tpu_sketch_window_s=None, app_red_window_s=None))
    jing.start()
    s = socket.create_connection(("127.0.0.1", jing.port))
    try:
        s.sendall(encode_frame(MessageType.COMPRESS, b"x",
                               FlowHeader(sequence=1, vtap_id=9)))
        _wait(lambda: jing.receiver.rx_frames == 1, "receive")
    finally:
        s.close()
        jing.close()
    assert jing.receiver.counters()["no_handler"] == 1
