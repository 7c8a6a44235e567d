"""The port's OTel path against the JAX package's, on the CPU:
`decode/columnar.decode_otel_frames` (raw and zlib-compressed),
`runtime/otlp_exporter` (`l7_chunk_to_otlp`, `OtlpExporter`'s request
bodies byte for byte at a loopback HTTP sink), and both packages'
`Ingester` on the same OTel and PROTOCOLLOG frames: the l7_flow_log rows
equal (row ids included), the RED exporter fed only the PROTOCOLLOG rows
(the OTel stream is `l7_flow_log.otel`), and the l7 table's aggregate
throttle cap the reference's. Spans, ids, attributes and durations are
made from a seed with numpy."""

import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from deepflow_tpu.decode import columnar as jdec
from deepflow_tpu.runtime import otlp_exporter as jotlp
from deepflow_tpu.store import dict_store as jdicts
from deepflow_tpu.wire.codec import iter_pb_records
from deepflow_tpu.wire.gen import flow_log_pb2
from deepflow_tpu_torch.decode import columnar as tdec
from deepflow_tpu_torch.runtime import otlp_exporter as totlp
from deepflow_tpu_torch.store import dict_store as tdicts
from deepflow_tpu_torch.wire import (FlowHeader, MessageType, encode_frame,
                                     pack_pb_records)
from deepflow_tpu_torch.wire.framing import FrameReader
from deepflow_tpu_torch.wire.gen import otel_pb2

import torch_pair as tp

T0_NS = 1_700_000_000_000_000_000
NAMES = ["GET /api/users", "POST /api/orders", "UserService/Get",
         "db.query", "cache.get", ""]


def otel_request(rng, n_spans):
    """One ExportTraceServiceRequest of seeded spans over two resources:
    http and grpc attributes, peer ports, status codes (a negative one
    among them), random ids, an empty parent id now and then."""
    req = otel_pb2.ExportTraceServiceRequest()
    for r in range(2):
        rs = req.resource_spans.add()
        kv = rs.resource.attributes.add()
        kv.key = "service.name"
        kv.value.string_value = f"svc-{int(rng.integers(0, 4))}"
        ss = rs.scope_spans.add()
        for _ in range(n_spans // 2):
            s = ss.spans.add()
            s.name = NAMES[int(rng.integers(0, len(NAMES)))]
            s.trace_id = rng.bytes(16)
            s.span_id = rng.bytes(8)
            if rng.random() < 0.7:
                s.parent_span_id = rng.bytes(8)
            s.kind = int(rng.integers(0, 6))
            start = T0_NS + int(rng.integers(0, 4_000_000_000))
            s.start_time_unix_nano = start
            s.end_time_unix_nano = start + int(rng.lognormal(15, 1.5))
            s.status.code = int(rng.integers(0, 3))
            pick = int(rng.integers(0, 3))
            if pick == 0:
                a = s.attributes.add()
                a.key = "http.method"
                a.value.string_value = "GET"
                a = s.attributes.add()
                a.key = "http.status_code"
                a.value.int_value = int(rng.choice([200, 404, 500, -1]))
            elif pick == 1:
                a = s.attributes.add()
                a.key = "rpc.system"
                a.value.string_value = "grpc"
            if rng.random() < 0.5:
                a = s.attributes.add()
                a.key = "net.peer.port"
                a.value.int_value = int(rng.integers(0, 1 << 17))
    return req


def otel_frames(rng, n_req, seq0=1, spans=32):
    """(raw frames, zlib-compressed frames, spans): n_req requests of each
    flavour, plus one undecodable payload of each."""
    raw, comp, n = [], [], 0
    for i in range(n_req):
        body = otel_request(rng, spans).SerializeToString()
        raw.append(encode_frame(MessageType.OPENTELEMETRY, body,
                                FlowHeader(sequence=seq0 + i, vtap_id=7)))
        body = otel_request(rng, spans).SerializeToString()
        comp.append(encode_frame(MessageType.OPENTELEMETRY_COMPRESSED,
                                 zlib.compress(body),
                                 FlowHeader(sequence=seq0 + i, vtap_id=7)))
        n += 2 * spans
    raw.append(encode_frame(MessageType.OPENTELEMETRY, b"\xff" * 40,
                            FlowHeader(sequence=seq0 + n_req, vtap_id=7)))
    comp.append(encode_frame(MessageType.OPENTELEMETRY_COMPRESSED,
                             b"not zlib",
                             FlowHeader(sequence=seq0 + n_req, vtap_id=7)))
    return raw, comp, n


def l7_frames(rng, n, seq0=1, per=50):
    """PROTOCOLLOG frames of n seeded l7 requests."""
    recs = []
    for i in range(n):
        m = flow_log_pb2.AppProtoLogsData()
        b = m.base
        b.start_time = T0_NS + i * 1_000_000
        b.ip_src = int(0x0A000000 + rng.integers(0, 1 << 16))
        b.ip_dst = int(0xAC100000 + rng.integers(0, 32))
        b.port_dst = int(80 + i % 3)
        b.protocol = 6
        b.head.proto = 20
        # rrt off DDSketch bucket boundaries (integers in [2000, 2030])
        b.head.rrt = int(2000 + i % 31) * 1000
        m.req.endpoint = f"/api/{i % 9}"
        m.resp.status = int(rng.choice([0, 200, 404, 500]))
        recs.append(m.SerializeToString())
    return [encode_frame(MessageType.PROTOCOLLOG,
                         pack_pb_records(recs[s:s + per]),
                         FlowHeader(sequence=seq0 + s, vtap_id=7))
            for s in range(0, n, per)]


def _payloads(frames):
    reader = FrameReader()
    return [x.payload for f in frames for x in reader.feed(f)]


@pytest.mark.parametrize("compressed", [False, True],
                         ids=["raw", "compressed"])
def test_decode_otel_frames_matches_jax(compressed, tmp_path):
    """The same payloads (one undecodable) decode to the same columns
    and bad count, and both endpoint dictionaries record the same
    strings."""
    rng = np.random.default_rng(81)
    raw, comp, n = otel_frames(rng, 3)
    payloads = _payloads(comp if compressed else raw)
    jreg = jdicts.TagDictRegistry(str(tmp_path / "jax"))
    treg = tdicts.TagDictRegistry(str(tmp_path / "port"))
    jc, jbad = jdec.decode_otel_frames(
        payloads, compressed=compressed, vtap_id=7,
        endpoint_dict=jreg.get("l7_endpoint"))
    tc, tbad = tdec.decode_otel_frames(
        payloads, compressed=compressed, vtap_id=7,
        endpoint_dict=treg.get("l7_endpoint"))
    assert tbad == jbad == 1
    assert set(tc) == set(jc) and len(jc["timestamp"]) == n // 2
    for k in jc:
        assert tc[k].dtype == jc[k].dtype, k
        np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)
    assert (tc["signal_source"] == tdec.SIGNAL_SOURCE_OTEL).all()
    assert set(tc["l7_protocol"].tolist()) == {
        tdec.L7_PROTO_HTTP1, tdec.L7_PROTO_GRPC, tdec.L7_PROTO_UNKNOWN}
    for reg in (jreg, treg):
        reg.flush()
        reg.close()
    assert tp.dict_lines(str(tmp_path / "port")) == \
        tp.dict_lines(str(tmp_path / "jax"))
    empty_t, bad_t = tdec.decode_otel_frames([])
    empty_j, bad_j = jdec.decode_otel_frames([])
    assert bad_t == bad_j == 0
    assert {k: v.dtype for k, v in empty_t.items()} == \
        {k: v.dtype for k, v in empty_j.items()}


class _Sink(BaseHTTPRequestHandler):
    received = []

    def log_message(self, *a):
        pass

    def do_POST(self):
        length = int(self.headers["Content-Length"])
        _Sink.received.append((self.path, self.headers["Content-Type"],
                               self.rfile.read(length)))
        self.send_response(200)
        self.end_headers()


def test_otlp_exporter_bodies_match_jax(tmp_path):
    """l7 chunks (decoded OTel spans and PROTOCOLLOG rows, endpoint names
    known to the dictionary or not) through both exporters' process():
    the request bodies reaching a loopback HTTP sink are byte for byte
    the same, and `l7_chunk_to_otlp` agrees; both refuse the
    `l7_flow_log.otel` stream."""
    rng = np.random.default_rng(82)
    regs = {"jax": jdicts.TagDictRegistry(None),
            "port": tdicts.TagDictRegistry(None)}
    raw, _, _ = otel_frames(rng, 2)
    chunks = []
    for reg, dec in ((regs["jax"], jdec), (regs["port"], tdec)):
        cols, _ = dec.decode_otel_frames(
            _payloads(raw), endpoint_dict=reg.get("l7_endpoint"))
        chunks.append([{k: v[s:s + 20] for k, v in cols.items()}
                       for s in range(0, len(cols["timestamp"]), 20)])
    l7 = jdec.decode_l7_records(
        [r for f in _payloads(l7_frames(rng, 60)) for r in
         iter_pb_records(f)])
    for c in chunks:
        c.append(l7)
    bodies = {}
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Sink)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        for (name, mod), cs in zip((("jax", jotlp), ("port", totlp)),
                                   chunks):
            _Sink.received = []
            exp = mod.OtlpExporter(url, tag_dicts=regs[name])
            assert exp.is_export_data("l7_flow_log", cs[0])
            assert not exp.is_export_data("l7_flow_log.otel", cs[0])
            exp.process([("l7_flow_log", 0, c, -1) for c in cs])
            bodies[name] = (list(_Sink.received), exp.counters())
            assert [mod.l7_chunk_to_otlp(
                c, regs[name].get("l7_endpoint")).SerializeToString()
                for c in cs] == [b for _, _, b in _Sink.received]
            exp.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert bodies["port"][0] == bodies["jax"][0]
    assert len(bodies["port"][0]) == len(chunks[0])
    assert all(p == "/v1/traces" and t == "application/x-protobuf"
               for p, t, _ in bodies["port"][0])
    assert bodies["port"][1]["spans_sent"] == bodies["jax"][1]["spans_sent"]
    assert bodies["port"][1]["send_errors"] == 0
    spans = otel_pb2.ExportTraceServiceRequest()
    spans.ParseFromString(bodies["port"][0][0][2])
    assert any(not s.name.startswith("endpoint-")
               for s in spans.resource_spans[0].scope_spans[0].spans)


@pytest.fixture(scope="module")
def ingest_runs(tmp_path_factory):
    """Both ingesters (a store, the RED exporter on): PROTOCOLLOG frames,
    then raw and compressed OTel frames (one undecodable of each)."""
    rng = np.random.default_rng(83)
    l7 = l7_frames(rng, 300)
    raw, comp, n = otel_frames(rng, 3)
    stages = [
        (l7, lambda ing: ing.app_red.rows_in == 300
         and tp.offered(ing, "l7_flow_log") == 300),
        (raw + comp,
         lambda ing: tp.offered(ing, "l7_flow_log.otel") == n
         and tp.decoder(ing, "l7_flow_log.otel").decode_errors == 2),
    ]
    out = {}
    root = tmp_path_factory.mktemp("otel")
    for package in ("jax", "port"):
        def probe(ing):
            # the RED window at a pinned time (close() would flush it at
            # the wall clock)
            ing.app_red.flush_window(now=5000.0)
            d = tp.decoder(ing, "l7_flow_log.otel")
            return {"otel": d.counters(), "red_rows": ing.app_red.rows_in,
                    "exporters": ing.exporters.counters()}
        rc, got, _ = tp.run(package, str(root / package), stages,
                            probe=probe, app_red_window_s=3600)
        out[package] = (tp.tables(str(root / package)), rc, got,
                        tp.dict_lines(str(root / package)))
    out["n"] = n
    return out


def test_ingester_l7_rows_match_jax(ingest_runs):
    """The l7_flow_log rows (PROTOCOLLOG and OTel, row ids and
    KnowledgeGraph stamps included) and every other table equal."""
    t, j = ingest_runs["port"], ingest_runs["jax"]
    l7 = j[0][("flow_log", "l7_flow_log")]
    assert len(l7["_id"]) == 300 + ingest_runs["n"]
    assert len(np.unique(l7["_id"])) == len(l7["_id"])
    tp.assert_tables_equal(t[0], j[0])
    assert t[3] == j[3]


def test_ingester_otel_counters_and_red_filter_match_jax(ingest_runs):
    """The OTel decoder's counters (2 undecodable frames), the receiver's
    and the registry's loss counters equal; the RED exporter saw only
    the PROTOCOLLOG rows (the OTel stream is filtered, counted
    `filtered`)."""
    t, j = ingest_runs["port"], ingest_runs["jax"]
    assert t[1] == j[1] and t[1]["no_handler"] == 0
    assert t[2]["otel"] == j[2]["otel"] == {
        "frames": 8, "records": ingest_runs["n"], "decode_errors": 2}
    assert t[2]["red_rows"] == j[2]["red_rows"] == 300
    # how many chunks the decoders cut depends on the frames' arrival,
    # so `put` and `filtered` count chunks that differ run to run
    for c in (t[2]["exporters"], j[2]["exporters"]):
        assert c["filtered"] > 0
    chunkless = lambda c: {k: v for k, v in c.items()
                           if k not in ("put", "filtered")}
    assert chunkless(t[2]["exporters"]) == chunkless(j[2]["exporters"])


@pytest.mark.parametrize("n_decoders", [1, 2, 3])
def test_l7_throttle_aggregate_cap_matches_jax(n_decoders, tmp_path):
    """Every consumer of the l7 table (n PROTOCOLLOG decoders and the
    OTel decoder) gets the reference's slice, so the table's aggregate
    cap is the reference's: n_decoders + 1 slices of throttle_per_s //
    (n_decoders + 1), each with the same reservoir seed."""
    caps = {}
    for package in ("jax", "port"):
        ing = tp.build(package, str(tmp_path / package),
                       n_decoders=n_decoders, throttle_per_s=10_007)
        try:
            l7 = next(w for w in ing.flow_log.writers
                      if w.table.schema.name == "l7_flow_log")
            # (stream, index, per-second budget, reservoir capacity,
            # reservoir seed state)
            caps[package] = sorted(
                (d.stream, d.index,
                 d.throttler.capacity // d.throttler.bucket_s,
                 d.throttler.capacity,
                 str(d.throttler._rng.bit_generator.state))
                for d in ing.flow_log.decoders if d.writer is l7)
        finally:
            ing.close()
    assert caps["port"] == caps["jax"]
    assert len(caps["port"]) == n_decoders + 1
    assert sum(c for _, _, c, _, _ in caps["port"]) == \
        (n_decoders + 1) * (10_007 // (n_decoders + 1))
