"""The port's integration collector (`deepflow_tpu_torch/agent/
integration.py`) against the JAX package's, on the CPU.

Both packages' `IntegrationCollector`s take the same uploads over HTTP
-- Prometheus remote-write (snappy, as the protocol mandates, gzip and
bare), Telegraf lines, OTLP traces and profile records, with gzip,
snappy and plain bodies, and uploads that must fail (a bad body, an
unknown path) -- and forward them to a loopback receiver each: the
frames of every message type must be equal, byte for byte, and so must
the answers and counters. The JAX package's own collector tests then run
against the port (`torch_ctl_pair.adopt_reference_tests`; their
ingester is the JAX package's).
"""

import gzip
import urllib.error
import urllib.request

import numpy as np

import chip_smoke
import torch_ctl_pair as cp

from deepflow_tpu.agent import integration as jint
from deepflow_tpu_torch.agent import integration as tint
from deepflow_tpu_torch.utils import snappy
from deepflow_tpu_torch.wire.gen import telemetry_pb2


def _uploads(rng):
    """(path, body, Content-Encoding[, sent as is]) in sending
    order."""
    out = []
    for enc in ("snappy", "gzip", ""):
        wr = telemetry_pb2.WriteRequest()
        for i in range(int(rng.integers(1, 6))):
            ts = wr.timeseries.add()
            ts.labels.add(name="__name__", value=f"m_{i}")
            ts.labels.add(name="job", value=f"j{int(rng.integers(9))}")
            ts.samples.add(value=float(rng.normal()),
                           timestamp=int(rng.integers(1, 2**40)))
        out.append(("/api/v1/prometheus", wr.SerializeToString(), enc))
    lines = "".join(f"cpu,host=h{i} usage={rng.uniform(0, 100):.3f} "
                    f"{1_700_000_000_000_000_000 + i}\n" for i in range(5))
    out += [("/api/v1/telegraf", lines.encode(), "gzip"),
            ("/api/v1/telegraf", lines.encode(), "")]
    for enc, p in zip(("gzip", "snappy", ""),
                      chip_smoke.otel_payloads(rng, 3, 4, 1_700_000_000)):
        out.append(("/v1/traces", p, enc))
    for enc in ("snappy", ""):
        prof = telemetry_pb2.Profile(
            timestamp=int(rng.integers(1, 2**62)), app_service="svc",
            event_type="on-cpu", stack="a;b;c",
            value=int(rng.integers(1, 100)))
        out.append(("/api/v1/profile/ingest", prof.SerializeToString(), enc))
    # a body that is not the gzip it claims, and an unknown path
    out += [("/api/v1/prometheus", b"not gzip", "gzip", True),
            ("/api/v1/other", b"x", "")]
    return out


def _post(port, path, body, enc, as_is=False):
    data = body if as_is else gzip.compress(body) if enc == "gzip" else \
        snappy.compress(body) if enc == "snappy" else body
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Encoding": enc} if enc else {})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _run(mod, uploads):
    sink = chip_smoke.LoopbackSink()
    coll = mod.IntegrationCollector(f"127.0.0.1:{sink.port}", vtap_id=9,
                                    port=0)
    coll.start()
    try:
        answers = [_post(coll.port, *u) for u in uploads]
        counters = (coll.requests, coll.errors)
    finally:
        coll._thread.stop()
        coll._httpd.shutdown()
        coll._httpd.server_close()
        coll._thread.join(timeout=2)
    streams = sink.drain(coll.senders)
    sink.close()
    return answers, counters, streams


def test_collectors_forward_equal_frames():
    uploads = _uploads(np.random.default_rng(0xA1))
    j, t = (_run(mod, uploads) for mod in (jint, tint))
    assert t == j
    answers, counters, streams = j
    assert answers == [204] * (len(uploads) - 2) + [400, 400]
    assert counters == (len(uploads), 1)
    assert len(streams) == 4 and all(streams.values())


# -- the JAX package's collector tests, on the port ---------------------------
cp.adopt_reference_tests(globals(), cp.TESTS / "test_integration_collector.py")
