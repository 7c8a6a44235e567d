"""The port's Prometheus exposition (runtime/promexpo.py) against the JAX
package's, on the CPU.

The same registry (Countables with tags, floats, ints, bools and
strings), tracer stages and gauges, profiler gauges and timeline (SLO
burn rates, one stale gauge) built in each package render to the same
text (HELP lines the port words differently on purpose excepted), and
each package's strict validator accepts the other's output.
A gauge without HELP fails the port's validator; every gauge the port's
code emits has HELP text of its own; the HTTP listener serves /metrics
and /healthz (200 / 503)."""

import json
import re
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from deepflow_tpu.runtime import autotune as jauto
from deepflow_tpu.runtime import promexpo as jprom
from deepflow_tpu.runtime import timeline as jtl
from deepflow_tpu.runtime.stats import StatsRegistry as JStats
from deepflow_tpu.runtime.tracing import Tracer as JTracer
from deepflow_tpu_torch.runtime import autotune as tauto
from deepflow_tpu_torch.runtime import promexpo as tprom
from deepflow_tpu_torch.runtime import timeline as ttl
from deepflow_tpu_torch.runtime.profiler import PROFILER_GAUGE_HELP
from deepflow_tpu_torch.runtime.stats import StatsRegistry as TStats
from deepflow_tpu_torch.runtime.tracing import Tracer as TTracer
from deepflow_tpu_torch.runtime.tracing import gauge_help

PORT = Path(__file__).resolve().parent.parent / "deepflow_tpu_torch"
NOW = 3_000_000.0
# HELP text the port words differently on purpose: a program's first
# launch loads a kernel library (no XLA compile), and the busy gauge is
# timed behind a device gate
PORT_HELP = ("deepflow_trace_tpu_compile_s_",
             "deepflow_profiler_tpu_device_busy_fraction")


def _same_text(a, b):
    """Line for line equal, HELP lines of PORT_HELP metrics excepted
    (their metric names must still match)."""
    la, lb = a.split("\n"), b.split("\n")
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x.startswith("# HELP ") and x.split(" ")[2].startswith(
                PORT_HELP):
            assert x.split(" ")[2] == y.split(" ")[2]
            continue
        assert x == y


class _Prof:
    spans_recorded = 123

    def gauges(self):
        return {"tpu_device_busy_fraction": 0.0375,
                "tpu_feed_stall_seconds": 1.25}


@pytest.fixture(autouse=True)
def _no_tuners(monkeypatch):
    # the tuners' registry is process-wide: other tests' tuners stay out
    monkeypatch.setattr(jauto, "autotune_gauges", lambda: {})
    monkeypatch.setattr(tauto, "autotune_gauges", lambda: {})


def _surfaces(stats_cls, tracer_cls, tl_mod, seed, with_timeline):
    rng = np.random.default_rng(seed)
    stats = stats_cls()
    vals = {"rx_frames": int(rng.integers(1, 1 << 40)),
            "rate": float(rng.uniform(0, 1e6)), "mode": "tcp",
            "live": True, "ratio": 0.5}
    stats.register("receiver", lambda: dict(vals), tags={"host": "a\"b"})
    stats.register("exporter.tpu_sketch",
                   lambda: {"rows_in": 4096, "degraded": 0})
    tracer = tracer_cls()
    tracer.enable()
    for stage in ("decode", "kernel.device", "queue.ingest.l4"):
        for d in rng.lognormal(-6, 1.0, 40):
            tracer.observe(stage, float(d))
    for name in ("tpu_h2d_mb_s", "pod_shards_active", "anomaly_score",
                 "tpu_compile_s_dict:n8192", "stale_one"):
        tracer.gauge(name, float(rng.uniform(0, 100)))
        tracer._gauge_stamps[name] = NOW
    tl = None
    if with_timeline:
        tracer._gauge_stamps["stale_one"] = NOW - 100.0
        tl = tl_mod.Timeline(sample_s=1.0, stats=stats, tracer=tracer)
        tl.add_slo(tl_mod.SloRule("ingest_availability", objective=0.999,
                                  bad=("receiver_rate",),
                                  total=("receiver_rx_frames",)))
        for i in range(3):
            tl.sample_once(now=NOW + i * 0.1)
    return stats, tracer, tl


@pytest.mark.parametrize("seed,with_timeline,stride", [
    (0, False, 64), (1, True, 64), (2, True, 16)])
def test_render_equal_and_cross_valid(seed, with_timeline, stride):
    ts, tt, tl = _surfaces(TStats, TTracer, ttl, seed, with_timeline)
    js, jt, jl = _surfaces(JStats, JTracer, jtl, seed, with_timeline)
    text_t = tprom.render_metrics(ts, tt, bucket_stride=stride,
                                  profiler=_Prof(), timeline=tl)
    text_j = jprom.render_metrics(js, jt, bucket_stride=stride,
                                  profiler=_Prof(), timeline=jl)
    _same_text(text_t, text_j)
    assert tprom.validate_exposition(text_j) == []
    assert jprom.validate_exposition(text_t) == []
    assert "deepflow_stage_latency_seconds_bucket" in text_t
    if with_timeline:
        assert "deepflow_selfmetric_stale 1\n" in text_t
        assert "deepflow_trace_stale_one" not in text_t
        assert 'deepflow_slo_burn_rate{slo="ingest_availability",' \
            'window="fast"}' in text_t


@pytest.mark.parametrize("text,problem", [
    ("# TYPE foo gauge\nfoo 1\n", "lacks HELP"),
    ("# HELP foo \n# TYPE foo gauge\nfoo 1\n", "lacks HELP"),
    ("foo{a=\"1\"} 1", "newline"),
    ("# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_bucket{le=\"2\"} 1\n"
     "h_bucket{le=\"+Inf\"} 2\nh_count 2\n", "decrease"),
    ("# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_count 3\n", "+Inf"),
    ("foo 1\n# TYPE foo counter\n", "after its samples"),
    ("foo bar\n", "malformed sample")])
def test_validator_rejects_like_the_reference(text, problem):
    got_t = tprom.validate_exposition(text)
    assert got_t == jprom.validate_exposition(text)
    assert any(problem in p for p in got_t), got_t


def test_every_port_gauge_has_help():
    names = set()
    for path in PORT.rglob("*.py"):
        src = path.read_text()
        names |= set(re.findall(r'\.gauge\(\s*f?"([a-z0-9_]+)', src))
    from deepflow_tpu_torch.runtime.audit import AUDIT_GAUGES
    names |= set(AUDIT_GAUGES)
    assert {"tpu_h2d_mb_s", "pod_hosts_active", "tpu_compile_s_"} <= names
    missing = sorted(n for n in names if not gauge_help(n))
    assert missing == []
    assert set(_Prof().gauges()) <= set(PROFILER_GAUGE_HELP)
    for name, text in PROFILER_GAUGE_HELP.items():
        assert text.strip(), name


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_listener_metrics_and_healthz():
    verdict = {"ok": True, "drain": "running"}
    stats, tracer, tl = _surfaces(TStats, TTracer, ttl, 5, True)
    exp = tprom.PrometheusExporter(stats=stats, tracer=tracer, port=0,
                                   health=lambda: dict(verdict),
                                   timeline=tl)
    exp.start()
    try:
        base = f"http://127.0.0.1:{exp.port}"
        code, body = _get(base + "/metrics")
        assert code == 200 and tprom.validate_exposition(body.decode()) == []
        assert b"deepflow_receiver_rx_frames" in body
        code, body = _get(base + "/healthz")
        assert code == 200 and json.loads(body) == verdict
        verdict["ok"] = False
        code, body = _get(base + "/healthz")
        assert code == 503 and json.loads(body)["ok"] is False
        assert _get(base + "/nope")[0] == 404
    finally:
        exp.close()
