"""Prometheus text exposition over the self-telemetry surfaces.

One HTTP endpoint (the reference server's :9526 self-observation
listener, server/cmd/server/main.go, in Prometheus form) serving:

- every Countable the StatsRegistry scrapes, as
  `deepflow_<module>_<name>` untyped samples with the source's tags as
  labels (non-numeric values ride as labels on a constant-1 info
  sample);
- the flight recorder's per-stage latency histograms
  (`deepflow_stage_latency_seconds{stage}`), cumulative `le` buckets
  read off the host DDSketch's geometric boundaries;
- tracer gauges as `deepflow_trace_<name>`, the occupancy profiler's as
  `deepflow_profiler_<name>`, the feed autotuner's, and with a timeline
  the SLO burn rates (`deepflow_slo_burn_rate{slo,window}`) and the count
  of stale gauges withheld (`deepflow_selfmetric_stale`);
- `/healthz`: 200 or 503 with the health verdict as JSON.

`validate_exposition` is the strict line-format checker (format 0.0.4):
the exposition is a contract with real scrapers, so "mostly parseable"
fails. The rendering is the JAX package's: the same registry and gauges
give the same text.
"""

from __future__ import annotations

import re
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from deepflow_tpu_torch.runtime.stats import StatsRegistry
from deepflow_tpu_torch.runtime.tracing import Tracer, default_tracer

DEFAULT_PROM_PORT = 9526   # the reference's self-observation listener

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_OK = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(*parts: str) -> str:
    return _NAME_OK.sub("_", "_".join(p for p in parts if p))


def _label_name(s: str) -> str:
    s = _LABEL_OK.sub("_", s)
    return ("_" + s) if (not s or s[0].isdigit()) else s


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels(d: Dict[str, str]) -> str:
    if not d:
        return ""
    inner = ",".join(f'{_label_name(k)}="{_escape_label(str(v))}"'
                     for k, v in sorted(d.items()))
    return "{" + inner + "}"


def render_metrics(stats: Optional[StatsRegistry],
                   tracer: Optional[Tracer],
                   bucket_stride: int = 64,
                   profiler=None,
                   timeline=None) -> str:
    """One scrape: collect Countables + tracer state + the occupancy
    profiler's continuous gauges, render text exposition format
    (version 0.0.4). `profiler` defaults to the process profiler
    (runtime/profiler.py) so ``tpu_device_busy_fraction`` /
    ``tpu_feed_stall_seconds`` are freshly computed per scrape.

    With a `timeline` (runtime/timeline.py) attached, fossil gauges —
    tracer gauges whose wall stamp is past the timeline's staleness
    horizon (10x sample cadence) — are withheld COUNTED as
    ``deepflow_selfmetric_stale`` instead of silently served, and the
    timeline's ``slo_burn_rate`` family is exposed as
    ``deepflow_slo_burn_rate{slo,window}``."""
    lines: List[str] = []
    typed: set = set()

    def _sample(name: str, labels: Dict[str, str], value: float,
                mtype: str = "untyped", help_: str = "") -> None:
        if name not in typed:
            typed.add(name)
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name}{_labels(labels)} {_fmt(value)}")

    if stats is not None:
        for s in stats.collect():
            tags = dict(s.tags)
            info = {}
            for k, v in s.values.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    info[k] = str(v)
                else:
                    _sample(_metric_name("deepflow", s.module, k), tags,
                            float(v))
            if info:
                _sample(_metric_name("deepflow", s.module, "info"),
                        {**tags, **info}, 1.0,
                        help_="non-numeric countable values as labels")

    if tracer is not None:
        hname = "deepflow_stage_latency_seconds"
        first = True
        for stage, sk in sorted(tracer.stages().items()):
            # ONE snapshot per stage: spans keep landing while we
            # render, and +Inf must equal _count in the output
            buckets, total, sum_ = sk.snapshot(bucket_stride)
            if total == 0:
                continue
            if first:
                lines.append(f"# HELP {hname} per-stage pipeline latency "
                             "(host DDSketch, relative error "
                             f"{sk.alpha})")
                lines.append(f"# TYPE {hname} histogram")
                typed.add(hname)
                first = False
            lbl = {"stage": stage}
            for le, cum in buckets:
                lines.append(
                    f"{hname}_bucket{_labels({**lbl, 'le': repr(le)})} "
                    f"{_fmt(cum)}")
            lines.append(
                f"{hname}_bucket{_labels({**lbl, 'le': '+Inf'})} "
                f"{_fmt(total)}")
            lines.append(f"{hname}_sum{_labels(lbl)} {repr(sum_)}")
            lines.append(f"{hname}_count{_labels(lbl)} {_fmt(total)}")
        from deepflow_tpu_torch.runtime.tracing import gauge_help
        stale = timeline.stale_gauges() if timeline is not None else {}
        for name, value in sorted(tracer.gauges().items()):
            if name in stale:
                # a fossil: its writer has not refreshed it within the
                # staleness horizon — withheld, counted below, never
                # silently served as if current
                continue
            # gauges registered at runtime (a concurrently-registering
            # thread, a plugin) may lack a GAUGE_HELP entry; the strict
            # validator rejects gauge-typed series without HELP, so
            # fall back to a generic line rather than emit an
            # exposition a real scraper flags mid-incident
            _sample(_metric_name("deepflow_trace", name), {}, value,
                    mtype="gauge",
                    help_=gauge_help(name) or
                    "tracer gauge (no GAUGE_HELP entry; see "
                    "runtime/tracing.py)")
        if timeline is not None:
            _sample("deepflow_selfmetric_stale", {}, float(len(stale)),
                    mtype="gauge",
                    help_="self-metric gauge series withheld from this "
                    "scrape as stale (no write within 10x the timeline "
                    "sample cadence)")
        _sample("deepflow_trace_spans_total", {},
                float(tracer.spans_recorded), mtype="counter",
                help_="spans recorded by the flight recorder")

    if profiler is None:
        from deepflow_tpu_torch.runtime.profiler import default_profiler
        profiler = default_profiler()
    from deepflow_tpu_torch.runtime.profiler import PROFILER_GAUGE_HELP
    for name, value in sorted(profiler.gauges().items()):
        _sample(_metric_name("deepflow_profiler", name), {}, value,
                mtype="gauge", help_=PROFILER_GAUGE_HELP.get(name, ""))
    _sample("deepflow_profiler_spans_total", {},
            float(profiler.spans_recorded), mtype="counter",
            help_="spans recorded into the occupancy ring")

    # the feed autotuner's control-loop gauges (runtime/autotune.py):
    # rendered from the module registry like the profiler's, fresh per
    # scrape — a paused or fallen-back controller still reports its
    # enabled=0 and final knob values instead of going silently absent
    from deepflow_tpu_torch.runtime.autotune import (AUTOTUNE_GAUGE_HELP,
                                               autotune_gauges)
    for name, value in sorted(autotune_gauges().items()):
        _sample(_metric_name("deepflow", name), {}, value,
                mtype="gauge", help_=AUTOTUNE_GAUGE_HELP.get(name, ""))

    if timeline is not None:
        for lbl, burn in sorted(timeline.slo_gauges(),
                                key=lambda p: sorted(p[0].items())):
            _sample("deepflow_slo_burn_rate", lbl, burn, mtype="gauge",
                    help_="error-budget burn rate per SLO and window "
                    "(1.0 = budget burning exactly at its sustainable "
                    "pace; see runtime/timeline.py SloRule)")

    return "\n".join(lines) + "\n"


# -- strict format checker -------------------------------------------------

_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'                       # metric name
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:\\.|[^"\\])*"'       # first label
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="(?:\\.|[^"\\])*")*\})?'  # more labels
    r' (-?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|\+?Inf|NaN))'  # value
    r'( [0-9]+)?$')                                      # optional ts
_HELP_RE = re.compile(r"^# HELP ([a-zA-Z_:][a-zA-Z0-9_:]*) (.*)$")
_TYPE_RE = re.compile(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
                      r"(counter|gauge|histogram|summary|untyped)$")
_LE_RE = re.compile(r'le="((?:\\.|[^"\\])*)"')
_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:\\.|[^"\\])*)"')


def _label_key(labels: str) -> tuple:
    """Canonical (name, value) tuple of a label block, `le` dropped —
    the grouping key that pairs a histogram's buckets with its
    _sum/_count series regardless of label ordering."""
    return tuple(sorted((k, v) for k, v in _PAIR_RE.findall(labels)
                        if k != "le"))


def validate_exposition(text: str) -> List[str]:
    """Strict text-format (0.0.4) checker. Returns a list of problems
    (empty = valid). Enforced beyond the line grammar: body ends with a
    newline, TYPE precedes its samples and appears once, every
    gauge-typed metric carries HELP text (a gauge a scraper can't
    explain is a gauge nobody will trust during an incident), histogram
    series carry a +Inf bucket whose value equals their _count, and
    bucket counts are non-decreasing in le order."""
    problems: List[str] = []
    if not text:
        return ["empty exposition body"]
    if not text.endswith("\n"):
        problems.append("body must end with a newline")
    types: Dict[str, str] = {}
    seen_samples: set = set()
    helped: set = set()
    gauge_lines: Dict[str, int] = {}   # gauge-typed name -> TYPE line
    # histogram accounting: (base_name, labels-sans-le) -> state
    hist: Dict[tuple, dict] = {}
    for ln, line in enumerate(text.split("\n")[:-1], 1):
        if line == "":
            continue
        if line.startswith("#"):
            h = _HELP_RE.match(line)
            if h:
                if h.group(2).strip():
                    helped.add(h.group(1))
                continue
            m = _TYPE_RE.match(line)
            if not m:
                problems.append(f"line {ln}: malformed comment: {line!r}")
                continue
            name = m.group(1)
            if name in types:
                problems.append(f"line {ln}: duplicate TYPE for {name}")
            if name in seen_samples:
                problems.append(
                    f"line {ln}: TYPE for {name} after its samples")
            if m.group(2) == "gauge":
                gauge_lines[name] = ln
            types[name] = m.group(2)
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            problems.append(f"line {ln}: malformed sample: {line!r}")
            continue
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in types \
                    and types[name[:-len(suffix)]] == "histogram":
                base = name[:-len(suffix)]
                break
        seen_samples.add(base)
        if base != name and types.get(base) == "histogram":
            key_labels = _label_key(labels)
            h = hist.setdefault((base, key_labels),
                                {"inf": None, "count": None, "last": None})
            if name.endswith("_bucket"):
                le = _LE_RE.search(labels)
                if le is None:
                    problems.append(
                        f"line {ln}: histogram bucket without le label")
                    continue
                if le.group(1) == "+Inf":
                    h["inf"] = float(value)
                else:
                    v = float(value)
                    if h["last"] is not None and v < h["last"]:
                        problems.append(
                            f"line {ln}: bucket counts decrease "
                            f"for {base}")
                    h["last"] = v
            elif name.endswith("_count"):
                h["count"] = float(value)
    # checked after the full pass: the format does not mandate
    # HELP-before-TYPE order, so a HELP arriving later still counts
    for name, ln in sorted(gauge_lines.items(), key=lambda kv: kv[1]):
        if name not in helped:
            problems.append(f"line {ln}: gauge {name} lacks HELP text")
    for (base, labels), h in hist.items():
        if h["inf"] is None:
            problems.append(f"histogram {base}{labels}: no +Inf bucket")
        elif h["count"] is not None and h["inf"] != h["count"]:
            problems.append(
                f"histogram {base}{labels}: +Inf bucket {h['inf']} "
                f"!= _count {h['count']}")
    return problems


class PrometheusExporter:
    """The :9526-style HTTP listener: GET /metrics + GET /healthz.

    /healthz is the fault-domain liveness contract: `health` is a
    zero-arg callable returning a dict with an "ok" bool (the ingester
    wires Ingester.health — stale supervised threads, open exporter
    breakers, a degraded tpu_sketch lane all fail it). ok -> 200, not
    ok -> 503, body either way is the full JSON verdict, so a k8s
    probe and a human curl read the same surface."""

    def __init__(self, stats: Optional[StatsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 port: int = DEFAULT_PROM_PORT,
                 host: str = "127.0.0.1",
                 health=None, timeline=None) -> None:
        self.stats = stats
        self.tracer = tracer if tracer is not None else default_tracer()
        self.health = health
        self.timeline = timeline
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:   # noqa: N802 (stdlib contract)
                path = self.path.split("?")[0]
                if path == "/healthz":
                    self._healthz()
                    return
                if path not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                try:
                    body = render_metrics(
                        exporter.stats, exporter.tracer,
                        timeline=exporter.timeline).encode()
                except Exception as e:   # a broken countable: 500, not die
                    self.send_error(500, str(e)[:200])
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; "
                                 "charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _healthz(self) -> None:
                import json
                try:
                    verdict = {"ok": True} if exporter.health is None \
                        else dict(exporter.health())
                except Exception as e:
                    verdict = {"ok": False, "error": str(e)[:200]}
                body = json.dumps(verdict).encode()
                self.send_response(200 if verdict.get("ok") else 503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a) -> None:   # quiet: scrape cadence
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread = None            # supervisor ThreadHandle

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        if self._thread is not None:
            return
        # supervised for crash capture + restart; deadman disabled:
        # serve_forever blocks in select() with nowhere to beat from,
        # and a quiet scrape target is healthy, not wedged
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        self._thread = default_supervisor().spawn(
            "prom-exposition", self._server.serve_forever, deadman_s=None)

    def close(self) -> None:
        # shutdown() blocks on the serve_forever loop acking — calling
        # it with no loop running (start() never happened, or it
        # raised) would hang forever
        if self._thread is not None:
            self._thread.stop()
            self._server.shutdown()
            self._thread.join(timeout=2)
            self._thread = None
        self._server.server_close()
