"""Querier HTTP API (reference: server/querier/router/query.go).

POST /v1/query           body: db=<db>&sql=<sql>   (form or JSON)
GET  /api/v1/query?query=<promql>[&time=<epoch>]   (Prometheus shape)
GET  /api/v1/query_range?query=&start=&end=&step=  (Prometheus matrix)
GET  /api/v1/labels | /api/v1/label/<n>/values | /api/v1/series?match[]=
                          (Grafana datasource discovery)
POST /api/v1/read         snappy prompb ReadRequest (remote-read)
GET  /v1/profile/flame[?app_service=&event_type=&start=&end=]
GET  /v1/profile/top[?...same...&limit=]
GET  /api/echo | /api/traces/{id} | /api/search[?service=&minDuration=]
     /api/search/tags | /api/search/tag/{name}/values   (Tempo datasource)
GET  /health

Stdlib ThreadingHTTPServer: the query path is read-only over immutable
segments, so handlers are safely concurrent with ingest.
"""

from __future__ import annotations

import json
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from deepflow_tpu_torch.querier.engine import QueryEngine
from deepflow_tpu_torch.querier.profile import ProfileQuery
from deepflow_tpu_torch.querier.promql import PromEngine
from deepflow_tpu_torch.querier.tempo import TempoQuery
from deepflow_tpu_torch.store.db import Store
from deepflow_tpu_torch.store.dict_store import TagDictRegistry

DEFAULT_PORT = 20416   # reference querier listens on 20416


class QuerierServer:
    def __init__(self, store: Store, tag_dicts: TagDictRegistry,
                 port: int = DEFAULT_PORT, host: str = "127.0.0.1",
                 tagrecorder=None, external_apm=None,
                 sketch=None, anomaly=None, supervisor=None,
                 timeline=None, incidents=None, device="cuda") -> None:
        from deepflow_tpu_torch.querier.tracing_adapter import \
            TracingAdapterService
        # serving.SketchTables: both engines mount it as the
        # `sketch` datasource (SQL SELECT sketch.* / PromQL sketch_*),
        # served through the existing /v1/query and /api/v1/query routes
        self.sketch = sketch
        # serving.AnomalyTables: SELECT * FROM anomaly /
        # anomaly_score{detector=...} through the same routes
        self.anomaly = anomaly
        # runtime.Timeline + runtime.IncidentRecorder:
        # self-telemetry series (SQL FROM timeline, PromQL over any
        # timeline-carried metric incl. /api/v1/query_range) and the
        # flight recorder's bundles (SQL FROM incidents), same routes
        self.timeline = timeline
        self.incidents = incidents
        # supervision tree for the accept loop; None = the process
        # default, resolved at start() (a start()-time supervisor
        # argument overrides a constructor-time one)
        self._supervisor = supervisor
        self.engine = QueryEngine(store, tag_dicts, tagrecorder=tagrecorder,
                                  sketch=sketch, anomaly=anomaly,
                                  timeline=timeline, incidents=incidents,
                                  device=device)
        self.prom = PromEngine(store, tag_dicts, sketch=sketch,
                               anomaly=anomaly, timeline=timeline,
                               device=device)
        self.profile = ProfileQuery(store, tag_dicts)
        self.tempo = TempoQuery(store, tag_dicts)
        self.tracing_adapter = TracingAdapterService.from_config(
            external_apm or [])
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            # -- shared param-dict handlers (GET query string and POST
            # form body route here: Grafana's Prometheus datasource
            # defaults to POST for /api/v1/query*) -----------------------
            def _prom_query(self, p) -> None:
                try:
                    result = outer.prom.query(
                        p["query"], at=int(float(p["time"]))
                        if "time" in p else None)
                    self._send(200, {"status": "success",
                                     "data": {"resultType": "vector",
                                              "result": result}})
                except Exception as e:
                    self._send(400, {"status": "error", "error": str(e)})

            def _prom_query_range(self, p) -> None:
                try:
                    result = outer.prom.query_range(
                        p["query"], start=int(float(p["start"])),
                        end=int(float(p["end"])),
                        step=int(float(p["step"])))
                    self._send(200, {"status": "success",
                                     "data": {"resultType": "matrix",
                                              "result": result}})
                except Exception as e:
                    self._send(400, {"status": "error", "error": str(e)})

            def _profile(self, path: str, p) -> None:
                try:
                    tr = None
                    if "start" in p and "end" in p:
                        # inclusive end: scan() filters ts < hi
                        tr = (int(p["start"]), int(p["end"]) + 1)
                    if path.endswith("flame"):
                        res = outer.profile.flame(
                            app_service=p.get("app_service"),
                            event_type=p.get("event_type"), time_range=tr)
                    else:
                        res = outer.profile.top_functions(
                            app_service=p.get("app_service"),
                            event_type=p.get("event_type"), time_range=tr,
                            limit=int(p.get("limit") or 50))
                    self._send(200, {"result": res})
                except Exception as e:
                    self._send(400, {"error": str(e)})

            def _tempo(self, path: str, p) -> None:
                """Tempo datasource routes (reference:
                server/querier/tempo/tempo.go + router/query.go:33-37)."""
                try:
                    tr = None
                    if "start" in p and "end" in p:
                        tr = (int(p["start"]), int(p["end"]) + 1)
                    if path == "/api/echo":
                        # plain text, not JSON: Tempo's health check
                        # compares the literal body
                        body = b"echo"
                        self.send_response(200)
                        self.send_header("Content-Type", "text/plain")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    elif path.startswith("/api/traces/"):
                        trace = outer.tempo.trace(path.split("/")[-1],
                                                  time_range=tr)
                        if trace is None:
                            self._send(404, {"error": "trace not found"})
                        else:
                            self._send(200, trace)
                    elif path == "/v1/l7_tracing":
                        # the L7FlowTracing role: expand a trace from one
                        # l7 row over app/syscall/x-request correlations
                        trace = outer.tempo.l7_tracing(int(p["_id"]),
                                                       time_range=tr)
                        if trace is None:
                            self._send(404, {"error": "row not found"})
                        else:
                            self._send(200, trace)
                    elif path == "/api/search/tags":
                        self._send(200, {"tagNames": outer.tempo.tags()})
                    elif path.startswith("/api/search/tag/"):
                        tag = path.split("/")[-2]
                        self._send(200, {"tagValues":
                                         outer.tempo.tag_values(tag,
                                                                time_range=tr)})
                    else:  # /api/search
                        from deepflow_tpu_torch.querier.tempo import \
                            parse_duration_us
                        res = outer.tempo.search(
                            service=p.get("service"),
                            min_duration_us=parse_duration_us(
                                p.get("minDuration", "0")),
                            limit=int(p.get("limit", 20)), time_range=tr)
                        self._send(200, {"traces": res})
                except Exception as e:
                    self._send(400, {"error": str(e)})

            def _route(self, path: str, params) -> None:
                if path == "/api/v1/query":
                    self._prom_query(params)
                elif path == "/api/v1/query_range":
                    self._prom_query_range(params)
                elif path == "/api/v1/labels":
                    self._send(200, {"status": "success",
                                     "data": outer.prom.label_names()})
                elif path.startswith("/api/v1/label/") and \
                        path.endswith("/values"):
                    name = urllib.parse.unquote(
                        path[len("/api/v1/label/"):-len("/values")])
                    self._send(200, {"status": "success",
                                     "data": outer.prom.label_values(name)})
                elif path == "/api/v1/series":
                    try:
                        # repeated match[] params union (the Prometheus
                        # API shape); params was collapsed to first-value
                        multi = urllib.parse.parse_qs(
                            urllib.parse.urlparse(self.path).query)
                        matches = (multi.get("match[]")
                                   or multi.get("match"))
                        if not matches:
                            raise ValueError("missing match[] selector")
                        data = outer.prom.series(
                            matches,
                            start=int(float(params["start"]))
                            if "start" in params else None,
                            end=int(float(params["end"]))
                            if "end" in params else None)
                        self._send(200, {"status": "success",
                                         "data": data})
                    except Exception as e:
                        self._send(400, {"status": "error",
                                         "error": str(e)})
                elif path in ("/v1/profile/flame", "/v1/profile/top"):
                    self._profile(path, params)
                elif path == "/api/v1/adapter/tracing":
                    # external-APM trace pull (reference
                    # tracing-adapter/router GET ?traceid=)
                    tid = params.get("traceid")
                    if not tid:
                        self._send(400, {"status": "error",
                                         "error": "traceid required"})
                    else:
                        spans = outer.tracing_adapter.get_trace(tid)
                        self._send(200, {
                            "status": "ok",
                            "data": {"spans": [s.to_json()
                                               for s in spans]}})
                elif path == "/api/echo" or path == "/v1/l7_tracing" \
                        or path.startswith("/api/traces/") \
                        or path.startswith("/api/search"):
                    self._tempo(path, params)
                else:
                    self._send(404, {"error": "not found"})

            def do_GET(self) -> None:
                url = urllib.parse.urlparse(self.path)
                if url.path == "/health":
                    self._send(200, {"status": "ok"})
                    return
                params = {k: v[0] for k, v in
                          urllib.parse.parse_qs(url.query).items()}
                self._route(url.path, params)

            def do_POST(self) -> None:
                url = urllib.parse.urlparse(self.path)
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    if length < 0:   # read(-1) would block until EOF
                        raise ValueError("negative Content-Length")
                    raw_bytes = self.rfile.read(length)
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                    return
                if url.path == "/api/v1/read":
                    # prometheus remote-read: snappy protobuf in/out,
                    # handled whole before any text-body parsing
                    try:
                        out = outer.prom.remote_read(raw_bytes)
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/x-protobuf")
                        self.send_header("Content-Encoding", "snappy")
                        self.send_header("Content-Length", str(len(out)))
                        self.end_headers()
                        self.wfile.write(out)
                    except Exception as e:
                        self._send(400, {"error": str(e)})
                    return
                try:
                    raw = raw_bytes.decode()
                    ctype = self.headers.get("Content-Type", "")
                    if "json" in ctype:
                        params = json.loads(raw or "{}")
                    else:
                        params = {k: v[0] for k, v in
                                  urllib.parse.parse_qs(raw).items()}
                except Exception as e:
                    self._send(400, {"error": str(e)})
                    return
                if url.path == "/v1/query":
                    try:
                        res = outer.engine.execute(params.get("sql", ""),
                                                   db=params.get("db")
                                                   or None)
                        self._send(200, {"result": res.as_dict()})
                    except Exception as e:
                        self._send(400, {"error": str(e)})
                    return
                # Prometheus-style endpoints accept POST form bodies too;
                # query-string params fill anything the body omitted
                qs = {k: v[0] for k, v in
                      urllib.parse.parse_qs(url.query).items()}
                self._route(url.path, {**qs, **params})

        class _Server(ThreadingHTTPServer):
            daemon_threads = True

            def service_actions(inner) -> None:
                # serve_forever calls this every poll_interval on the
                # accept thread: a free deadman heartbeat for the
                # supervised worker (no beats, no watchdog; see
                # start())
                beat = self._beat
                if beat is not None:
                    beat()

        self._beat = None
        self._httpd = _Server((host, port), Handler)
        self._handle = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self, supervisor=None) -> None:
        """Spawn the accept loop through the supervision tree (crash
        capture, backoff restart, deadman beats via service_actions).
        `supervisor` defaults
        to the process tree; serve_forever returning after shutdown()
        reads as normal completion, so close() doesn't trigger a
        restart."""
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        sup = supervisor if supervisor is not None else self._supervisor
        if sup is None:
            sup = default_supervisor()
        self._beat = sup.beat
        self._handle = sup.spawn(
            "querier-http", lambda: self._httpd.serve_forever(
                poll_interval=0.5),
            beat_period_s=0.5)

    def close(self) -> None:
        if self._handle is not None:
            self._handle.stop()      # no restart on the way down
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._handle is not None:
            self._handle.join(timeout=2)
            self._handle = None
