"""Integration collector: third-party telemetry HTTP-in on the node.

Reference: agent/src/integration_collector.rs — a hyper server accepting
Prometheus remote-write (/api/v1/prometheus), Telegraf influx lines
(/api/v1/telegraf), OTLP traces (/v1/traces), and profile uploads
(/api/v1/profile/ingest), wrapping each into the uniform-sender firehose
so one transport reaches the ingester. Same surface here over stdlib
HTTP, forwarding through the agent's UniformSenders.

The port's own copy of the JAX package's `agent/integration.py` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import gzip
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from deepflow_tpu_torch.agent.sender import UniformSender
from deepflow_tpu_torch.utils import snappy
from deepflow_tpu_torch.wire.codec import pack_pb_records
from deepflow_tpu_torch.wire.framing import MessageType
from deepflow_tpu_torch.wire.gen import telemetry_pb2

DEFAULT_PORT = 38086   # reference default integration port


class IntegrationCollector:
    def __init__(self, ingester_addr: str, vtap_id: int = 0,
                 port: int = DEFAULT_PORT, host: str = "127.0.0.1") -> None:
        self.senders: Dict[MessageType, UniformSender] = {
            mt: UniformSender(mt, ingester_addr, vtap_id=vtap_id)
            for mt in (MessageType.PROMETHEUS, MessageType.TELEGRAF,
                       MessageType.OPENTELEMETRY, MessageType.PROFILE)
        }
        self.requests = 0
        self.errors = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                outer.requests += 1
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    enc = self.headers.get("Content-Encoding", "")
                    if enc == "gzip":
                        body = gzip.decompress(body)
                    elif enc == "snappy":
                        # Prometheus remote-write mandates snappy
                        body = snappy.decompress(body)
                    path = urllib.parse.urlparse(self.path).path
                    ok = outer.handle(path, body)
                except Exception:
                    outer.errors += 1
                    ok = False
                self.send_response(204 if ok else 400)
                self.end_headers()

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    def set_vtap_id(self, vtap_id: int) -> None:
        for s in self.senders.values():
            s.vtap_id = vtap_id

    def set_target(self, addr: str) -> None:
        for s in self.senders.values():
            s.set_target(addr)

    def handle(self, path: str, body: bytes) -> bool:
        """Route one upload onto the firehose; returns success."""
        if path == "/api/v1/prometheus":
            # body is a remote-write WriteRequest; ship wrapped, the form
            # the ingester's prometheus handler expects (raw payload, not
            # a length-prefixed record batch)
            pm = telemetry_pb2.PrometheusMetric(metrics=body)
            return self.senders[MessageType.PROMETHEUS].send_raw(
                pm.SerializeToString())
        if path == "/api/v1/telegraf":
            # raw influx line payload, one frame
            s = self.senders[MessageType.TELEGRAF]
            return s.send_raw(body)
        if path == "/v1/traces":
            return self.senders[MessageType.OPENTELEMETRY].send_raw(body)
        if path == "/api/v1/profile/ingest":
            # body: one serialized Profile record (or a packed batch)
            return self.senders[MessageType.PROFILE].send_raw(
                pack_pb_records([body]))
        return False

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        # supervised: crash capture for the accept loop. deadman off --
        # serve_forever cannot beat without the querier's service_actions
        # subclass, and a silent watchdog 503 on a healthy collector is
        # worse than no watchdog
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        self._thread = default_supervisor().spawn(
            "integration-http",
            lambda: self._httpd.serve_forever(poll_interval=0.5),
            deadman_s=None)

    def close(self) -> None:
        if self._thread is not None:
            self._thread.stop()     # no restart on the way down
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)
        for s in self.senders.values():
            s.close()

    def counters(self) -> dict:
        return {"requests": self.requests, "errors": self.errors}
