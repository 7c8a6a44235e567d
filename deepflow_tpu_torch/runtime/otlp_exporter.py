"""OTLP exporter: l7_flow_log chunks -> OTLP/HTTP trace exports.

Reference: server/ingester/flow_log/exporters/otlp_exporter/ — queue
workers convert L7FlowLog rows to OTLP spans and push them over gRPC to
a collector. Here the conversion targets the same public OTLP wire shape
(wire/protos/otel.proto) shipped as protobuf over HTTP POST /v1/traces
(the OTLP/HTTP binary flavor), with the SmartEncoded endpoint hash
reverse-translated to the span name when the dictionary knows it.

A copy of the JAX package's `runtime/otlp_exporter.py` (host code; this
package imports none of it).
"""

from __future__ import annotations

import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

import numpy as np

from deepflow_tpu_torch.runtime.exporters import QueueWorkerExporter
from deepflow_tpu_torch.runtime.stats import StatsRegistry
from deepflow_tpu_torch.store.dict_store import TagDictRegistry
from deepflow_tpu_torch.wire.gen import otel_pb2


def l7_chunk_to_otlp(cols: Dict[str, np.ndarray],
                     endpoint_dict=None) -> otel_pb2.ExportTraceServiceRequest:
    req = otel_pb2.ExportTraceServiceRequest()
    rs = req.resource_spans.add()
    ss = rs.scope_spans.add()
    n = len(next(iter(cols.values())))
    for i in range(n):
        span = ss.spans.add()
        eh = int(cols["endpoint_hash"][i])
        name = None
        if endpoint_dict is not None:
            name = endpoint_dict.decode(eh)
        span.name = name if name else f"endpoint-{eh:08x}"
        span.kind = 2  # server
        start_ns = int(cols["timestamp"][i]) * 1_000_000_000
        span.start_time_unix_nano = start_ns
        span.end_time_unix_nano = start_ns + int(cols["rrt_us"][i]) * 1000
        span.status.code = 2 if int(cols["status"][i]) else 1
        kv = span.attributes.add()
        kv.key = "df.l7_protocol"
        kv.value.int_value = int(cols["l7_protocol"][i])
        kv = span.attributes.add()
        kv.key = "net.peer.port"
        kv.value.int_value = int(cols["port_dst"][i])
    return req


class OtlpExporter(QueueWorkerExporter):
    """Exporter-contract OTLP/HTTP pusher for l7 streams."""

    def __init__(self, endpoint: str,
                 tag_dicts: Optional[TagDictRegistry] = None,
                 n_workers: int = 2, queue_size: int = 1 << 14,
                 stats: Optional[StatsRegistry] = None) -> None:
        super().__init__("otlp", ["l7_flow_log"], queue_size=queue_size,
                         n_workers=n_workers, batch=16, stats=stats)
        self.endpoint = endpoint.rstrip("/") + "/v1/traces"
        self.endpoint_dict = None if tag_dicts is None else \
            tag_dicts.get("l7_endpoint")
        self.spans_sent = 0
        self.send_errors = 0

    def process(self, chunks: List[Any]) -> None:
        for _stream, _idx, cols, *_ in chunks:
            req = l7_chunk_to_otlp(cols, self.endpoint_dict)
            body = req.SerializeToString()
            http_req = urllib.request.Request(
                self.endpoint, data=body,
                headers={"Content-Type": "application/x-protobuf"})
            try:
                with urllib.request.urlopen(http_req, timeout=10):
                    pass
                self.spans_sent += sum(
                    len(ss.spans) for rs in req.resource_spans
                    for ss in rs.scope_spans)
            except (urllib.error.URLError, OSError):
                self.send_errors += 1

    def counters(self) -> dict:
        c = super().counters()
        c.update({"spans_sent": self.spans_sent,
                  "send_errors": self.send_errors})
        return c
