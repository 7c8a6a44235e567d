"""UDP debug protocol: runtime introspection for the CLI.

Reference: server/libs/debug, a UDP request/response protocol every
ingester module registers into, driven by `deepflow-ctl ingester ...`.
Requests and replies are single-datagram JSON: {"cmd": ...} in,
{"ok": ..., "data": ...} out. Built-in commands: `ping`, `counters`
(the Countable registry), `stacks` (every thread's Python stack),
`latency`, `spans`, `rrt` (the flight recorder), `supervisor` (the
supervision tree), `trace-export` (the profiler's span ring and the
tracer's stages as a Chrome trace), `lint` (the port's analyzer over the installed port
package); the Ingester registers its own. The replies are the JAX
package's.
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Callable, Dict, Optional

from deepflow_tpu_torch.runtime.stats import StatsRegistry
from deepflow_tpu_torch.runtime.tracing import Tracer, default_tracer

DEFAULT_DEBUG_PORT = 30035


class DebugServer:
    def __init__(self, stats: StatsRegistry, port: int = DEFAULT_DEBUG_PORT,
                 host: str = "127.0.0.1",
                 tracer: Optional[Tracer] = None) -> None:
        self.stats = stats
        self.tracer = tracer if tracer is not None else default_tracer()
        self._handlers: Dict[str, Callable[[dict], object]] = {
            "ping": lambda req: "pong",
            "counters": self._counters,
            "stacks": self._stacks,
            "latency": self._latency,
            "spans": self._spans,
            "rrt": self._rrt,
            # default supervision-tree view (the Ingester overrides this
            # with its own registration — same shape, same command)
            "supervisor": self._supervisor,
            "lint": self._lint,
            "trace-export": self._trace_export,
        }
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self._sock.settimeout(0.2)
        self._stop = threading.Event()
        self._thread = None            # supervisor ThreadHandle

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def register(self, cmd: str, handler: Callable[[dict], object]) -> None:
        self._handlers[cmd] = handler

    def _counters(self, req: dict) -> dict:
        module = req.get("module")
        out = {}
        for s in self.stats.collect():
            if module is None or s.module.startswith(module):
                out[s.module] = s.values
        return out

    def _latency(self, req: dict) -> dict:
        """Flight-recorder per-stage latency quantiles (the `deepflow-ctl
        ingester rrt`-family backing data). `module` prefix-filters
        stage names. `occupancy` carries the continuous profiler
        reductions (device-busy fraction, feed-overlap efficiency,
        cumulative feed stall) for the CLI's occupancy columns."""
        from deepflow_tpu_torch.runtime.profiler import default_profiler

        want = req.get("module") or ""
        return {"enabled": self.tracer.enabled,
                "stages": {k: v for k, v in self.tracer.latency().items()
                           if k.startswith(want)},
                "occupancy": default_profiler().occupancy()}

    @staticmethod
    def _trace_export(req: dict) -> dict:
        """The occupancy profiler's span ring and the tracer's stages as
        a Chrome-trace / Perfetto JSON timeline (`df-ctl trace export`).
        `limit` caps the newest events of each ring so the reply fits
        the one-datagram budget: a serialized occupancy event runs
        ~130-145B and a stage ~165-200B (epoch-microsecond floats are
        18-19 chars), so 175 of each + track metadata + the occupancy
        wrapper stays under 65000B."""
        from deepflow_tpu_torch.runtime.profiler import default_profiler

        limit = max(0, min(int(req.get("limit", 175)), 175))
        prof = default_profiler()
        return {"trace": prof.to_chrome_trace(limit=limit),
                "spans_recorded": prof.counters()["spans"],
                "occupancy": prof.occupancy()}

    def _spans(self, req: dict) -> dict:
        """Recent completed spans from the ring, newest first. Options:
        stage (exact), slow_ms (only slower), count (<= 200 — the reply
        must fit one datagram)."""
        count = min(int(req.get("count", 20)), 200)
        return {"enabled": self.tracer.enabled,
                "spans": self.tracer.recent(
                    n=count, stage=req.get("stage") or None,
                    slow_ms=(float(req["slow_ms"])
                             if req.get("slow_ms") is not None else None))}

    def _rrt(self, req: dict) -> dict:
        """Where-time-goes attribution: device transfer/kernel gauges
        (h2d MB/s, compile seconds) beside the kernel stage summaries —
        the round-trip view of one batch through the device."""
        lat = self.tracer.latency()
        return {"enabled": self.tracer.enabled,
                "gauges": self.tracer.gauges(),
                "kernel_stages": {k: v for k, v in lat.items()
                                  if k.startswith(("kernel", "shard"))},
                "spans_recorded": self.tracer.spans_recorded}

    @staticmethod
    def _supervisor(req: dict) -> dict:
        """Process supervision tree: worker liveness/restart rows + the
        retained crash ring (tracebacks truncated for the one-datagram
        budget). Pairs with `stacks` — this says WHICH worker is
        crash-looping or deadman-stale, stacks says WHERE it sits."""
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor

        sup = default_supervisor()
        want = req.get("module") or ""
        return {
            "counters": sup.counters(),
            "threads": [t for t in sup.threads() if want in t["name"]],
            "crashes": [{**c, "traceback": c["traceback"][-1200:]}
                        for c in sup.crash_log()[-8:]],
        }

    @staticmethod
    def _lint(req: dict) -> dict:
        """deepflow-lint self-scan of the INSTALLED port package
        (analysis/): is the code this process is actually running clean?
        Per-rule totals plus the first findings, truncated for the
        one-datagram budget; `module` substring-filters finding paths.
        No baseline is applied here — this is the raw discipline
        surface; `df-ctl lint --baseline` owns the grandfathered gate.
        The ast.parse pass over the package runs inside the debug loop's
        request slot and takes SECONDS in a busy process (GIL
        contention) — the CLI client raises its datagram timeout for
        this command, and other debug requests queue behind it (ops
        surface, not hot path)."""
        from collections import Counter

        from deepflow_tpu_torch.analysis import scan_package

        want = req.get("module") or ""
        fs = [f for f in scan_package() if want in f.path]
        return {"total": len(fs),
                "by_rule": dict(sorted(Counter(f.rule for f in fs).items())),
                "findings": [f.to_dict() for f in fs[:25]]}

    @staticmethod
    def _stacks(req: dict) -> dict:
        """Live stack of every thread, keyed "name (tid)". The one-shot
        on-demand form of the reference's always-on pprof endpoint —
        enough to see where a wedged decoder/sender/window thread sits
        without attaching a debugger to the process."""
        import sys
        import traceback
        names = {t.ident: t.name for t in threading.enumerate()}
        out = {}
        for tid, frame in sys._current_frames().items():
            key = f"{names.get(tid, '?')} ({tid})"
            out[key] = [f"{f.filename}:{f.lineno} {f.name}"
                        for f in traceback.extract_stack(frame)][-8:]
        return out

    def start(self) -> None:
        # supervised: a crashed debug loop restarts on the same socket
        # instead of going silently deaf (the socket survives the crash)
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        self._thread = default_supervisor().spawn("debug-udp", self._run)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.stop()
            self._thread.join(timeout=2)
        self._sock.close()

    def _run(self) -> None:
        from deepflow_tpu_torch.runtime.supervisor import default_supervisor
        sup = default_supervisor()
        while not self._stop.is_set():
            sup.beat()
            try:
                data, addr = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                req = json.loads(data.decode())
                handler = self._handlers.get(req.get("cmd", ""))
                if handler is None:
                    resp = {"ok": False, "error": "unknown command"}
                else:
                    resp = {"ok": True, "data": handler(req)}
            except Exception as e:
                resp = {"ok": False, "error": str(e)}
            payload = json.dumps(resp).encode()
            if len(payload) > 65000:   # single-datagram protocol
                payload = json.dumps({
                    "ok": False,
                    "error": f"response too large ({len(payload)} bytes) "
                             "for one datagram; narrow with --module"}
                ).encode()
            try:
                self._sock.sendto(payload, addr)
            except OSError:
                pass


def debug_request(cmd: str, port: int = DEFAULT_DEBUG_PORT,
                  host: str = "127.0.0.1", timeout: float = 2.0,
                  **kw) -> dict:
    """One-shot client (the deepflow-ctl side)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.settimeout(timeout)
    try:
        sock.sendto(json.dumps({"cmd": cmd, **kw}).encode(), (host, port))
        data, _ = sock.recvfrom(1 << 20)
        return json.loads(data.decode())
    finally:
        sock.close()
