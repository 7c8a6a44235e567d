"""Shared-object L7 plugin runtime: dlopen a .so, adapt it to the
parser registry.

Reference: agent/src/plugin/shared_obj/mod.rs — load_plugin() dlopens
the blob, resolves on_check_payload/on_parse_payload by fixed symbol
names, wraps them in an L7ProtocolParserInterface impl, and counts
executions/failures/latency per plugin (SoPluginCounter,
shared_obj/mod.rs:100). Here the ABI is native_src/df_plugin.h (a
clean-room redesign of shared_obj/so_plugin.h) and the adapter is a
plain parser object for the port's `agent/l7.register_parser` — plugins
and built-ins dispatch through the exact same two-phase check/parse
path. ctypes plays dlopen's role; no separate binding layer to build.

The port's own copy of the JAX package's `agent/plugin.py` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Tuple

from deepflow_tpu_torch.agent import l7
from deepflow_tpu_torch.ops._build import BUILD_DIR

# the sample plugin (memcached text protocol, protocol id 201) and its ABI
# header: the port's own copies
NATIVE_SRC = Path(__file__).resolve().parent / "native_src"
SAMPLE_FLAGS = ("-shared", "-fPIC", "-O2", "-std=c++17")

DF_ACTION_ERROR = 0
DF_ACTION_CONTINUE = 1
DF_ACTION_OK = 2


class ParseCtx(ctypes.Structure):
    """struct df_parse_ctx (native_src/df_plugin.h)."""

    _fields_ = [
        ("ip_type", ctypes.c_uint8),
        ("ip_src", ctypes.c_uint8 * 16),
        ("ip_dst", ctypes.c_uint8 * 16),
        ("port_src", ctypes.c_uint16),
        ("port_dst", ctypes.c_uint16),
        ("l4_protocol", ctypes.c_uint8),
        ("direction", ctypes.c_uint8),
        ("time_ns", ctypes.c_uint64),
        ("payload_size", ctypes.c_int32),
        ("payload", ctypes.POINTER(ctypes.c_uint8)),
    ]


class L7RecordC(ctypes.Structure):
    """struct df_l7_record (native_src/df_plugin.h)."""

    _fields_ = [
        ("msg_type", ctypes.c_uint8),
        ("status", ctypes.c_int32),
        ("req_len", ctypes.c_int32),
        ("resp_len", ctypes.c_int32),
        ("endpoint", ctypes.c_char * 128),
    ]


class SoPlugin:
    """One loaded plugin, shaped like a built-in parser (.proto /
    .check / .parse) so l7.parse_payload dispatches it unchanged.
    `wants_ctx` makes the dispatcher hand over ports/ips/time so the
    full df_parse_ctx reaches the .so (plugins legitimately gate on
    ctx->port_dst etc. — zeros there would silently never match)."""

    wants_ctx = True

    def __init__(self, path: str, l4_protocol: int = 6) -> None:
        self.path = path
        self.l4_protocol = l4_protocol
        lib = ctypes.CDLL(path)   # raises OSError on a bad .so
        try:
            proto_fn = lib.df_plugin_proto
            name_fn = lib.df_plugin_name
            self._check = lib.df_check_payload
            self._parse = lib.df_parse_payload
        except AttributeError as e:
            raise ValueError(f"{path}: missing required export: {e}")
        proto_fn.restype = ctypes.c_uint8
        name_fn.restype = ctypes.c_char_p
        self._check.restype = ctypes.c_int
        self._check.argtypes = [ctypes.POINTER(ParseCtx)]
        self._parse.restype = ctypes.c_int
        self._parse.argtypes = [ctypes.POINTER(ParseCtx),
                                ctypes.POINTER(L7RecordC)]
        self.proto = int(proto_fn())
        if self.proto == 0:
            raise ValueError(f"{path}: df_plugin_proto() returned 0")
        self.name = (name_fn() or b"").decode("latin-1")
        init = getattr(lib, "df_plugin_init", None)
        if init is not None:
            init.restype = None
            init()
        self._lib = lib          # keep the dlopen handle alive
        # SoPluginCounter (shared_obj/mod.rs:100): executions, failures,
        # cumulative wall time
        self.calls = 0
        self.failures = 0
        self.exe_ns = 0

    @property
    def transports(self) -> Tuple[int, ...]:
        return (self.l4_protocol,)

    def _ctx(self, payload: bytes, proto, port_src: int, port_dst: int,
             ts_ns: int, ip_src: int, ip_dst: int,
             ip_version: int = 4) -> ParseCtx:
        ctx = ParseCtx()
        # ip_type follows the packet's IP version. For v6 the capture
        # layer only carries the FNV-folded u32 (packet.py _fold16_rows),
        # so the fold lands in the first 4 bytes of the 16-byte field and
        # the rest stays zero — plugins branching on ip_type==6 see the
        # right type but a folded address (documented ABI limitation).
        ctx.ip_type = 6 if ip_version == 6 else 4
        ctx.ip_src[:4] = int(ip_src).to_bytes(4, "big")
        ctx.ip_dst[:4] = int(ip_dst).to_bytes(4, "big")
        ctx.port_src = port_src
        ctx.port_dst = port_dst
        ctx.l4_protocol = proto if proto is not None else self.l4_protocol
        ctx.direction = 0xFF
        ctx.time_ns = ts_ns
        ctx.payload_size = len(payload)
        ctx.payload = ctypes.cast(ctypes.c_char_p(payload),
                                  ctypes.POINTER(ctypes.c_uint8))
        return ctx

    def check(self, payload: bytes, proto=None, port_src: int = 0,
              port_dst: int = 0, ts_ns: int = 0,
              ip_src: int = 0, ip_dst: int = 0, ip_version: int = 4) -> bool:
        t0 = time.perf_counter_ns()
        try:
            ctx = self._ctx(payload, proto, port_src, port_dst, ts_ns,
                            ip_src, ip_dst, ip_version)
            return bool(self._check(ctypes.byref(ctx)))
        finally:
            self.calls += 1
            self.exe_ns += time.perf_counter_ns() - t0

    def parse(self, payload: bytes, proto=None, port_src: int = 0,
              port_dst: int = 0, ts_ns: int = 0,
              ip_src: int = 0, ip_dst: int = 0,
              ip_version: int = 4) -> Optional[l7.L7Record]:
        out = L7RecordC()
        t0 = time.perf_counter_ns()
        rc = self._parse(ctypes.byref(self._ctx(payload, proto, port_src,
                                                port_dst, ts_ns,
                                                ip_src, ip_dst, ip_version)),
                         ctypes.byref(out))
        self.exe_ns += time.perf_counter_ns() - t0
        self.calls += 1
        if rc != DF_ACTION_OK:
            if rc == DF_ACTION_ERROR:
                self.failures += 1
            return None
        return l7.L7Record(
            proto=self.proto,
            msg_type=int(out.msg_type),
            endpoint=out.endpoint.decode("latin-1", "replace"),
            status=int(out.status),
            req_len=int(out.req_len),
            resp_len=int(out.resp_len),
        )

    def counters(self) -> dict:
        return {"plugin": self.name, "proto": self.proto,
                "calls": self.calls, "failures": self.failures,
                "exe_us": self.exe_ns // 1000}


def load_so_plugin(path: str, prepend: bool = False) -> SoPlugin:
    """dlopen + validate + register into the global parser set (the
    reference's rpc-pushed plugin install, trident.rs plugin handling)."""
    plugin = SoPlugin(path)
    l7.register_parser(plugin, prepend=prepend)
    return plugin


def unload_so_plugin(plugin: SoPlugin) -> bool:
    """Remove a previously loaded plugin from the parser set."""
    try:
        l7.PARSERS.remove(plugin)
        return True
    except ValueError:
        return False


def loaded_plugins() -> List[SoPlugin]:
    return [p for p in l7.PARSERS if isinstance(p, SoPlugin)]


def build_sample_plugin() -> str:
    """The memcached sample plugin built from `native_src/` with g++ at
    first use (never at import) into `build/deepflow_tpu_torch/`, under
    a name keyed by the source, the ABI header and the flags; returns its
    path. Raises OSError or subprocess.CalledProcessError where g++ is
    missing or fails."""
    src = NATIVE_SRC / "memcached_plugin.cc"
    h = hashlib.sha256(src.read_bytes())
    h.update((NATIVE_SRC / "df_plugin.h").read_bytes())
    h.update(" ".join(SAMPLE_FLAGS).encode())
    out = BUILD_DIR / f"memcached_plugin-{h.hexdigest()[:16]}.so"
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *SAMPLE_FLAGS, str(src), "-o", str(tmp)],
                   check=True, capture_output=True, cwd=str(NATIVE_SRC),
                   timeout=300)
    os.replace(tmp, out)
    return str(out)
