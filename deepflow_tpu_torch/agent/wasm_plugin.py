"""Wasm L7 plugin runtime: sandboxed custom-protocol parsers.

Reference: agent/src/plugin/wasm/ (vm.rs WasmVm + host.rs import
functions + abi_{import,export}.rs serialization). The reference embeds
wasmtime and exchanges data with the guest through host import
functions that serialize the parse context into guest linear memory and
read serialized results back. This module keeps that exact shape —
pull-style ctx/payload reads, push-style record writes, a log import —
over the in-tree interpreter (wasm_vm.py), since the image has no
wasmtime. Fuel + memory caps give the isolation the .so path
(plugin.py) cannot: a buggy or hostile plugin traps; it cannot corrupt
the agent, hang the capture thread, or read host memory.

Guest ABI (module "df_host" imports; all i32 unless noted):

  read_ctx(dst, cap) -> written      fixed 51-byte ctx blob (layout
                                     below), -1 if cap < 51
  read_payload(dst, off, cap) -> n   copy payload[off:off+cap]
  write_record(ptr) -> 0             parse result blob (layout below)
  log(level, ptr, len)               line into the agent log

ctx blob, little-endian, matching struct df_parse_ctx semantics
(native_src/df_plugin.h): ip_type u8 @0, ip_src[16] @1, ip_dst[16] @17,
port_src u16 @33, port_dst u16 @35, l4_protocol u8 @37, direction u8
@38, time_ns u64 @39, payload_size i32 @47 — 51 bytes.

record blob: msg_type u8 @0, status i32 @1, req_len i32 @5,
resp_len i32 @9, endpoint_len u16 @13, endpoint bytes @15.

Guest exports: df_proto() -> i32 (nonzero protocol id),
df_check() -> i32 (1 = mine), df_parse() -> i32 (DF_ACTION_*),
optional df_init(), optional df_name(dst, cap) -> len.

The port's own copy of the JAX package's `agent/wasm_plugin.py` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import logging
import struct
import time
from typing import List, Optional, Tuple

from deepflow_tpu_torch.agent import l7
from deepflow_tpu_torch.agent.plugin import (DF_ACTION_CONTINUE,
                                             DF_ACTION_ERROR, DF_ACTION_OK)
from deepflow_tpu_torch.agent.wasm_vm import (FuncType, HostFunc, I32,
                                              WasmInstance, WasmModule,
                                              WasmTrap)

log = logging.getLogger(__name__)

CTX_SIZE = 51
_REC_FIXED = 15
MAX_PAYLOAD = 65536


class WasmPlugin:
    """One instantiated wasm parser, shaped like a built-in parser
    (.proto/.check/.parse + wants_ctx) so l7.parse_payload dispatches
    it exactly like the .so and Python plugins."""

    wants_ctx = True

    def __init__(self, blob: bytes, l4_protocol: int = 6,
                 fuel: int = 5_000_000, max_pages: int = 64,
                 name: str = "") -> None:
        self.l4_protocol = l4_protocol
        # per-call scratch the host imports read from / write to
        self._ctx_blob = b"\x00" * CTX_SIZE
        self._payload = b""
        self._record: Optional[tuple] = None
        self.calls = 0
        self.failures = 0
        self.traps = 0
        self.exe_ns = 0

        t_rw = FuncType((I32, I32), (I32,))
        t_rp = FuncType((I32, I32, I32), (I32,))
        t_wr = FuncType((I32,), (I32,))
        t_log = FuncType((I32, I32, I32), ())
        imports = {"df_host": {
            "read_ctx": HostFunc(self._h_read_ctx, t_rw),
            "read_payload": HostFunc(self._h_read_payload, t_rp),
            "write_record": HostFunc(self._h_write_record, t_wr),
            "log": HostFunc(self._h_log, t_log),
        }}
        self.inst = WasmInstance(WasmModule(blob), imports,
                                 fuel=fuel, max_pages=max_pages)
        proto = self.inst.invoke("df_proto")
        if not proto:
            raise ValueError("df_proto() returned 0")
        self.proto = int(proto) & 0xFF
        self.name = name or self._guest_name() or f"wasm-{self.proto}"
        if "df_init" in self.inst.exports:
            self.inst.invoke("df_init")

    def _guest_name(self) -> str:
        if "df_name" not in self.inst.exports:
            return ""
        try:
            n = self.inst.invoke("df_name", 0, 64)
            return self.inst.read_mem(0, min(int(n), 64)) \
                .decode("latin-1", "replace")
        except WasmTrap:
            return ""

    @property
    def transports(self) -> Tuple[int, ...]:
        return (self.l4_protocol,)

    # -- host import functions ---------------------------------------------
    def _h_read_ctx(self, dst: int, cap: int) -> int:
        if cap < CTX_SIZE:
            return (1 << 32) - 1                      # -1 as u32
        self.inst.write_mem(dst, self._ctx_blob)
        return CTX_SIZE

    def _h_read_payload(self, dst: int, off: int, cap: int) -> int:
        chunk = self._payload[off:off + cap]
        self.inst.write_mem(dst, chunk)
        return len(chunk)

    def _h_write_record(self, ptr: int) -> int:
        head = self.inst.read_mem(ptr, _REC_FIXED)
        msg_type = head[0]
        status, req_len, resp_len = struct.unpack_from("<iii", head, 1)
        ep_len = struct.unpack_from("<H", head, 13)[0]
        ep = self.inst.read_mem(ptr + _REC_FIXED, min(ep_len, 128))
        self._record = (msg_type, status, req_len, resp_len,
                        ep.decode("latin-1", "replace"))
        return 0

    def _h_log(self, level: int, ptr: int, n: int) -> None:
        msg = self.inst.read_mem(ptr, min(n, 1024)) \
            .decode("utf-8", "replace")
        fn = (log.error if level >= 2
              else log.warning if level == 1 else log.info)
        fn("wasm plugin %s: %s", getattr(self, "name", "?"), msg)

    # -- dispatch-facing ----------------------------------------------------
    def _stage(self, payload: bytes, proto, port_src: int, port_dst: int,
               ts_ns: int, ip_src: int, ip_dst: int,
               ip_version: int) -> None:
        blob = bytearray(CTX_SIZE)
        blob[0] = 6 if ip_version == 6 else 4
        blob[1:5] = int(ip_src).to_bytes(4, "big")
        blob[17:21] = int(ip_dst).to_bytes(4, "big")
        struct.pack_into("<HH", blob, 33, port_src & 0xFFFF,
                         port_dst & 0xFFFF)
        blob[37] = (proto if proto is not None else self.l4_protocol) & 0xFF
        blob[38] = 0xFF
        struct.pack_into("<Q", blob, 39, ts_ns & ((1 << 64) - 1))
        struct.pack_into("<i", blob, 47, min(len(payload), MAX_PAYLOAD))
        self._ctx_blob = bytes(blob)
        self._payload = payload[:MAX_PAYLOAD]
        self._record = None

    def check(self, payload: bytes, proto=None, port_src: int = 0,
              port_dst: int = 0, ts_ns: int = 0, ip_src: int = 0,
              ip_dst: int = 0, ip_version: int = 4) -> bool:
        t0 = time.perf_counter_ns()
        self._stage(payload, proto, port_src, port_dst, ts_ns,
                    ip_src, ip_dst, ip_version)
        try:
            return bool(self.inst.invoke("df_check"))
        except WasmTrap as e:
            self.traps += 1
            log.warning("wasm plugin %s trapped in check: %s", self.name, e)
            return False
        finally:
            self.calls += 1
            self.exe_ns += time.perf_counter_ns() - t0

    def parse(self, payload: bytes, proto=None, port_src: int = 0,
              port_dst: int = 0, ts_ns: int = 0, ip_src: int = 0,
              ip_dst: int = 0,
              ip_version: int = 4) -> Optional[l7.L7Record]:
        t0 = time.perf_counter_ns()
        self._stage(payload, proto, port_src, port_dst, ts_ns,
                    ip_src, ip_dst, ip_version)
        try:
            rc = int(self.inst.invoke("df_parse"))
        except WasmTrap as e:
            self.traps += 1
            self.failures += 1
            log.warning("wasm plugin %s trapped in parse: %s", self.name, e)
            return None
        finally:
            self.calls += 1
            self.exe_ns += time.perf_counter_ns() - t0
        if rc != DF_ACTION_OK or self._record is None:
            if rc == DF_ACTION_ERROR:
                self.failures += 1
            return None
        msg_type, status, req_len, resp_len, endpoint = self._record
        return l7.L7Record(proto=self.proto, msg_type=msg_type,
                           endpoint=endpoint, status=status,
                           req_len=req_len, resp_len=resp_len)

    def counters(self) -> dict:
        return {"plugin": self.name, "proto": self.proto,
                "calls": self.calls, "failures": self.failures,
                "traps": self.traps, "exe_us": self.exe_ns // 1000,
                "fuel_budget": self.inst.fuel_budget,
                "mem_pages": len(self.inst.mem) // 65536}


def load_wasm_plugin(source, prepend: bool = False,
                     fuel: int = 5_000_000,
                     max_pages: int = 64) -> WasmPlugin:
    """Instantiate + register into the global parser set (the
    reference's rpc-pushed wasm plugin install). `source` is module
    bytes or a .wasm path."""
    blob = source
    if isinstance(source, str):
        with open(source, "rb") as f:
            blob = f.read()
    plugin = WasmPlugin(blob, fuel=fuel, max_pages=max_pages)
    l7.register_parser(plugin, prepend=prepend)
    return plugin


def unload_wasm_plugin(plugin: WasmPlugin) -> bool:
    try:
        l7.PARSERS.remove(plugin)
        return True
    except ValueError:
        return False


def loaded_wasm_plugins() -> List[WasmPlugin]:
    return [p for p in l7.PARSERS if isinstance(p, WasmPlugin)]
