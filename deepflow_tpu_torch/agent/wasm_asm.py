"""Tiny WebAssembly module encoder (assembler).

The agent needs no wasm toolchain (no clang --target=wasm32, no
wat2wasm): plugins and tests build modules directly as spec binary
sections through this helper. Wasm's structured control flow means
function bodies are plain opcode byte strings — no label fixups — so a
parser plugin is writable by hand with the mnemonic helpers below.

Usage:
    m = ModuleBuilder()
    t = m.functype([I32, I32], [I32])
    rd = m.import_func("df_host", "read_payload", t)   # returns func idx
    f = m.func(t, locals_=[I32], body=bytes_of_code, export="df_check")
    blob = m.build()

Reference role: the reference compiles Go/Rust plugin SDKs to wasm with
external toolchains (agent/plugin/wasm). The encoder here replaces the
toolchain, not the SDK: it emits the same spec-defined binary format.

The port's own copy of the JAX package's `agent/wasm_asm.py` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

from deepflow_tpu_torch.agent.wasm_vm import F32, F64, I32, I64  # noqa: F401


def uleb(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def sleb(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        sign = b & 0x40
        if (v == 0 and not sign) or (v == -1 and sign):
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _vec(items: Sequence[bytes]) -> bytes:
    return uleb(len(items)) + b"".join(items)


def _name(s: str) -> bytes:
    b = s.encode("utf-8")
    return uleb(len(b)) + b


# -- mnemonic helpers (return opcode byte strings) --------------------------

def i32_const(v: int) -> bytes:
    if v >= 1 << 31:
        v -= 1 << 32
    return b"\x41" + sleb(v)


def i64_const(v: int) -> bytes:
    if v >= 1 << 63:
        v -= 1 << 64
    return b"\x42" + sleb(v)


def local_get(i: int) -> bytes:
    return b"\x20" + uleb(i)


def local_set(i: int) -> bytes:
    return b"\x21" + uleb(i)


def local_tee(i: int) -> bytes:
    return b"\x22" + uleb(i)


def global_get(i: int) -> bytes:
    return b"\x23" + uleb(i)


def global_set(i: int) -> bytes:
    return b"\x24" + uleb(i)


def call(i: int) -> bytes:
    return b"\x10" + uleb(i)


def br(depth: int) -> bytes:
    return b"\x0c" + uleb(depth)


def br_if(depth: int) -> bytes:
    return b"\x0d" + uleb(depth)


def _mem(op: bytes, align: int, offset: int) -> bytes:
    return op + uleb(align) + uleb(offset)


def i32_load(offset: int = 0, align: int = 2) -> bytes:
    return _mem(b"\x28", align, offset)


def i64_load(offset: int = 0, align: int = 3) -> bytes:
    return _mem(b"\x29", align, offset)


def i32_load8_u(offset: int = 0) -> bytes:
    return _mem(b"\x2d", 0, offset)


def i32_load16_u(offset: int = 0) -> bytes:
    return _mem(b"\x2f", 1, offset)


def i32_store(offset: int = 0, align: int = 2) -> bytes:
    return _mem(b"\x36", align, offset)


def i64_store(offset: int = 0, align: int = 3) -> bytes:
    return _mem(b"\x37", align, offset)


def i32_store8(offset: int = 0) -> bytes:
    return _mem(b"\x3a", 0, offset)


def i32_store16(offset: int = 0) -> bytes:
    return _mem(b"\x3b", 1, offset)


# control / parametric / numeric one-byte opcodes
UNREACHABLE = b"\x00"
NOP = b"\x01"
ELSE = b"\x05"
END = b"\x0b"
RETURN = b"\x0f"
DROP = b"\x1a"
SELECT = b"\x1b"
I32_EQZ = b"\x45"
I32_EQ = b"\x46"
I32_NE = b"\x47"
I32_LT_S = b"\x48"
I32_LT_U = b"\x49"
I32_GT_S = b"\x4a"
I32_GT_U = b"\x4b"
I32_LE_U = b"\x4d"
I32_GE_U = b"\x4f"
I32_ADD = b"\x6a"
I32_SUB = b"\x6b"
I32_MUL = b"\x6c"
I32_DIV_U = b"\x6e"
I32_REM_U = b"\x70"
I32_AND = b"\x71"
I32_OR = b"\x72"
I32_XOR = b"\x73"
I32_SHL = b"\x74"
I32_SHR_U = b"\x76"
I64_ADD = b"\x7c"
I64_MUL = b"\x7e"
MEMORY_SIZE = b"\x3f\x00"
MEMORY_GROW = b"\x40\x00"


def block(body: bytes, result: Optional[int] = None) -> bytes:
    bt = bytes([result]) if result is not None else b"\x40"
    return b"\x02" + bt + body + END


def loop(body: bytes, result: Optional[int] = None) -> bytes:
    bt = bytes([result]) if result is not None else b"\x40"
    return b"\x03" + bt + body + END


def if_else(then: bytes, els: Optional[bytes] = None,
            result: Optional[int] = None) -> bytes:
    bt = bytes([result]) if result is not None else b"\x40"
    out = b"\x04" + bt + then
    if els is not None:
        out += ELSE + els
    return out + END


# -- module builder ----------------------------------------------------------

class ModuleBuilder:
    def __init__(self) -> None:
        self._types: List[Tuple[Tuple[int, ...], Tuple[int, ...]]] = []
        self._imports: List[bytes] = []
        self._n_imported_funcs = 0
        self._funcs: List[int] = []            # type idx per defined func
        self._bodies: List[bytes] = []
        self._mem: Optional[Tuple[int, Optional[int]]] = None
        self._globals: List[bytes] = []
        self._exports: List[bytes] = []
        self._datas: List[bytes] = []
        self._elems: List[bytes] = []
        self._table: Optional[Tuple[int, Optional[int]]] = None
        self._start: Optional[int] = None

    def functype(self, params: Sequence[int],
                 results: Sequence[int]) -> int:
        key = (tuple(params), tuple(results))
        if key in self._types:
            return self._types.index(key)
        self._types.append(key)
        return len(self._types) - 1

    def import_func(self, module: str, name: str, type_idx: int) -> int:
        if self._funcs:
            raise ValueError("imports must be declared before funcs")
        self._imports.append(_name(module) + _name(name) + b"\x00"
                             + uleb(type_idx))
        self._n_imported_funcs += 1
        return self._n_imported_funcs - 1

    def memory(self, min_pages: int, max_pages: Optional[int] = None) -> None:
        self._mem = (min_pages, max_pages)

    def global_i32(self, init: int, mutable: bool = True) -> int:
        self._globals.append(bytes([I32, 1 if mutable else 0])
                             + i32_const(init) + END)
        return len(self._globals) - 1

    def func(self, type_idx: int, body: bytes,
             locals_: Sequence[int] = (),
             export: Optional[str] = None) -> int:
        idx = self._n_imported_funcs + len(self._funcs)
        self._funcs.append(type_idx)
        # locals: run-length encoded per type, preserving order
        groups: List[Tuple[int, int]] = []
        for vt in locals_:
            if groups and groups[-1][1] == vt:
                groups[-1] = (groups[-1][0] + 1, vt)
            else:
                groups.append((1, vt))
        loc = _vec([uleb(c) + bytes([vt]) for c, vt in groups])
        code = loc + body + END
        self._bodies.append(uleb(len(code)) + code)
        if export is not None:
            self.export_func(export, idx)
        return idx

    def export_func(self, name: str, idx: int) -> None:
        self._exports.append(_name(name) + b"\x00" + uleb(idx))

    def export_memory(self, name: str = "memory") -> None:
        self._exports.append(_name(name) + b"\x02" + uleb(0))

    def table(self, min_elems: int,
              funcs: Sequence[int] = (), offset: int = 0) -> None:
        self._table = (min_elems, None)
        if funcs:
            self._elems.append(b"\x00" + i32_const(offset) + END
                               + _vec([uleb(f) for f in funcs]))

    def data(self, offset: int, blob: bytes) -> None:
        self._datas.append(b"\x00" + i32_const(offset) + END
                           + uleb(len(blob)) + blob)

    def start(self, func_idx: int) -> None:
        self._start = func_idx

    def build(self) -> bytes:
        out = bytearray(b"\x00asm\x01\x00\x00\x00")

        def section(sid: int, payload: bytes) -> None:
            if payload:
                out.append(sid)
                out.extend(uleb(len(payload)))
                out.extend(payload)

        section(1, _vec([b"\x60" + _vec([bytes([p]) for p in ps])
                         + _vec([bytes([q]) for q in rs])
                         for ps, rs in self._types]))
        section(2, _vec(self._imports))
        section(3, _vec([uleb(t) for t in self._funcs]))
        if self._table is not None:
            lo, hi = self._table
            lim = (b"\x01" + uleb(lo) + uleb(hi)) if hi is not None \
                else b"\x00" + uleb(lo)
            section(4, _vec([b"\x70" + lim]))
        if self._mem is not None:
            lo, hi = self._mem
            lim = (b"\x01" + uleb(lo) + uleb(hi)) if hi is not None \
                else b"\x00" + uleb(lo)
            section(5, _vec([lim]))
        section(6, _vec(self._globals))
        section(7, _vec(self._exports))
        if self._start is not None:
            section(8, uleb(self._start))
        section(9, _vec(self._elems))
        section(10, _vec(self._bodies))
        section(11, _vec(self._datas))
        return bytes(out)
