"""Clean-room WebAssembly MVP interpreter for sandboxed L7 plugins.

Role: the reference runs custom-protocol parser plugins inside wasmtime
(agent/src/plugin/wasm/vm.rs — Instance construction, epoch
interruption, memory/fuel confinement). The agent's hosts need not ship a
wasm runtime or a wasm toolchain, so this module implements the
WebAssembly core (MVP) spec directly: binary decoding, a structured-
control-flow stack machine, linear memory, tables, globals, and host
imports. It is NOT derived from wasmtime or the reference — the spec
itself (webassembly.github.io/spec/core) is the contract.

Sandboxing properties (the reason wasm plugins exist at all, vs the
dlopen .so path in agent/plugin.py which runs native code in-process):

- guest memory is a Python bytearray: every access is bounds-checked,
  out-of-range load/store traps; the guest cannot touch host memory
- fuel metering: every executed instruction decrements a budget; a
  runaway loop traps with WasmTrap("out of fuel") instead of hanging
  the capture thread (wasmtime's epoch interruption, done simply)
- memory growth is capped (max_pages), call depth is capped
- the only host surface is the import functions the embedder passes in

Scope: full MVP instruction set (i32/i64/f32/f64 numeric, parametric,
variable, memory, control, call_indirect), sign-extension ops, and
saturating truncations (0xFC 0..7). Not implemented (trap at decode
with a clear message): SIMD, threads, reference types beyond MVP
funcref tables, multi-value block signatures, bulk memory.

The port's own copy of the JAX package's `agent/wasm_vm.py` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


class WasmTrap(Exception):
    """Any guest fault: OOB access, fuel exhaustion, unreachable,
    bad indirect call, integer div by zero…"""


class WasmDecodeError(Exception):
    """Malformed or out-of-scope module bytes."""


MAGIC = b"\x00asm\x01\x00\x00\x00"
PAGE = 65536

# value types
I32, I64, F32, F64 = 0x7F, 0x7E, 0x7D, 0x7C
FUNCREF = 0x70
_VALTYPE_NAMES = {I32: "i32", I64: "i64", F32: "f32", F64: "f64"}


# ---------------------------------------------------------------------------
# binary reader

class _Reader:
    __slots__ = ("b", "i")

    def __init__(self, b: bytes, i: int = 0) -> None:
        self.b = b
        self.i = i

    def u8(self) -> int:
        try:
            v = self.b[self.i]
        except IndexError:
            raise WasmDecodeError("unexpected end of module")
        self.i += 1
        return v

    def bytes(self, n: int) -> bytes:
        if self.i + n > len(self.b):
            raise WasmDecodeError("unexpected end of module")
        v = self.b[self.i:self.i + n]
        self.i += n
        return v

    def uleb(self, bits: int = 32) -> int:
        result = 0
        shift = 0
        while True:
            byte = self.u8()
            result |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
            if shift >= bits + 7:
                raise WasmDecodeError("uleb overlong")
        if result >= 1 << bits:
            raise WasmDecodeError("uleb out of range")
        return result

    def sleb(self, bits: int = 32) -> int:
        result = 0
        shift = 0
        while True:
            byte = self.u8()
            result |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                if byte & 0x40 and shift < bits + 7:
                    result |= -1 << shift
                break
            if shift >= bits + 7:
                raise WasmDecodeError("sleb overlong")
        lo, hi = -(1 << (bits - 1)), 1 << (bits - 1)
        if not (lo <= result < hi):
            raise WasmDecodeError("sleb out of range")
        return result

    def f32(self) -> float:
        return struct.unpack("<f", self.bytes(4))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self.bytes(8))[0]

    def name(self) -> str:
        n = self.uleb()
        return self.bytes(n).decode("utf-8")

    def eof(self) -> bool:
        return self.i >= len(self.b)


# ---------------------------------------------------------------------------
# module structure

@dataclass
class FuncType:
    params: Tuple[int, ...]
    results: Tuple[int, ...]


@dataclass
class FuncBody:
    type_idx: int
    locals: List[int] = field(default_factory=list)   # expanded valtypes
    code: bytes = b""                                  # raw expr, incl 0x0B


@dataclass
class GlobalDef:
    valtype: int
    mutable: bool
    init: bytes    # const expr


@dataclass
class Import:
    module: str
    name: str
    kind: int       # 0 func, 1 table, 2 mem, 3 global
    desc: object


@dataclass
class Export:
    name: str
    kind: int
    idx: int


class WasmModule:
    """Decoded (not yet instantiated) module."""

    def __init__(self, data: bytes) -> None:
        if data[:8] != MAGIC:
            raise WasmDecodeError("bad magic/version")
        self.types: List[FuncType] = []
        self.imports: List[Import] = []
        self.func_type_idxs: List[int] = []   # for module-defined funcs
        self.table_limits: Optional[Tuple[int, Optional[int]]] = None
        self.mem_limits: Optional[Tuple[int, Optional[int]]] = None
        self.globals: List[GlobalDef] = []
        self.exports: List[Export] = []
        self.start: Optional[int] = None
        self.elems: List[Tuple[bytes, List[int]]] = []   # (offset expr, fn idxs)
        self.bodies: List[FuncBody] = []
        self.datas: List[Tuple[bytes, bytes]] = []       # (offset expr, bytes)

        r = _Reader(data, 8)
        last_id = 0
        while not r.eof():
            sec_id = r.u8()
            size = r.uleb()
            sec = _Reader(r.bytes(size))
            if sec_id != 0:
                if sec_id < last_id:
                    raise WasmDecodeError(f"section {sec_id} out of order")
                last_id = sec_id
            if sec_id == 0:
                continue                     # custom section: skip
            elif sec_id == 1:
                self._sec_types(sec)
            elif sec_id == 2:
                self._sec_imports(sec)
            elif sec_id == 3:
                for _ in range(sec.uleb()):
                    self.func_type_idxs.append(sec.uleb())
            elif sec_id == 4:
                self._sec_tables(sec)
            elif sec_id == 5:
                self._sec_mems(sec)
            elif sec_id == 6:
                self._sec_globals(sec)
            elif sec_id == 7:
                for _ in range(sec.uleb()):
                    nm = sec.name()
                    self.exports.append(Export(nm, sec.u8(), sec.uleb()))
            elif sec_id == 8:
                self.start = sec.uleb()
            elif sec_id == 9:
                self._sec_elems(sec)
            elif sec_id == 10:
                self._sec_code(sec)
            elif sec_id == 11:
                self._sec_datas(sec)
            else:
                raise WasmDecodeError(f"unknown section id {sec_id}")
        if len(self.bodies) != len(self.func_type_idxs):
            raise WasmDecodeError("func/code section count mismatch")

    # -- section parsers ---------------------------------------------------
    def _sec_types(self, r: _Reader) -> None:
        for _ in range(r.uleb()):
            if r.u8() != 0x60:
                raise WasmDecodeError("expected functype 0x60")
            params = tuple(r.u8() for _ in range(r.uleb()))
            results = tuple(r.u8() for _ in range(r.uleb()))
            if len(results) > 1:
                raise WasmDecodeError("multi-value results not supported")
            self.types.append(FuncType(params, results))

    def _limits(self, r: _Reader) -> Tuple[int, Optional[int]]:
        flag = r.u8()
        lo = r.uleb()
        hi = r.uleb() if flag & 1 else None
        return lo, hi

    def _sec_imports(self, r: _Reader) -> None:
        for _ in range(r.uleb()):
            mod, nm = r.name(), r.name()
            kind = r.u8()
            if kind == 0:
                desc = r.uleb()                      # type idx
            elif kind == 1:
                if r.u8() != FUNCREF:
                    raise WasmDecodeError("only funcref tables")
                desc = self._limits(r)
            elif kind == 2:
                desc = self._limits(r)
            elif kind == 3:
                desc = (r.u8(), bool(r.u8()))
            else:
                raise WasmDecodeError(f"bad import kind {kind}")
            self.imports.append(Import(mod, nm, kind, desc))

    def _sec_tables(self, r: _Reader) -> None:
        for _ in range(r.uleb()):
            if r.u8() != FUNCREF:
                raise WasmDecodeError("only funcref tables")
            self.table_limits = self._limits(r)

    def _sec_mems(self, r: _Reader) -> None:
        n = r.uleb()
        if n > 1:
            raise WasmDecodeError("multiple memories")
        for _ in range(n):
            self.mem_limits = self._limits(r)

    def _const_expr(self, r: _Reader) -> bytes:
        start = r.i
        depth = 0
        while True:
            op = r.u8()
            if op == 0x0B and depth == 0:
                return r.b[start:r.i]
            if op == 0x41:
                r.sleb(32)
            elif op == 0x42:
                r.sleb(64)
            elif op == 0x43:
                r.bytes(4)
            elif op == 0x44:
                r.bytes(8)
            elif op == 0x23:
                r.uleb()
            else:
                raise WasmDecodeError(f"non-const opcode {op:#x} in "
                                      "const expr")

    def _sec_globals(self, r: _Reader) -> None:
        for _ in range(r.uleb()):
            vt = r.u8()
            mut = bool(r.u8())
            self.globals.append(GlobalDef(vt, mut, self._const_expr(r)))

    def _sec_elems(self, r: _Reader) -> None:
        for _ in range(r.uleb()):
            if r.uleb() != 0:
                raise WasmDecodeError("only active table-0 elements")
            off = self._const_expr(r)
            fns = [r.uleb() for _ in range(r.uleb())]
            self.elems.append((off, fns))

    def _sec_code(self, r: _Reader) -> None:
        n = r.uleb()
        if n > len(self.func_type_idxs):
            raise WasmDecodeError("more code bodies than declared funcs")
        for ti in range(n):
            body_size = r.uleb()
            body = _Reader(r.bytes(body_size))
            locals_: List[int] = []
            for _ in range(body.uleb()):
                count = body.uleb()
                vt = body.u8()
                # cap the TOTAL expansion: a few bytes of declarations
                # must not demand gigabytes of locals
                if len(locals_) + count > 1 << 16:
                    raise WasmDecodeError("absurd local count")
                locals_.extend([vt] * count)
            code = body.b[body.i:]
            self.bodies.append(FuncBody(self.func_type_idxs[ti],
                                        locals_, code))

    def _sec_datas(self, r: _Reader) -> None:
        for _ in range(r.uleb()):
            if r.uleb() != 0:
                raise WasmDecodeError("only active memory-0 data")
            off = self._const_expr(r)
            self.datas.append((off, r.bytes(r.uleb())))


# ---------------------------------------------------------------------------
# numeric helpers (wasm semantics on Python ints/floats)

_U32, _U64 = (1 << 32) - 1, (1 << 64) - 1


def _s32(v: int) -> int:
    v &= _U32
    return v - (1 << 32) if v >> 31 else v


def _s64(v: int) -> int:
    v &= _U64
    return v - (1 << 64) if v >> 63 else v


def _trunc(val: float, lo: int, hi: int, bits: int, sat: bool) -> int:
    if math.isnan(val):
        if sat:
            return 0
        raise WasmTrap("invalid conversion: NaN")
    t = math.trunc(val)
    if t < lo or t > hi:
        if sat:
            t = lo if t < lo else hi
        else:
            raise WasmTrap("integer overflow in truncation")
    return t & ((1 << bits) - 1)


def _f32(v: float) -> float:
    return struct.unpack("<f", struct.pack("<f", v))[0]


class _Branch(Exception):
    __slots__ = ("depth",)

    def __init__(self, depth: int) -> None:
        self.depth = depth


class _Return(Exception):
    pass


def _build_ctrl_map(code: bytes) -> Dict[int, Tuple[Optional[int], int]]:
    """One linear pre-scan of a function body: for every block/loop/if
    opcode position, record (else_pos, end_pos) — indices just AFTER
    the matching else/end bytes. Branches and untaken if-arms then jump
    by table lookup instead of rescanning bytecode, which both bounds a
    hostile module's wall-clock by its fuel (scanning charged no fuel)
    and removes the rescan cost from legitimate hot loops."""
    r = _Reader(code)
    stack: List[List] = []
    cmap: Dict[int, Tuple[Optional[int], int]] = {}
    while not r.eof():
        pos = r.i
        op = r.u8()
        if op in (0x02, 0x03, 0x04):
            r.sleb(33)                       # block type
            stack.append([pos, None])
        elif op == 0x05:
            if not stack:
                raise WasmDecodeError("else outside if")
            stack[-1][1] = r.i
        elif op == 0x0B:
            if stack:
                start, else_pos = stack.pop()
                cmap[start] = (else_pos, r.i)
            # else: the function body's own terminating end
        else:
            _skip_immediates(r, op)
    if stack:
        raise WasmDecodeError("unterminated block")
    return cmap


# ---------------------------------------------------------------------------
# instance

class HostFunc:
    """A host import: fn(*wasm args) -> int/float result or None.
    `ftype` declares the wasm signature it satisfies."""

    def __init__(self, fn: Callable, ftype: FuncType) -> None:
        self.fn = fn
        self.ftype = ftype


class WasmInstance:
    """One instantiated module with its own memory/globals/table.

    imports: {"module": {"name": HostFunc | int (global init value)}}.
    fuel: instruction budget per `invoke` (refilled each call);
    max_pages caps memory.grow regardless of the module's own limits.
    """

    MAX_CALL_DEPTH = 64

    def __init__(self, module: WasmModule,
                 imports: Optional[Dict[str, Dict[str, object]]] = None,
                 fuel: int = 20_000_000, max_pages: int = 64) -> None:
        self.module = module
        self.fuel_budget = fuel
        self.fuel = fuel
        self.max_pages = max_pages
        imports = imports or {}

        # function index space: imports first, then module-defined
        self.funcs: List[object] = []   # HostFunc | int (body index)
        self.globals: List[List] = []   # [valtype, mutable, value]
        n_imp_globals = 0
        for imp in module.imports:
            src = imports.get(imp.module, {})
            if imp.name not in src:
                raise WasmDecodeError(
                    f"unresolved import {imp.module}.{imp.name}")
            tgt = src[imp.name]
            if imp.kind == 0:
                if not isinstance(tgt, HostFunc):
                    raise WasmDecodeError(
                        f"import {imp.module}.{imp.name} is not a function")
                want = module.types[imp.desc]
                if (tgt.ftype.params, tgt.ftype.results) != \
                        (want.params, want.results):
                    raise WasmDecodeError(
                        f"import {imp.module}.{imp.name} signature mismatch")
                self.funcs.append(tgt)
            elif imp.kind == 3:
                vt, mut = imp.desc
                self.globals.append([vt, mut, tgt])
                n_imp_globals += 1
            else:
                raise WasmDecodeError("table/memory imports not supported")
        self._n_imported_funcs = len(self.funcs)
        self.funcs.extend(range(len(module.bodies)))

        # memory
        lo, hi = module.mem_limits or (0, 0)
        if lo > max_pages:
            raise WasmDecodeError(
                f"module wants {lo} pages > sandbox cap {max_pages}")
        self.mem = bytearray(lo * PAGE)
        self._mem_max = min(hi if hi is not None else max_pages, max_pages)

        # globals
        for g in module.globals:
            self.globals.append([g.valtype, g.mutable,
                                 self._eval_const(g.init)])

        # table
        tlo = module.table_limits[0] if module.table_limits else 0
        self.table: List[Optional[int]] = [None] * tlo
        for off_expr, fns in module.elems:
            off = self._eval_const(off_expr)
            if off + len(fns) > len(self.table):
                raise WasmDecodeError("element segment out of table range")
            for k, fi in enumerate(fns):
                self.table[off + k] = fi

        # data
        for off_expr, blob in module.datas:
            off = self._eval_const(off_expr)
            if off + len(blob) > len(self.mem):
                raise WasmDecodeError("data segment out of memory range")
            self.mem[off:off + len(blob)] = blob

        self.exports = {e.name: e for e in module.exports}
        self._cmaps: Dict[int, Dict[int, Tuple[Optional[int], int]]] = {}

        if module.start is not None:
            self._call_function(module.start, [])

    # -- public ------------------------------------------------------------
    def invoke(self, name: str, *args):
        """Call an exported function; refills fuel for this entry."""
        e = self.exports.get(name)
        if e is None or e.kind != 0:
            raise WasmTrap(f"no exported function {name!r}")
        self.fuel = self.fuel_budget
        ftype = self._func_type(e.idx)
        if len(args) != len(ftype.params):
            raise WasmTrap(f"{name} expects {len(ftype.params)} args")
        try:
            res = self._call_function(e.idx, list(args))
        except WasmTrap:
            raise
        except WasmDecodeError as e2:
            # decode faults reached at RUN time (lazily-scanned bodies,
            # unsupported opcodes on a cold path) are sandbox traps to
            # the embedder — instantiation-time ones still raise plainly
            raise WasmTrap(f"runtime decode fault: {e2}") from None
        except RecursionError:
            # backstop for pathological block nesting: the explicit
            # MAX_CALL_DEPTH usually trips first, but the interpreter
            # itself recurses per nested construct
            raise WasmTrap("call stack exhausted") from None
        except Exception as e2:
            # the interpreter runs UNVALIDATED guest code: stack
            # underflow, bad indices, type confusion etc. surface as
            # ordinary Python exceptions. The sandbox contract is that
            # a hostile/buggy module traps — never takes the host down.
            raise WasmTrap(f"interpreter fault: {e2!r}") from None
        return res[0] if res else None

    def read_mem(self, ptr: int, n: int) -> bytes:
        if ptr < 0 or n < 0 or ptr + n > len(self.mem):
            raise WasmTrap("host read out of guest memory bounds")
        return bytes(self.mem[ptr:ptr + n])

    def write_mem(self, ptr: int, blob: bytes) -> None:
        if ptr < 0 or ptr + len(blob) > len(self.mem):
            raise WasmTrap("host write out of guest memory bounds")
        self.mem[ptr:ptr + len(blob)] = blob

    # -- internals ----------------------------------------------------------
    def _func_type(self, idx: int) -> FuncType:
        if idx < self._n_imported_funcs:
            return self.funcs[idx].ftype
        body = self.module.bodies[self.funcs[idx]]
        return self.module.types[body.type_idx]

    def _eval_const(self, expr: bytes):
        r = _Reader(expr)
        op = r.u8()
        if op == 0x41:
            return r.sleb(32) & _U32
        if op == 0x42:
            return r.sleb(64) & _U64
        if op == 0x43:
            return r.f32()
        if op == 0x44:
            return r.f64()
        if op == 0x23:
            return self.globals[r.uleb()][2]
        raise WasmDecodeError(f"bad const opcode {op:#x}")

    def _call_function(self, idx: int, args: List, depth: int = 0) -> List:
        if depth > self.MAX_CALL_DEPTH:
            raise WasmTrap("call stack exhausted")
        fn = self.funcs[idx]
        if isinstance(fn, HostFunc):
            res = fn.fn(*args)
            if res is None:
                return []
            return [res]
        body = self.module.bodies[fn]
        cmap = self._cmaps.get(fn)
        if cmap is None:
            # the pre-scan is O(len) work: charge it to the guest
            self.fuel -= len(body.code) >> 2
            if self.fuel <= 0:
                raise WasmTrap("out of fuel")
            cmap = _build_ctrl_map(body.code)
            self._cmaps[fn] = cmap
        ftype = self.module.types[body.type_idx]
        locals_ = list(args)
        for vt in body.locals:
            locals_.append(0 if vt in (I32, I64) else 0.0)
        stack: List = []
        frame = _Frame(self, locals_, stack, depth, cmap)
        try:
            frame.run_block(_Reader(body.code), len(body.code),
                            len(ftype.results))
        except _Return:
            pass
        if ftype.results:
            if not stack:
                raise WasmTrap("function fell off without result")
            return [stack[-1]]
        return []


class _Frame:
    """Execution of one wasm function body (structured interpreter:
    run_block recurses per block/loop/if; br unwinds via _Branch and
    repositions the reader by ctrl-map lookup, never by rescanning)."""

    __slots__ = ("inst", "locals", "stack", "depth", "cmap")

    def __init__(self, inst: WasmInstance, locals_: List, stack: List,
                 depth: int,
                 cmap: Dict[int, Tuple[Optional[int], int]]) -> None:
        self.inst = inst
        self.locals = locals_
        self.stack = stack
        self.depth = depth
        self.cmap = cmap

    # ---- memory access helpers
    def _ea(self, r: _Reader, width: int) -> int:
        r.uleb()                 # align hint: ignored
        offset = r.uleb()
        addr = self.stack.pop() + offset
        if addr < 0 or addr + width > len(self.inst.mem):
            raise WasmTrap("out of bounds memory access")
        return addr

    def _load(self, r: _Reader, fmt: str, width: int):
        a = self._ea(r, width)
        return struct.unpack_from(fmt, self.inst.mem, a)[0]

    def _store(self, r: _Reader, fmt: str, width: int, mask=None) -> None:
        # operands are [addr, value]: pop value, then _ea pops addr
        val = self.stack.pop()
        a = self._ea(r, width)
        if mask is not None:
            val &= mask
        struct.pack_into(fmt, self.inst.mem, a, val)

    def _block_type(self, r: _Reader) -> int:
        bt = r.sleb(33)
        if bt == -0x40:
            return 0               # empty
        if bt < 0:
            return 1               # one value type
        raise WasmDecodeError("type-index block signatures not supported")

    def run_block(self, r: _Reader, end_pos: int, arity: int = 0,
                  is_loop: bool = False, loop_start: int = 0) -> str:
        """Execute instructions until the block's end. A _Branch(0)
        targeting this block either exits it (block/if) or restarts it
        (loop); `end_pos` (index just after the matching end byte, from
        the ctrl map) is where an exit lands. Returns "end" or "else"
        (an else at this block's level was consumed — only possible for
        an if's then-branch).

        Branch stack discipline (spec 4.4.8.6): the TARGET label keeps
        the top `arity` operands and drops everything pushed since
        block entry; intermediate labels the branch passes through
        leave the stack alone (their junk is below the target's base
        and removed by the target's truncation). A loop label has
        arity 0 (MVP: no block params), which also keeps the operand
        stack bounded across iterations."""
        base = len(self.stack)
        while True:
            try:
                return self._run_until_end(r)
            except _Branch as br:
                if br.depth > 0:
                    r.i = end_pos
                    raise _Branch(br.depth - 1)
                if is_loop:
                    del self.stack[base:]
                    r.i = loop_start
                    continue
                if arity:
                    keep = self.stack[len(self.stack) - arity:]
                    del self.stack[base:]
                    self.stack.extend(keep)
                else:
                    del self.stack[base:]
                r.i = end_pos
                return "end"

    # ---- the interpreter loop
    def _run_until_end(self, r: _Reader) -> str:
        inst = self.inst
        stack = self.stack
        mem = inst.mem
        while True:
            inst.fuel -= 1
            if inst.fuel <= 0:
                raise WasmTrap("out of fuel")
            op = r.u8()

            # control
            if op == 0x0B:                       # end
                return "end"
            elif op == 0x01:                     # nop
                pass
            elif op == 0x00:
                raise WasmTrap("unreachable executed")
            elif op == 0x02:                     # block
                _, end_pos = self.cmap[r.i - 1]
                arity = self._block_type(r)
                self.run_block(r, end_pos, arity)
            elif op == 0x03:                     # loop
                _, end_pos = self.cmap[r.i - 1]
                self._block_type(r)
                self.run_block(r, end_pos, is_loop=True, loop_start=r.i)
            elif op == 0x04:                     # if
                else_pos, end_pos = self.cmap[r.i - 1]
                arity = self._block_type(r)
                cond = stack.pop()
                if cond:
                    if self.run_block(r, end_pos, arity) == "else":
                        # then-branch done; jump over the else arm
                        r.i = end_pos
                else:
                    if else_pos is None:
                        r.i = end_pos
                    else:
                        r.i = else_pos
                        self.run_block(r, end_pos, arity)
            elif op == 0x05:                     # else: end of then-branch
                return "else"
            elif op == 0x0C:                     # br
                raise _Branch(r.uleb())
            elif op == 0x0D:                     # br_if
                d = r.uleb()
                if stack.pop():
                    raise _Branch(d)
            elif op == 0x0E:                     # br_table
                n = r.uleb()
                targets = [r.uleb() for _ in range(n)]
                default = r.uleb()
                k = stack.pop()
                raise _Branch(targets[k] if 0 <= k < n else default)
            elif op == 0x0F:                     # return
                raise _Return()
            elif op == 0x10:                     # call
                fi = r.uleb()
                self._do_call(fi)
            elif op == 0x11:                     # call_indirect
                ti = r.uleb()
                r.u8()                           # table idx (0)
                k = stack.pop()
                if k < 0 or k >= len(inst.table) or inst.table[k] is None:
                    raise WasmTrap("undefined table element")
                fi = inst.table[k]
                want = inst.module.types[ti]
                have = inst._func_type(fi)
                if (have.params, have.results) != (want.params,
                                                   want.results):
                    raise WasmTrap("indirect call type mismatch")
                self._do_call(fi)

            # parametric
            elif op == 0x1A:                     # drop
                stack.pop()
            elif op == 0x1B:                     # select
                c = stack.pop()
                b = stack.pop()
                a = stack.pop()
                stack.append(a if c else b)

            # variables
            elif op == 0x20:
                stack.append(self.locals[r.uleb()])
            elif op == 0x21:
                self.locals[r.uleb()] = stack.pop()
            elif op == 0x22:
                self.locals[r.uleb()] = stack[-1]
            elif op == 0x23:
                stack.append(inst.globals[r.uleb()][2])
            elif op == 0x24:
                g = inst.globals[r.uleb()]
                if not g[1]:
                    raise WasmTrap("set of immutable global")
                g[2] = stack.pop()

            # memory
            elif op == 0x28:
                stack.append(self._load(r, "<I", 4))
            elif op == 0x29:
                stack.append(self._load(r, "<Q", 8))
            elif op == 0x2A:
                stack.append(self._load(r, "<f", 4))
            elif op == 0x2B:
                stack.append(self._load(r, "<d", 8))
            elif op == 0x2C:
                stack.append(self._load(r, "<b", 1) & _U32)
            elif op == 0x2D:
                stack.append(self._load(r, "<B", 1))
            elif op == 0x2E:
                stack.append(self._load(r, "<h", 2) & _U32)
            elif op == 0x2F:
                stack.append(self._load(r, "<H", 2))
            elif op == 0x30:
                stack.append(self._load(r, "<b", 1) & _U64)
            elif op == 0x31:
                stack.append(self._load(r, "<B", 1))
            elif op == 0x32:
                stack.append(self._load(r, "<h", 2) & _U64)
            elif op == 0x33:
                stack.append(self._load(r, "<H", 2))
            elif op == 0x34:
                stack.append(self._load(r, "<i", 4) & _U64)
            elif op == 0x35:
                stack.append(self._load(r, "<I", 4))
            elif op == 0x36:
                self._store(r, "<I", 4, _U32)
            elif op == 0x37:
                self._store(r, "<Q", 8, _U64)
            elif op == 0x38:
                val = _f32(stack.pop())
                struct.pack_into("<f", mem, self._ea(r, 4), val)
            elif op == 0x39:
                val = stack.pop()
                struct.pack_into("<d", mem, self._ea(r, 8), val)
            elif op == 0x3A:
                self._store(r, "<B", 1, 0xFF)
            elif op == 0x3B:
                self._store(r, "<H", 2, 0xFFFF)
            elif op == 0x3C:
                self._store(r, "<B", 1, 0xFF)
            elif op == 0x3D:
                self._store(r, "<H", 2, 0xFFFF)
            elif op == 0x3E:
                self._store(r, "<I", 4, _U32)
            elif op == 0x3F:                     # memory.size
                r.u8()
                stack.append(len(mem) // PAGE)
            elif op == 0x40:                     # memory.grow
                r.u8()
                delta = stack.pop()
                cur = len(mem) // PAGE
                if delta < 0 or cur + delta > inst._mem_max:
                    stack.append(_U32)           # -1: refused
                else:
                    inst.mem.extend(b"\x00" * (delta * PAGE))
                    mem = inst.mem
                    stack.append(cur)

            # constants
            elif op == 0x41:
                stack.append(r.sleb(32) & _U32)
            elif op == 0x42:
                stack.append(r.sleb(64) & _U64)
            elif op == 0x43:
                stack.append(r.f32())
            elif op == 0x44:
                stack.append(r.f64())

            # i32 compare
            elif 0x45 <= op <= 0x4F:
                self._i32_cmp(op)
            elif 0x50 <= op <= 0x5A:
                self._i64_cmp(op)
            elif 0x5B <= op <= 0x60:
                self._f_cmp(op - 0x5B)
            elif 0x61 <= op <= 0x66:
                self._f_cmp(op - 0x61)

            # i32 arith
            elif 0x67 <= op <= 0x78:
                self._i32_arith(op)
            elif 0x79 <= op <= 0x8A:
                self._i64_arith(op)
            elif 0x8B <= op <= 0x98:
                self._f32_arith(op)
            elif 0x99 <= op <= 0xA6:
                self._f64_arith(op)

            # conversions
            elif 0xA7 <= op <= 0xC4:
                self._convert(op)

            elif op == 0xFC:                     # saturating truncs
                sub = r.uleb()
                self._sat_trunc(sub)
            else:
                raise WasmDecodeError(f"unsupported opcode {op:#x}")

    def _do_call(self, fi: int) -> None:
        inst = self.inst
        ftype = inst._func_type(fi)
        n = len(ftype.params)
        args = self.stack[len(self.stack) - n:] if n else []
        del self.stack[len(self.stack) - n:]
        res = inst._call_function(fi, args, self.depth + 1)
        self.stack.extend(res)

    # ---- numeric families
    def _i32_cmp(self, op: int) -> None:
        s = self.stack
        if op == 0x45:                                   # eqz
            s.append(1 if s.pop() == 0 else 0)
            return
        b = s.pop()
        a = s.pop()
        if op == 0x46:
            v = a == b
        elif op == 0x47:
            v = a != b
        elif op == 0x49:
            v = a < b
        elif op == 0x4B:
            v = a > b
        elif op == 0x4D:
            v = a <= b
        elif op == 0x4F:
            v = a >= b
        else:                       # signed variants
            sa, sb = _s32(a), _s32(b)
            if op == 0x48:
                v = sa < sb
            elif op == 0x4A:
                v = sa > sb
            elif op == 0x4C:
                v = sa <= sb
            else:                   # 0x4E
                v = sa >= sb
        s.append(1 if v else 0)

    def _i64_cmp(self, op: int) -> None:
        s = self.stack
        if op == 0x50:
            s.append(1 if s.pop() == 0 else 0)
            return
        b = s.pop()
        a = s.pop()
        if op == 0x51:
            v = a == b
        elif op == 0x52:
            v = a != b
        elif op == 0x54:
            v = a < b
        elif op == 0x56:
            v = a > b
        elif op == 0x58:
            v = a <= b
        elif op == 0x5A:
            v = a >= b
        else:
            sa, sb = _s64(a), _s64(b)
            if op == 0x53:
                v = sa < sb
            elif op == 0x55:
                v = sa > sb
            elif op == 0x57:
                v = sa <= sb
            else:                   # 0x59
                v = sa >= sb
        s.append(1 if v else 0)

    def _f_cmp(self, k: int) -> None:
        s = self.stack
        b = s.pop()
        a = s.pop()
        if math.isnan(a) or math.isnan(b):
            v = (k == 1)                                  # only ne is true
        elif k == 0:
            v = a == b
        elif k == 1:
            v = a != b
        elif k == 2:
            v = a < b
        elif k == 3:
            v = a > b
        elif k == 4:
            v = a <= b
        else:
            v = a >= b
        s.append(1 if v else 0)

    def _i32_arith(self, op: int) -> None:
        s = self.stack
        if op == 0x67:                                   # clz
            v = s.pop()
            s.append(32 if v == 0 else 31 - v.bit_length() + 1)
            return
        if op == 0x68:                                   # ctz
            v = s.pop()
            s.append(32 if v == 0 else (v & -v).bit_length() - 1)
            return
        if op == 0x69:                                   # popcnt
            s.append(bin(s.pop()).count("1"))
            return
        b = s.pop()
        a = s.pop()
        if op == 0x6A:
            r = a + b
        elif op == 0x6B:
            r = a - b
        elif op == 0x6C:
            r = a * b
        elif op == 0x6D:                                 # div_s
            sa, sb = _s32(a), _s32(b)
            if sb == 0:
                raise WasmTrap("integer divide by zero")
            q = abs(sa) // abs(sb)
            r = q if (sa < 0) == (sb < 0) else -q
            if r == 1 << 31:
                raise WasmTrap("integer overflow")
        elif op == 0x6E:                                 # div_u
            if b == 0:
                raise WasmTrap("integer divide by zero")
            r = a // b
        elif op == 0x6F:                                 # rem_s
            sa, sb = _s32(a), _s32(b)
            if sb == 0:
                raise WasmTrap("integer divide by zero")
            r = abs(sa) % abs(sb)
            if sa < 0:
                r = -r
        elif op == 0x70:                                 # rem_u
            if b == 0:
                raise WasmTrap("integer divide by zero")
            r = a % b
        elif op == 0x71:
            r = a & b
        elif op == 0x72:
            r = a | b
        elif op == 0x73:
            r = a ^ b
        elif op == 0x74:
            r = a << (b % 32)
        elif op == 0x75:
            r = _s32(a) >> (b % 32)
        elif op == 0x76:
            r = a >> (b % 32)
        elif op == 0x77:                                 # rotl
            k = b % 32
            r = (a << k) | (a >> (32 - k)) if k else a
        elif op == 0x78:                                 # rotr
            k = b % 32
            r = (a >> k) | (a << (32 - k)) if k else a
        else:
            raise WasmDecodeError(f"bad i32 op {op:#x}")
        s.append(r & _U32)

    def _i64_arith(self, op: int) -> None:
        s = self.stack
        if op == 0x79:
            v = s.pop()
            s.append(64 if v == 0 else 64 - v.bit_length())
            return
        if op == 0x7A:
            v = s.pop()
            s.append(64 if v == 0 else (v & -v).bit_length() - 1)
            return
        if op == 0x7B:
            s.append(bin(s.pop()).count("1"))
            return
        b = s.pop()
        a = s.pop()
        if op == 0x7C:
            r = a + b
        elif op == 0x7D:
            r = a - b
        elif op == 0x7E:
            r = a * b
        elif op == 0x7F:
            sa, sb = _s64(a), _s64(b)
            if sb == 0:
                raise WasmTrap("integer divide by zero")
            q = abs(sa) // abs(sb)
            r = q if (sa < 0) == (sb < 0) else -q
            if r == 1 << 63:
                raise WasmTrap("integer overflow")
        elif op == 0x80:
            if b == 0:
                raise WasmTrap("integer divide by zero")
            r = a // b
        elif op == 0x81:
            sa, sb = _s64(a), _s64(b)
            if sb == 0:
                raise WasmTrap("integer divide by zero")
            r = abs(sa) % abs(sb)
            if sa < 0:
                r = -r
        elif op == 0x82:
            if b == 0:
                raise WasmTrap("integer divide by zero")
            r = a % b
        elif op == 0x83:
            r = a & b
        elif op == 0x84:
            r = a | b
        elif op == 0x85:
            r = a ^ b
        elif op == 0x86:
            r = a << (b % 64)
        elif op == 0x87:
            r = _s64(a) >> (b % 64)
        elif op == 0x88:
            r = a >> (b % 64)
        elif op == 0x89:
            k = b % 64
            r = (a << k) | (a >> (64 - k)) if k else a
        elif op == 0x8A:
            k = b % 64
            r = (a >> k) | (a << (64 - k)) if k else a
        else:
            raise WasmDecodeError(f"bad i64 op {op:#x}")
        s.append(r & _U64)

    def _f32_arith(self, op: int) -> None:
        self._f_arith(op - 0x8B, f32=True)

    def _f64_arith(self, op: int) -> None:
        self._f_arith(op - 0x99, f32=False)

    def _f_arith(self, k: int, f32: bool) -> None:
        s = self.stack
        if k <= 6:                                       # unary
            a = s.pop()
            if k == 0:
                r = abs(a)
            elif k == 1:
                r = -a
            elif k == 2:
                r = math.ceil(a) if not math.isnan(a) and not \
                    math.isinf(a) else a
            elif k == 3:
                r = math.floor(a) if not math.isnan(a) and not \
                    math.isinf(a) else a
            elif k == 4:
                r = math.trunc(a) if not math.isnan(a) and not \
                    math.isinf(a) else a
            elif k == 5:                                 # nearest
                if math.isnan(a) or math.isinf(a):
                    r = a
                else:
                    f = math.floor(a)
                    d = a - f
                    if d < 0.5:
                        r = f
                    elif d > 0.5:
                        r = f + 1
                    else:
                        r = f if f % 2 == 0 else f + 1
                r = float(r)
            else:
                if a < 0:
                    r = math.nan
                else:
                    r = math.sqrt(a)
            s.append(_f32(r) if f32 else float(r))
            return
        b = s.pop()
        a = s.pop()
        if k == 7:
            r = a + b
        elif k == 8:
            r = a - b
        elif k == 9:
            r = a * b
        elif k == 10:
            if b == 0:
                r = math.nan if a == 0 or math.isnan(a) else \
                    math.copysign(math.inf, a) * math.copysign(1.0, b)
            else:
                r = a / b
        elif k == 11:   # min: NaN propagates (spec 4.3.3)
            r = a if math.isnan(a) else b if math.isnan(b) else min(a, b)
        elif k == 12:
            r = a if math.isnan(a) else b if math.isnan(b) else max(a, b)
        else:                                            # copysign
            r = math.copysign(a, b)
        s.append(_f32(r) if f32 else float(r))

    def _convert(self, op: int) -> None:
        s = self.stack
        a = s.pop()
        if op == 0xA7:                                   # i32.wrap_i64
            s.append(a & _U32)
        elif op == 0xA8:
            s.append(_trunc(a, -(1 << 31), (1 << 31) - 1, 32, False))
        elif op == 0xA9:
            s.append(_trunc(a, 0, _U32, 32, False))
        elif op == 0xAA:
            s.append(_trunc(a, -(1 << 31), (1 << 31) - 1, 32, False))
        elif op == 0xAB:
            s.append(_trunc(a, 0, _U32, 32, False))
        elif op == 0xAC:                                 # i64.extend_i32_s
            s.append(_s32(a) & _U64)
        elif op == 0xAD:
            s.append(a & _U32)
        elif op == 0xAE:
            s.append(_trunc(a, -(1 << 63), (1 << 63) - 1, 64, False))
        elif op == 0xAF:
            s.append(_trunc(a, 0, _U64, 64, False))
        elif op == 0xB0:
            s.append(_trunc(a, -(1 << 63), (1 << 63) - 1, 64, False))
        elif op == 0xB1:
            s.append(_trunc(a, 0, _U64, 64, False))
        elif op == 0xB2:
            s.append(_f32(float(_s32(a))))
        elif op == 0xB3:
            s.append(_f32(float(a)))
        elif op == 0xB4:
            s.append(_f32(float(_s64(a))))
        elif op == 0xB5:
            s.append(_f32(float(a)))
        elif op == 0xB6:                                 # f32.demote
            s.append(_f32(a))
        elif op == 0xB7:
            s.append(float(_s32(a)))
        elif op == 0xB8:
            s.append(float(a))
        elif op == 0xB9:
            s.append(float(_s64(a)))
        elif op == 0xBA:
            s.append(float(a))
        elif op == 0xBB:                                 # f64.promote
            s.append(float(a))
        elif op == 0xBC:                                 # i32.reinterpret_f32
            s.append(struct.unpack("<I", struct.pack("<f", a))[0])
        elif op == 0xBD:
            s.append(struct.unpack("<Q", struct.pack("<d", a))[0])
        elif op == 0xBE:
            s.append(struct.unpack("<f", struct.pack("<I", a))[0])
        elif op == 0xBF:
            s.append(struct.unpack("<d", struct.pack("<Q", a))[0])
        elif op == 0xC0:                                 # i32.extend8_s
            s.append((_s32(a << 24) >> 24) & _U32)
        elif op == 0xC1:
            s.append((_s32(a << 16) >> 16) & _U32)
        elif op == 0xC2:
            s.append((_s64(a << 56) >> 56) & _U64)
        elif op == 0xC3:
            s.append((_s64(a << 48) >> 48) & _U64)
        elif op == 0xC4:
            s.append((_s64(a << 32) >> 32) & _U64)
        else:
            raise WasmDecodeError(f"bad conversion op {op:#x}")

    def _sat_trunc(self, sub: int) -> None:
        s = self.stack
        a = s.pop()
        if sub == 0:
            s.append(_trunc(a, -(1 << 31), (1 << 31) - 1, 32, True))
        elif sub == 1:
            s.append(_trunc(a, 0, _U32, 32, True))
        elif sub == 2:
            s.append(_trunc(a, -(1 << 31), (1 << 31) - 1, 32, True))
        elif sub == 3:
            s.append(_trunc(a, 0, _U32, 32, True))
        elif sub == 4:
            s.append(_trunc(a, -(1 << 63), (1 << 63) - 1, 64, True))
        elif sub == 5:
            s.append(_trunc(a, 0, _U64, 64, True))
        elif sub == 6:
            s.append(_trunc(a, -(1 << 63), (1 << 63) - 1, 64, True))
        elif sub == 7:
            s.append(_trunc(a, 0, _U64, 64, True))
        else:
            raise WasmDecodeError(f"unsupported 0xFC subop {sub}")


def _skip_immediates(r: _Reader, op: int) -> None:
    """Skip an instruction's immediates without executing (used when
    scanning for block ends)."""
    if op in (0x0C, 0x0D, 0x10, 0x20, 0x21, 0x22, 0x23, 0x24):
        r.uleb()
    elif op == 0x0E:
        n = r.uleb()
        for _ in range(n + 1):
            r.uleb()
    elif op == 0x11:
        r.uleb()
        r.u8()
    elif 0x28 <= op <= 0x3E:
        r.uleb()
        r.uleb()
    elif op in (0x3F, 0x40):
        r.u8()
    elif op == 0x41:
        r.sleb(32)
    elif op == 0x42:
        r.sleb(64)
    elif op == 0x43:
        r.bytes(4)
    elif op == 0x44:
        r.bytes(8)
    elif op == 0xFC:
        r.uleb()
    # all other MVP opcodes have no immediates
