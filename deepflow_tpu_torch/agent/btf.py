"""Minimal kernel-BTF reader: struct member offsets from the kernel's
own type descriptions.

Why: pre-1.17 (stack-ABI) Go keeps the current g in thread-local
storage at %fs:-8, not in R14. An eBPF program can reach it as
*(task->thread.fsbase - 8) — but task_struct's layout varies per
kernel build, so the `thread.fsbase` offset must be discovered at
runtime. The reference ships a whole kernel-adaption layer for this
class of problem (agent/src/ebpf/user/offset.c and its per-kernel
tables); here the kernel itself supplies the answer through
/sys/kernel/btf/vmlinux, which every BTF-enabled kernel (the same
kernels whose verifier this suite targets) exposes.

This is deliberately NOT a general BTF library: one linear pass over
the type section, remembering only named struct/union positions, then
member lookups on demand. The encoding walked here is the stable BTF
core (Documentation/bpf/btf.rst): a 24-byte header, then type records
of {name_off, info, size|type} u32 triples plus kind-specific
trailers.

The port's own copy of the JAX package's `agent/btf.py` (host code;
the port imports nothing of that package)."""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

BTF_PATH = "/sys/kernel/btf/vmlinux"

_KIND_INT = 1
_KIND_ARRAY = 3
_KIND_STRUCT = 4
_KIND_UNION = 5
_KIND_ENUM = 6
_KIND_FUNC_PROTO = 13
_KIND_VAR = 14
_KIND_DATASEC = 15
_KIND_DECL_TAG = 17
_KIND_ENUM64 = 19


class Btf:
    """Parsed-enough view of one BTF blob."""

    def __init__(self, data: bytes) -> None:
        (magic, _version, _flags, hdr_len, type_off, type_len,
         str_off, str_len) = struct.unpack_from("<HBBIIIII", data, 0)
        if magic != 0xEB9F:
            raise ValueError(f"not BTF (magic {magic:#x})")
        self._data = data
        self._str_base = hdr_len + str_off
        self._str_end = self._str_base + str_len
        # name -> list of (kind, body offset, vlen, kind_flag) for
        # struct/union types (duplicates happen: forward decls, per-CU)
        self._structs: Dict[str, List[Tuple[int, int, int, int]]] = {}
        self._index(hdr_len + type_off, type_len)

    def _name(self, off: int) -> str:
        if off == 0:
            return ""
        p = self._str_base + off
        end = self._data.index(b"\0", p, self._str_end)
        return self._data[p:end].decode("utf-8", "replace")

    def _index(self, pos: int, length: int) -> None:
        data, end = self._data, pos + length
        while pos + 12 <= end:
            name_off, info, _size = struct.unpack_from("<III", data, pos)
            kind = (info >> 24) & 0x1F
            vlen = info & 0xFFFF
            kind_flag = (info >> 31) & 1
            body = pos + 12
            if kind in (_KIND_STRUCT, _KIND_UNION):
                nm = self._name(name_off)
                if nm:
                    self._structs.setdefault(nm, []).append(
                        (kind, body, vlen, kind_flag))
                pos = body + 12 * vlen
            elif kind == _KIND_INT:
                pos = body + 4
            elif kind == _KIND_ARRAY:
                pos = body + 12
            elif kind == _KIND_ENUM:
                pos = body + 8 * vlen
            elif kind == _KIND_ENUM64:
                pos = body + 12 * vlen
            elif kind == _KIND_FUNC_PROTO:
                pos = body + 8 * vlen
            elif kind == _KIND_VAR:
                pos = body + 4
            elif kind == _KIND_DATASEC:
                pos = body + 12 * vlen
            elif kind == _KIND_DECL_TAG:
                pos = body + 4
            else:
                pos = body

    def member_offset(self, struct_name: str,
                      member: str) -> Optional[int]:
        """Byte offset of `member` in `struct_name`, or None. Takes
        the first definition that HAS the member (forward declarations
        index with vlen 0 and never match)."""
        for kind, body, vlen, kind_flag in self._structs.get(
                struct_name, ()):
            for i in range(vlen):
                name_off, _mtype, off = struct.unpack_from(
                    "<III", self._data, body + 12 * i)
                if self._name(name_off) != member:
                    continue
                bits = (off & 0xFFFFFF) if kind_flag else off
                if bits % 8:
                    return None          # bitfield: not addressable
                return bits // 8
        return None


_CACHE: Dict[str, Optional[int]] = {}


def fsbase_offset(path: str = BTF_PATH) -> int:
    """task_struct->thread.fsbase byte offset, 0 when undiscoverable
    (no BTF / layout surprise) — 0 disables the fs-based goid path,
    never guesses."""
    if path in _CACHE:
        return _CACHE[path] or 0
    result = 0
    try:
        with open(path, "rb") as f:
            btf = Btf(f.read())
        thread = btf.member_offset("task_struct", "thread")
        fsbase = btf.member_offset("thread_struct", "fsbase")
        if thread is not None and fsbase is not None:
            result = thread + fsbase
    except (OSError, ValueError):
        result = 0
    _CACHE[path] = result
    return result
