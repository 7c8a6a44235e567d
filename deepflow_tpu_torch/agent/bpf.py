"""Pure-Python eBPF toolkit: assemble, load, attach — no libbpf.

Reference: the agent carries its OWN eBPF machinery rather than linking
libbpf — `agent/src/ebpf/user/load.c` (ELF loader/relocator) and
`tracer.c` feed programs to the kernel, and the capture path injects
BPF filters into its sockets (`dispatcher/recv_engine/mod.rs:91`).
This module is that machinery's clean-room, container-runnable core:

- an eBPF instruction ASSEMBLER (`Asm`) with symbolic jump labels —
  the role load.c's ELF section parsing plays, except programs are
  built directly as instruction lists (no compiler toolchain needed);
- `Map`: BPF_MAP_CREATE / lookup / update over the bpf(2) syscall;
- `load`: BPF_PROG_LOAD with the kernel VERIFIER log surfaced on
  rejection (the verifier is the contract — a program that loads here
  is kernel-checked, not merely syntax-checked);
- `attach_socket`: SO_ATTACH_BPF — kernel-side filtering ON the
  capture socket, the recv_engine filter-injection parity. Filtered
  packets never cross into userspace; per-verdict counters live in a
  BPF array map both kernel and userspace touch.

Kprobe/XDP program types LOAD on this kernel too. Attach capability is
probed per PMU: the kprobe PMU is masked in many containers (the
socket-trace KERNEL datapath stays fixture-driven there,
agent/ebpf_source.py), but the UPROBE PMU is exposed — the TLS uprobe
suite (agent/uprobe_trace.py + agent/perf_ring.py) attaches for real
and its tests exercise program execution in the kernel end to end.

Layout note (linux/bpf.h): one insn = u8 opcode, u8 dst:4|src:4,
s16 off, s32 imm, little-endian; dual-insn LD_IMM64 for map fds.

The port's own copy of the JAX package's `agent/bpf.py` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import ctypes
import os
import socket
import struct
from typing import Dict, List, Optional, Tuple

_libc = ctypes.CDLL(None, use_errno=True)
# bpf(2) syscall number is per-architecture; None = unsupported here
# (available() then reports False instead of invoking a wrong syscall)
_NR_BPF = {"x86_64": 321, "aarch64": 280, "riscv64": 280,
           "s390x": 351, "ppc64le": 361}.get(__import__("platform")
                                             .machine())
SO_ATTACH_BPF = 50
SO_DETACH_FILTER = 27

# bpf(2) commands
BPF_MAP_CREATE = 0
BPF_MAP_LOOKUP_ELEM = 1
BPF_MAP_UPDATE_ELEM = 2
BPF_MAP_DELETE_ELEM = 3
BPF_PROG_LOAD = 5

# program / map types
BPF_PROG_TYPE_SOCKET_FILTER = 1
BPF_PROG_TYPE_KPROBE = 2
BPF_PROG_TYPE_XDP = 6
BPF_MAP_TYPE_HASH = 1
BPF_MAP_TYPE_ARRAY = 2
BPF_MAP_TYPE_PERF_EVENT_ARRAY = 4
BPF_MAP_TYPE_LRU_HASH = 9

# opcode classes / fields (linux/bpf_common.h + bpf.h)
BPF_LD, BPF_LDX, BPF_ST, BPF_STX = 0x00, 0x01, 0x02, 0x03
BPF_ALU, BPF_JMP, BPF_ALU64 = 0x04, 0x05, 0x07
BPF_W, BPF_H, BPF_B, BPF_DW = 0x00, 0x08, 0x10, 0x18
BPF_IMM, BPF_ABS, BPF_MEM = 0x00, 0x20, 0x60
BPF_ATOMIC = 0xc0
BPF_FETCH = 0x01
BPF_ADD, BPF_SUB, BPF_AND, BPF_OR = 0x00, 0x10, 0x50, 0x40
BPF_LSH, BPF_RSH, BPF_ARSH = 0x60, 0x70, 0xc0
BPF_MOV = 0xb0
BPF_JA, BPF_JEQ, BPF_JNE, BPF_JGT, BPF_JGE = 0x00, 0x10, 0x50, 0x20, 0x30
BPF_JLT, BPF_JLE, BPF_JSET = 0xa0, 0xb0, 0x40
BPF_JSGT, BPF_JSLE = 0x60, 0xd0
BPF_K, BPF_X = 0x00, 0x08
BPF_EXIT, BPF_CALL = 0x90, 0x80
# helpers (uapi/linux/bpf.h __BPF_FUNC_MAPPER order)
FN_map_lookup_elem = 1
FN_map_update_elem = 2
FN_map_delete_elem = 3
FN_probe_read = 4
FN_ktime_get_ns = 5
FN_get_current_pid_tgid = 14
FN_get_current_comm = 16
FN_perf_event_output = 25
FN_get_current_task = 35
# registers
R0, R1, R2, R3, R4, R5, R6, R7, R8, R9, R10 = range(11)


def _bpf(cmd: int, attr: bytes) -> int:
    if _NR_BPF is None:
        raise OSError(38, "bpf(2) syscall number unknown for this "
                      "architecture")
    buf = ctypes.create_string_buffer(attr, max(len(attr), 128))
    r = _libc.syscall(_NR_BPF, cmd, buf, len(buf))
    if r < 0:
        err = ctypes.get_errno()
        raise OSError(err, os.strerror(err))
    return r


def _insn(op: int, dst: int, src: int, off: int, imm: int) -> bytes:
    # fold unsigned-intent immediates into the signed s32 field the
    # wire format uses (0xFFFFFFFF must encode as -1, not overflow)
    imm &= 0xFFFFFFFF
    if imm >= 1 << 31:
        imm -= 1 << 32
    return struct.pack("<BBhi", op & 0xFF, (src << 4) | dst, off, imm)


class Map:
    """A BPF map over the bpf(2) syscall. Default shape is the original
    BPF_MAP_TYPE_ARRAY of u64 (counters, config cells); HASH maps take
    byte keys (`*_bytes` accessors) and PERF_EVENT_ARRAY carries the
    kernel->user record stream (values written by the kernel only)."""

    def __init__(self, max_entries: int, value_size: int = 8,
                 map_type: int = BPF_MAP_TYPE_ARRAY,
                 key_size: int = 4) -> None:
        self.map_type = map_type
        self.key_size = key_size
        self.value_size = value_size
        self.max_entries = max_entries
        self.fd = _bpf(BPF_MAP_CREATE,
                       struct.pack("<IIII", map_type, key_size,
                                   value_size, max_entries))

    def _key_buf(self, key) -> "ctypes.Array":
        if isinstance(key, int):
            key = key.to_bytes(self.key_size, "little")
        if len(key) != self.key_size:
            raise ValueError(f"key is {len(key)}B, map wants "
                             f"{self.key_size}B")
        return ctypes.create_string_buffer(key, self.key_size)

    def _elem_attr(self, key, value_buf) -> bytes:
        kb = self._key_buf(key)
        # bpf_attr for *_ELEM: map_fd u32, pad, key u64ptr, value u64ptr
        self._keep = (kb, value_buf)      # keep buffers alive over syscall
        return struct.pack("<IIQQQ", self.fd, 0, ctypes.addressof(kb),
                           ctypes.addressof(value_buf) if value_buf
                           is not None else 0, 0)

    def lookup(self, key) -> int:
        vb = ctypes.create_string_buffer(self.value_size)
        _bpf(BPF_MAP_LOOKUP_ELEM, self._elem_attr(key, vb))
        return struct.unpack("<Q", vb.raw[:8])[0] if self.value_size == 8 \
            else int.from_bytes(vb.raw, "little")

    def lookup_bytes(self, key) -> bytes:
        vb = ctypes.create_string_buffer(self.value_size)
        _bpf(BPF_MAP_LOOKUP_ELEM, self._elem_attr(key, vb))
        return vb.raw[:self.value_size]

    def update(self, key, value: int) -> None:
        vb = ctypes.create_string_buffer(
            value.to_bytes(self.value_size, "little"), self.value_size)
        _bpf(BPF_MAP_UPDATE_ELEM, self._elem_attr(key, vb))

    def update_bytes(self, key, value: bytes) -> None:
        if len(value) != self.value_size:
            raise ValueError(f"value is {len(value)}B, map wants "
                             f"{self.value_size}B")
        vb = ctypes.create_string_buffer(value, self.value_size)
        _bpf(BPF_MAP_UPDATE_ELEM, self._elem_attr(key, vb))

    def delete(self, key) -> bool:
        """True if the key existed (ENOENT = False, other errors raise)."""
        try:
            _bpf(BPF_MAP_DELETE_ELEM, self._elem_attr(key, None))
            return True
        except OSError as e:
            if e.errno == 2:                      # ENOENT
                return False
            raise

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


class Asm:
    """eBPF assembler with symbolic jump labels."""

    def __init__(self) -> None:
        self._insns: List[Tuple] = []    # (kind, payload)
        self._labels: Dict[str, int] = {}

    # -- positions (LD_IMM64 occupies two slots) ---------------------------
    def _pos(self) -> int:
        return sum(2 if k == "ld64" else 1 for k, _ in self._insns)

    def label(self, name: str) -> "Asm":
        self._labels[name] = self._pos()
        return self

    def references(self, name: str) -> bool:
        """Is any jump targeting this label? (Dead blocks must not be
        assembled: the verifier rejects unreachable instructions.)"""
        return any(k == "jmp" and p[3] == name for k, p in self._insns)

    # -- instructions ------------------------------------------------------
    def mov_imm(self, dst: int, imm: int) -> "Asm":
        self._insns.append(("raw", _insn(BPF_ALU64 | BPF_MOV | BPF_K,
                                         dst, 0, 0, imm)))
        return self

    def mov_reg(self, dst: int, src: int) -> "Asm":
        self._insns.append(("raw", _insn(BPF_ALU64 | BPF_MOV | BPF_X,
                                         dst, src, 0, 0)))
        return self

    def mov32_imm(self, dst: int, imm: int) -> "Asm":
        """32-bit MOV: zero-extends — the only way to build constants
        like BPF_F_CURRENT_CPU (0xFFFFFFFF) without sign-extension."""
        self._insns.append(("raw", _insn(BPF_ALU | BPF_MOV | BPF_K,
                                         dst, 0, 0, imm)))
        return self

    def jmp_reg(self, op: int, dst: int, src: int, label: str) -> "Asm":
        self._insns.append(("jmp", (BPF_JMP | op | BPF_X, dst, src,
                                    label, 0)))
        return self

    def alu_imm(self, op: int, dst: int, imm: int) -> "Asm":
        self._insns.append(("raw", _insn(BPF_ALU64 | op | BPF_K,
                                         dst, 0, 0, imm)))
        return self

    def alu_reg(self, op: int, dst: int, src: int) -> "Asm":
        self._insns.append(("raw", _insn(BPF_ALU64 | op | BPF_X,
                                         dst, src, 0, 0)))
        return self

    def ld_abs(self, size: int, off: int) -> "Asm":
        """Legacy absolute packet load into R0 (socket-filter class:
        implicitly reads skb from R6)."""
        self._insns.append(("raw", _insn(BPF_LD | BPF_ABS | size,
                                         0, 0, 0, off)))
        return self

    def ldx_mem(self, size: int, dst: int, src: int, off: int) -> "Asm":
        self._insns.append(("raw", _insn(BPF_LDX | BPF_MEM | size,
                                         dst, src, off, 0)))
        return self

    def stx_mem(self, size: int, dst: int, src: int, off: int) -> "Asm":
        self._insns.append(("raw", _insn(BPF_STX | BPF_MEM | size,
                                         dst, src, off, 0)))
        return self

    def st_imm(self, size: int, dst: int, off: int, imm: int) -> "Asm":
        self._insns.append(("raw", _insn(BPF_ST | BPF_MEM | size,
                                         dst, 0, off, imm)))
        return self

    def atomic_add(self, size: int, dst: int, src: int,
                   off: int) -> "Asm":
        """*(dst + off) += src, atomically (BPF_ATOMIC | BPF_ADD)."""
        self._insns.append(("raw", _insn(BPF_STX | BPF_ATOMIC | size,
                                         dst, src, off, BPF_ADD)))
        return self

    def atomic_fetch_add(self, size: int, dst: int, src: int,
                         off: int) -> "Asm":
        """src = fetch_add(*(dst + off), src) — the OLD value lands in
        src, making read-modify-write one atomic op (BPF_FETCH)."""
        self._insns.append(("raw", _insn(BPF_STX | BPF_ATOMIC | size,
                                         dst, src, off,
                                         BPF_ADD | BPF_FETCH)))
        return self

    def ld_map_fd(self, dst: int, map_: Map) -> "Asm":
        self._insns.append(("ld64", (dst, map_.fd)))
        return self

    def call(self, fn: int) -> "Asm":
        self._insns.append(("raw", _insn(BPF_JMP | BPF_CALL, 0, 0, 0, fn)))
        return self

    def jmp(self, label: str) -> "Asm":
        self._insns.append(("jmp", (BPF_JMP | BPF_JA, 0, 0, label, 0)))
        return self

    def jmp_imm(self, op: int, reg: int, imm: int, label: str) -> "Asm":
        self._insns.append(("jmp", (BPF_JMP | op | BPF_K, reg, 0,
                                    label, imm)))
        return self

    def exit_imm(self, imm: int) -> "Asm":
        """mov r0, imm; exit."""
        return self.mov_imm(R0, imm).exit()

    def exit(self) -> "Asm":
        self._insns.append(("raw", _insn(BPF_JMP | BPF_EXIT, 0, 0, 0, 0)))
        return self

    # -- assembly ----------------------------------------------------------
    def assemble(self) -> bytes:
        out, pos = [], 0
        for kind, payload in self._insns:
            if kind == "raw":
                out.append(payload)
                pos += 1
            elif kind == "ld64":
                dst, fd = payload
                # BPF_PSEUDO_MAP_FD = 1 in src field
                out.append(_insn(BPF_LD | BPF_DW | BPF_IMM, dst, 1, 0, fd))
                out.append(_insn(0, 0, 0, 0, 0))
                pos += 2
            else:
                op, reg, src, label, imm = payload
                if label not in self._labels:
                    raise ValueError(f"undefined label {label!r}")
                off = self._labels[label] - pos - 1
                out.append(_insn(op, reg, src, off, imm))
                pos += 1
        return b"".join(out)


class Program:
    def __init__(self, fd: int) -> None:
        self.fd = fd

    def attach_socket(self, sock: socket.socket) -> None:
        sock.setsockopt(socket.SOL_SOCKET, SO_ATTACH_BPF,
                        struct.pack("<I", self.fd))

    @staticmethod
    def detach_socket(sock: socket.socket) -> None:
        sock.setsockopt(socket.SOL_SOCKET, SO_DETACH_FILTER,
                        struct.pack("<I", 0))

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


def load(insns: bytes, prog_type: int = BPF_PROG_TYPE_SOCKET_FILTER,
         license_: bytes = b"GPL") -> Program:
    """BPF_PROG_LOAD; on rejection, re-load with the verifier log and
    raise it — the verifier's reasoning is the only useful diagnostic."""
    lic = ctypes.create_string_buffer(license_)
    ib = ctypes.create_string_buffer(insns)
    n = len(insns) // 8
    attr = struct.pack("<IIQQIIQI", prog_type, n, ctypes.addressof(ib),
                       ctypes.addressof(lic), 0, 0, 0, 0)
    try:
        return Program(_bpf(BPF_PROG_LOAD, attr))
    except OSError as e:
        log = ctypes.create_string_buffer(65536)
        attr = struct.pack("<IIQQIIQI", prog_type, n,
                           ctypes.addressof(ib), ctypes.addressof(lic),
                           1, len(log), ctypes.addressof(log), 0)
        try:
            return Program(_bpf(BPF_PROG_LOAD, attr))
        except OSError:
            text = log.value.decode("utf-8", "replace").strip()
            if text:
                raise OSError(e.errno,
                              f"BPF verifier rejected program: "
                              f"{text[-2000:]}") from None
            # empty verifier log => not a verifier verdict: EPERM
            # (missing CAP_BPF/CAP_SYS_ADMIN), ENOSYS, E2BIG... —
            # surface the real errno so operators chase the right cause
            raise OSError(e.errno,
                          f"bpf(BPF_PROG_LOAD): {os.strerror(e.errno)}"
                          ) from None


# -- capture filter builder ------------------------------------------------
# skb byte layout at the socket-filter hook: frame starts at the MAC
# header for packet sockets; eth proto at 12, ipv4 proto at 23, ipv4
# header length at 14 (low nibble *4), ports follow the IP header.
CTR_SEEN, CTR_ACCEPTED = 0, 1


_PORTED_PROTOS = (6, 17, 132)      # tcp, udp, sctp carry L4 ports


def build_capture_filter(counters: Map,
                         proto: Optional[int] = None,
                         port: Optional[int] = None,
                         sample_shift: int = 0) -> Program:
    """Kernel-side capture filter (recv_engine BPF-injection parity):
    accept IPv4 packets matching `proto` (e.g. 6/17) and/or `port`
    (either direction, tcpdump semantics: the packet must be a
    port-bearing protocol and a FIRST fragment — ports in later
    fragments don't exist), pass-through for non-IPv4 when no
    constraint is set, and 1/2^sample_shift deterministic sampling on
    the ACCEPTED stream. Counters: [0] packets seen, [1] packets
    accepted — both maintained IN KERNEL via atomic adds, so userspace
    observes the filter's work without receiving the filtered packets.

    Return value semantics (socket filter): 0 = drop, >0 = bytes to
    deliver (0xFFFF = whole packet).
    """
    if port is not None and proto is not None \
            and proto not in _PORTED_PROTOS:
        raise ValueError(f"proto {proto} carries no L4 ports; "
                         "drop the port constraint")
    a = Asm()
    # prologue: R6 = skb (socket-filter convention: already in R6 for
    # ld_abs; save ctx from R1 for explicitness)
    a.mov_reg(R6, R1)

    def bump(ctr: int, label_suffix: str) -> None:
        # R0 = map_lookup(counters, key); *R0 += 1 (atomic)
        a.ld_map_fd(R1, counters)
        a.mov_reg(R2, R10)
        a.alu_imm(BPF_ADD, R2, -4)
        a.st_imm(BPF_W, R10, -4, ctr)
        a.call(FN_map_lookup_elem)
        a.jmp_imm(BPF_JEQ, R0, 0, f"skip_{label_suffix}")
        a.mov_imm(R1, 1)
        a.atomic_add(BPF_DW, R0, R1, 0)
        a.label(f"skip_{label_suffix}")

    bump(CTR_SEEN, "seen")

    # eth proto == 0x0800 (IPv4)? others: accept iff unconstrained
    a.ld_abs(BPF_H, 12)
    a.jmp_imm(BPF_JEQ, R0, 0x0800, "ipv4")
    if proto is None and port is None:
        a.jmp("accept")
    else:
        a.jmp("drop")
    a.label("ipv4")
    if proto is not None:
        a.ld_abs(BPF_B, 23)
        a.jmp_imm(BPF_JNE, R0, proto, "drop")
    if port is not None:
        if proto is None:
            # only port-bearing protocols can match a port constraint
            a.ld_abs(BPF_B, 23)
            for pp in _PORTED_PROTOS[:-1]:
                a.jmp_imm(BPF_JEQ, R0, pp, "has_ports")
            a.jmp_imm(BPF_JNE, R0, _PORTED_PROTOS[-1], "drop")
            a.label("has_ports")
        # non-first fragments carry payload where ports would sit:
        # frag_off field (bytes 20-21) & 0x1FFF must be 0
        a.ld_abs(BPF_H, 20)
        a.alu_imm(BPF_AND, R0, 0x1FFF)
        a.jmp_imm(BPF_JNE, R0, 0, "drop")
        # dynamic IHL: R7 = 14 + (ihl & 0xf) * 4
        a.ld_abs(BPF_B, 14)
        a.alu_imm(BPF_AND, R0, 0x0F)
        a.alu_imm(BPF_LSH, R0, 2)         # IHL words -> bytes
        a.alu_imm(BPF_ADD, R0, 14)
        a.mov_reg(R7, R0)
        # ports via legacy BPF_IND loads (offset register = R7)
        a._insns.append(("raw", _insn(BPF_LD | 0x40 | BPF_H, 0, R7,
                                      0, 0)))     # src port
        a.jmp_imm(BPF_JEQ, R0, port, "port_ok")
        a._insns.append(("raw", _insn(BPF_LD | 0x40 | BPF_H, 0, R7,
                                      0, 2)))     # dst port
        a.jmp_imm(BPF_JNE, R0, port, "drop")
        a.label("port_ok")
    a.jmp("accept")

    a.label("accept")
    if sample_shift > 0:
        # deterministic 1/2^k sampling on the accepted stream: keep a
        # kernel-side counter and accept when (n & mask) == 0
        a.ld_map_fd(R1, counters)
        a.mov_reg(R2, R10)
        a.alu_imm(BPF_ADD, R2, -4)
        a.st_imm(BPF_W, R10, -4, 2)       # cell 2: sample counter
        a.call(FN_map_lookup_elem)
        a.jmp_imm(BPF_JEQ, R0, 0, "deliver")
        # one atomic fetch-add: separate load+add would let two CPUs
        # observe the same count and both deliver, skewing the ratio
        a.mov_imm(R8, 1)
        a.atomic_fetch_add(BPF_DW, R0, R8, 0)
        a.alu_imm(BPF_AND, R8, (1 << sample_shift) - 1)
        a.jmp_imm(BPF_JNE, R8, 0, "drop")
    a.label("deliver")
    bump(CTR_ACCEPTED, "acc")
    a.exit_imm(0xFFFF)
    # the drop block is only assembled when something jumps to it — an
    # unconstrained filter would otherwise end in an unreachable block,
    # which the verifier rejects outright
    if a.references("drop"):
        a.label("drop")
        a.exit_imm(0)
    return load(a.assemble())


class BpfFilter:
    """Owned (counters map + program) pair for one capture socket —
    the recv_engine's injected-filter lifecycle. Attach to any source
    exposing its raw socket (`AfPacketSource._sock` /
    `TpacketV3Source._sock`); kernel-maintained counters surface
    through the source's counter chain."""

    def __init__(self, proto: Optional[int] = None,
                 port: Optional[int] = None,
                 sample_shift: int = 0) -> None:
        self.spec = {"proto": proto, "port": port,
                     "sample_shift": sample_shift}
        self.map = Map(4)
        try:
            self.prog = build_capture_filter(
                self.map, proto=proto, port=port,
                sample_shift=sample_shift)
        except BaseException:
            self.map.close()     # no orphan fd on verifier rejection
            raise

    def attach_socket(self, sock: socket.socket) -> None:
        """Attach to a raw socket — callable BEFORE bind (capture
        sources pass this as their prepare hook so no pre-attach
        packets slip into the ring unfiltered)."""
        self.prog.attach_socket(sock)

    def attach(self, source) -> None:
        self.attach_socket(source._sock)
        source.bpf = self       # counters ride the source's chain

    def counters(self) -> dict:
        return {"bpf_seen": self.map.lookup(CTR_SEEN),
                "bpf_accepted": self.map.lookup(CTR_ACCEPTED)}

    def close(self) -> None:
        self.prog.close()
        self.map.close()


def available() -> bool:
    """Can this kernel/container load + run socket-filter eBPF?"""
    m = None
    try:
        m = Map(1)
        p = load(Asm().exit_imm(0).assemble())
        p.close()
        return True
    except OSError:
        return False
    finally:
        if m is not None:
            m.close()
