"""Encrypted-traffic tracing: OpenSSL / Go-TLS uprobe suite, in-tree.

Reference: the agent's only window into HTTPS (most real traffic) is a
set of uprobes ABOVE the TLS layer, where the application's plaintext
is visible:

- `agent/src/ebpf/kernel/openssl_bpf.c:1` — uprobe/uretprobe pairs on
  SSL_read/SSL_write. Entry stashes {buf, fd} keyed pid_tgid, where fd
  is dug out of the SSL struct by probing ssl->rbio (+0x10) then
  rbio->num at the per-libssl-version offsets 0x38/0x30/0x28, taking
  the first that looks like a real fd (>2). Exit reads the return
  value, drops <=0, and submits the plaintext through the same
  process_data path as the syscall records, tagged
  DATA_SOURCE_OPENSSL_UPROBE.
- `agent/src/ebpf/kernel/go_tls_bpf.c:1` — uprobes on
  crypto/tls.(*Conn).Read/Write. Go's ABI shifted in 1.17 from stack
  args to registers (receiver AX, slice ptr BX); the fd is reached by
  walking Conn.conn (net.Conn interface) -> net.conn.fd (*netFD) ->
  pfd.Sysfd with per-binary offsets pushed by userspace into
  proc_info_map. Exits attach at the function's RET instructions
  (uretprobes are unsafe under goroutine stack moves) and read the
  byte count from AX (register ABI) or the saved entry SP + 40 (stack
  ABI). Tagged DATA_SOURCE_GO_TLS_UPROBE.
- `agent/src/ebpf/user/ssl_tracer.c:1`, `user/go_tracer.c:1`,
  `user/symbol.c:184` — userspace resolution: find libssl / the Go
  binary, resolve symbol file offsets, disassemble for RET offsets,
  detect the Go version/ABI, fill proc_info_map.

This module is that suite rebuilt on the in-tree toolkit: programs
authored in the eBPF assembler (agent/bpf.py), records emitted in the
SAME 192-byte SOCK_DATA wire image as the socket_trace suite with the
source packed in the direction word's high half (socket_trace.py's
emit_record_tail), so everything upstream — perf stream, EbpfTracer,
L7 parsing, session/trace aggregation, tempo — consumes TLS-uprobe
records with zero changes; the l7 rows come out flagged is_tls.

Userspace: ELF section/symbol/program-header readers (extending
agent/profiler.py's symbol reader with sizes + vaddr->file-offset),
the x86-64 length decoder (agent/x86_decode.py) for RET discovery, Go
buildinfo version detection, and plan_ssl/plan_go/find_libssl turning
a process or binary into an attach PLAN (UprobeSpec list + proc_info
entries) consumed by perf_ring.attach_uprobe. Attach needs the uprobe
PMU (/sys/bus/event_source/devices/uprobe) — attach_available()
probes it and the suite degrades to verifier-load + fixture replay
where it's masked. Where it is exposed, the live-attach tests attach
to a compiled stand-in libssl and drive real in-kernel captures
(plaintext + in-kernel trace chaining) through the perf ring into
EbpfTracer.

Goroutine-id keying (uprobe_base_bpf.c:1's get_current_goroutine):
register-ABI Go keeps the current g in R14, so the programs read
runtime.g.goid at the per-version offset userspace pushes in
proc_info (goid_off; 0 disables) and key the in-flight stash AND the
trace park/consume by (bit63 | tgid << 32 | goid & 0xffffffff)
instead of pid_tgid. A goroutine migrating OS threads between a
Read's entry and its RET now keeps its record and its trace chain —
the exact loss mode the pid_tgid fallback had. Bit 63 partitions goid
keys from the syscall suite's pid_tgid keys in the SHARED trace map
(a pid_tgid's high word is a tgid < 2^22, so its bit 63 is always
clear; without the partition a syscall park could be consumed by the
wrong source). Stack-ABI (pre-1.17) processes key too: g lives in
thread-local storage at %fs:-8 there, and the programs reach it as
*(task->thread.fsbase - 8) with the fsbase offset discovered from the
kernel's own BTF (agent/btf.py — the reference's kernel-adaption
offset tables, answered by the kernel itself); a kernel without BTF
pushes fsbase_off 0 and those processes fall back to pid_tgid keying
(unavailable, not faulted). With keying
enabled, a failed in-kernel goid read DROPS that call rather than
falling back — a fallback would be asymmetric across the enter/exit
pair and could pair an exit with a different call's stash
(_goid_rekey's docstring has the full argument). The stash/trace maps
are LRU: goid keys are monotonic — never naturally overwritten — so
entries abandoned between enter and exit (goroutine exits with a
parked id; panic unwinds past the RET) age out instead of filling a
plain hash map and stopping all parking process-wide.

Cross-source chaining (the reference's unified get_current_goroutine
key, uprobe_base_bpf.c:1): the SYSCALL suite builds the IDENTICAL
goid key for proc_info-managed Go tgids — read at syscall entry where
the inner pt_regs expose the user's R14, carried to the kretprobe in
the entry stash (socket_trace.build_enter; a goroutine cannot migrate
OS threads while blocked in a syscall, so the stash's pid_tgid key
stays valid and only the trace park/consume needs the goid). A
decrypted TLS read therefore chains into the same goroutine's
plaintext syscall egress across sources AND threads
(the cross-source live-attach test proves it in-kernel).
One proc_info row — the maps alias each other — enables both.

The port's own copy of the JAX package's `agent/uprobe_trace.py` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import os
import re
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from deepflow_tpu_torch.agent.bpf import (BPF_ADD, BPF_ARSH, BPF_DW, BPF_SUB,
                                          BPF_JEQ, BPF_JGT, BPF_JNE, BPF_JSGT,
                                          BPF_JSLE, BPF_LSH,
                                          BPF_MAP_TYPE_LRU_HASH, BPF_OR,
                                          BPF_PROG_TYPE_KPROBE,
                                          BPF_RSH, BPF_W,
                                          FN_get_current_pid_tgid,
                                          FN_map_delete_elem,
                                          FN_map_lookup_elem,
                                          FN_get_current_task,
                                          FN_map_update_elem, FN_probe_read,
                                          R0, R1, R2, R3, R4, R6, R7, R8, R9,
                                          R10, Asm, Map, Program, available,
                                          load)
from deepflow_tpu_torch.agent.socket_trace import (PAYLOAD_CAP,
                                                   SOURCE_GO_TLS_UPROBE,
                                                   SOURCE_OPENSSL_UPROBE,
                                                   SocketTraceMaps, T_EGRESS,
                                                   T_INGRESS, create_maps,
                                                   emit_fs_g_load,
                                                   emit_gokey_pack,
                                                   emit_record_tail)
from deepflow_tpu_torch.agent.socket_trace import (_FDSAVE, _IOVPAIR,  # noqa
                                                   _KEY, _PT_AX, _PT_DI,
                                                   _PT_SI, _SCRATCH)

# x86_64 pt_regs offsets beyond socket_trace's (uprobes see the USER
# registers directly — no syscall-wrapper inner-pt_regs hop); R14 is
# where register-ABI Go keeps the current g
_PT_BX, _PT_CX, _PT_SP, _PT_R14 = 40, 88, 152, 8

# OpenSSL fd recovery: ssl->rbio, then BIO->num at the offset each
# libssl generation uses (openssl_bpf.c:43-47 — constants because
# libssl ships without debug info)
SSL_RBIO_OFF = 0x10
RBIO_FD_OFFS = (0x38, 0x30, 0x28)      # 3.x, 1.1.1, 1.1.0

# Go struct-walk defaults (go_tracer.c:71-175 data_members table):
# tls.Conn.conn at +0, interface data at +8, net.conn.fd -> *netFD at
# +0, poll.FD.Sysfd at +16, runtime.g.goid at +152
GO_DEFAULT_INFO = {"reg_abi": 1, "conn_off": 0, "fd_off": 0,
                   "sysfd_off": 16}

# runtime.g.goid file: 152 bytes of fields precede goid (stack 16,
# stackguard0/1, _panic, _defer, m, sched gobuf 56, syscallsp/pc,
# stktopsp, param, atomicstatus+stackLock) from go 1.9 through 1.22
# (1.5-1.8 carried stkbar stack-barrier fields before goid — refused);
# 1.23 inserted syscallbp after syscallpc, shifting goid to 160
# (go_tracer.c's per-version data_members table role)
GOID_OFF_DEFAULT, GOID_OFF_GO123 = 152, 160

# fresh stack slots (below socket_trace's frame, which tops out at
# _IOVPAIR = -264 .. -249)
_GOSTASH = -288      # stash build area {buf, fd, sp} (24B, -288..-265)
_PIKEY = -296        # u32 tgid key for proc_info lookups
_PIOFFS = -312       # {conn_off, fd_off, sysfd_off, pad} copy (16B)
_GOIDVAL = -328      # probe_read target for runtime.g.goid (8B)
_FSBOFF = -332       # u32 fsbase_off copy (stack-ABI g via %fs:-8)
_GOIDOFF = -336      # u32 goid_off copy (0 = pid_tgid keying)


@dataclass
class UprobeMaps:
    """ssl_ctx / go_conn / proc_info plus the SHARED trace/conf/events
    maps. Sharing them with a SocketTraceSuite (pass its maps) gives
    one trace-id ALLOCATOR and one event stream across syscall and
    uprobe sources, and OpenSSL/stack-ABI records (pid_tgid-keyed)
    park/consume against syscall records directly. Goid-keyed records
    (register-ABI Go) park in the same map under bit63-partitioned
    keys — chained among themselves per-goroutine, not with the
    syscall suite's pid_tgid parks (see the module docstring's
    tradeoff note)."""

    ssl_ctx: Map         # pid_tgid -> {buf, fd}            (16B)
    go_conn: Map         # goid key -> {buf, fd, entry sp}  (24B)
    shared: SocketTraceMaps
    owns_shared: bool = False

    @property
    def trace(self) -> Map:
        return self.shared.trace

    @property
    def conf(self) -> Map:
        return self.shared.conf

    @property
    def events(self) -> Map:
        return self.shared.events

    @property
    def proc_info(self) -> Map:
        """ALIASES the socket-trace suite's map: one proc_info row
        enables goid keying for a tgid in both the syscall programs
        (trace key via the entry stash) and the TLS uprobe programs —
        which is what makes the two sources build the same key and
        chain."""
        return self.shared.proc_info

    def set_proc_info(self, tgid: int, reg_abi: bool, conn_off: int = 0,
                      fd_off: int = 0, sysfd_off: int = 16,
                      goid_off: int = 0,
                      fsbase_off: Optional[int] = None) -> None:
        self.shared.set_proc_info(tgid, reg_abi, conn_off, fd_off,
                                  sysfd_off, goid_off, fsbase_off)

    def close(self) -> None:
        for m in (self.ssl_ctx, self.go_conn):
            m.close()
        if self.owns_shared:
            self.shared.close()


def create_uprobe_maps(
        shared: Optional[SocketTraceMaps] = None) -> UprobeMaps:
    owns = shared is None
    if shared is None:
        shared = create_maps()
    made: List[Map] = []
    try:
        # ssl_ctx / go_conn are LRU: a stash whose exit never fires (a
        # panic unwinding past the RET uprobe; an undecodable-exit
        # function whose enters still run; goid keys that are never
        # naturally overwritten) must age out, not brick the map.
        # proc_info lives in the SHARED maps (plain HASH there — LRU
        # eviction would silently disable keying for a managed
        # process).
        for args in ((8192, 16, BPF_MAP_TYPE_LRU_HASH, 8),
                     (8192, 24, BPF_MAP_TYPE_LRU_HASH, 8)):
            made.append(Map(*args))
    except OSError:
        for m in made:
            m.close()
        if owns:
            shared.close()
        raise
    return UprobeMaps(*made, shared=shared, owns_shared=owns)


# -- kernel programs -------------------------------------------------------

def _clamp_len(a: Asm) -> None:
    """R8 (signed byte count, already checked > 0) -> (0, PAYLOAD_CAP]."""
    a.jmp_imm(BPF_JGT, R8, PAYLOAD_CAP, "clamp")
    a.jmp("len_ok")
    a.label("clamp").mov_imm(R8, PAYLOAD_CAP)
    a.label("len_ok")


def _goid_rekey(a: Asm) -> None:
    """Rewrite the _KEY slot from pid_tgid to (tgid<<32 | goid-slice).

    Contract on entry: R6=ctx (user pt_regs), R7=pid_tgid, _GOIDOFF
    holds the u32 goid offset (0 = keep pid_tgid), _KEY already holds
    pid_tgid. Clobbers R0-R3 and _GOIDVAL.

    Fault discipline: with keying ENABLED (goid_off != 0)
    any failed goid read — no g in R14, probe_read fault, goid 0 —
    jumps to the program's "done" label and DROPS the call, it does
    not fall back to pid_tgid. A fallback here would be asymmetric
    across the enter/exit pair: an enter that faulted would stash
    under pid_tgid(thread) where a LATER call's faulting exit on the
    same thread could find it and emit that other call's buffer as its
    own — wrong-payload confusion. Dropping keeps the guarantee
    loss-only. (goid reads fault only in exceptional states — the g
    page is always resident for a running goroutine — so the loss rate
    is negligible; the reference accepts the confusion instead by
    falling back to tid, common.h get_current_goroutine returning 0.)
    Only goid_off == 0 (keying disabled: stack ABI, unmanaged tgid)
    keeps the pid_tgid key, where enter and exit are symmetric by
    construction.

    Key shape: bit63 | tgid<<32 | (goid & 0xffffffff). Bit 63 is the
    source partition for the SHARED trace map: pid_tgid keys always
    have it clear (the high word is a tgid < pid_max = 2^22), so a
    goid key can never consume a syscall park or vice versa
    (uprobe_base_bpf.c keys its own map by tgid+goid; here one map
    serves both sources, so the partition carries the separation).
    Residual ambiguity: two goroutines in one tgid whose goids are
    congruent mod 2^32, BOTH with a call in flight — goids are
    monotonic, so that needs ~4 billion goroutine spawns between two
    concurrently-live calls; the LRU maps bound the damage to one
    wrong pairing even then.

    g location by ABI (reads _PIOFFS+0/reg_abi and _FSBOFF, which the
    callers' prologues copy from proc_info): register ABI has g in
    R14; stack ABI (go < 1.17) keeps it at %fs:-8, reached through
    task_struct->thread.fsbase at the BTF-discovered offset —
    fsbase_off 0 (no BTF) keeps the pid_tgid key for stack-ABI
    processes (keying unavailable, nothing attempted, not a drop)."""
    a.ldx_mem(BPF_W, R1, R10, _GOIDOFF)
    a.jmp_imm(BPF_JEQ, R1, 0, "gokey_done")        # keying disabled
    a.ldx_mem(BPF_DW, R1, R10, _PIOFFS + 0)        # reg_abi
    a.jmp_imm(BPF_JNE, R1, 0, "gk_reg")
    a.ldx_mem(BPF_W, R1, R10, _FSBOFF)
    a.jmp_imm(BPF_JEQ, R1, 0, "gokey_done")        # no BTF: fallback
    emit_fs_g_load(a, _FSBOFF, _GOIDVAL, "done")   # g -> R3
    a.jmp("gk_have")
    a.label("gk_reg")
    a.ldx_mem(BPF_DW, R3, R6, _PT_R14)             # current g
    a.label("gk_have")
    a.jmp_imm(BPF_JEQ, R3, 0, "done")              # no g: drop call
    a.ldx_mem(BPF_W, R1, R10, _GOIDOFF)
    a.alu_reg(BPF_ADD, R3, R1)                     # &g.goid
    a.st_imm(BPF_DW, R10, _GOIDVAL, 0)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _GOIDVAL)
    a.mov_imm(R2, 8)
    a.call(FN_probe_read)
    a.jmp_imm(BPF_JNE, R0, 0, "done")              # faulted: drop call
    a.ldx_mem(BPF_DW, R1, R10, _GOIDVAL)
    a.jmp_imm(BPF_JEQ, R1, 0, "done")              # goid 0: drop call
    emit_gokey_pack(a)             # SHARED with the syscall suite —
    a.stx_mem(BPF_DW, R10, R1, _KEY)  # identical keys = cross-source
    a.label("gokey_done")             # chaining


def build_ssl_enter(maps: UprobeMaps) -> Asm:
    """uprobe on SSL_read/SSL_write entry (direction-agnostic): stash
    {buf, fd} keyed pid_tgid, fd recovered through the rbio walk."""
    a = Asm()
    a.mov_reg(R6, R1)
    a.call(FN_get_current_pid_tgid)
    a.stx_mem(BPF_DW, R10, R0, _KEY)
    a.ldx_mem(BPF_DW, R8, R6, _PT_DI)              # SSL*
    a.ldx_mem(BPF_DW, R1, R6, _PT_SI)              # buf
    a.stx_mem(BPF_DW, R10, R1, _GOSTASH + 0)
    # rbio = *(ssl + SSL_RBIO_OFF)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _SCRATCH)
    a.mov_imm(R2, 8)
    a.mov_reg(R3, R8).alu_imm(BPF_ADD, R3, SSL_RBIO_OFF)
    a.call(FN_probe_read)
    a.ldx_mem(BPF_DW, R8, R10, _SCRATCH)           # rbio
    # fd candidates at the per-version offsets; first plausible (>2)
    # wins, the last one is taken as-is (openssl_bpf.c:48-59)
    for idx, off in enumerate(RBIO_FD_OFFS):
        a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _SCRATCH)
        a.mov_imm(R2, 4)
        a.mov_reg(R3, R8).alu_imm(BPF_ADD, R3, off)
        a.call(FN_probe_read)
        a.ldx_mem(BPF_W, R1, R10, _SCRATCH)        # zero-extended u32
        # sign-extend the s32 fd so "-1" doesn't read as 4 billion
        a.alu_imm(BPF_LSH, R1, 32).alu_imm(BPF_ARSH, R1, 32)
        if idx < len(RBIO_FD_OFFS) - 1:
            a.jmp_imm(BPF_JSGT, R1, 2, "fd_done")
    a.label("fd_done")
    a.stx_mem(BPF_DW, R10, R1, _GOSTASH + 8)       # fd
    a.ld_map_fd(R1, maps.ssl_ctx)
    a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _KEY)
    a.mov_reg(R3, R10).alu_imm(BPF_ADD, R3, _GOSTASH)
    a.mov_imm(R4, 0)                               # BPF_ANY
    a.call(FN_map_update_elem)
    a.exit_imm(0)
    return a


def build_ssl_exit(maps: UprobeMaps, direction: int) -> Asm:
    """uretprobe on SSL_read (T_INGRESS) / SSL_write (T_EGRESS): ret
    <= 0 drops; otherwise the stashed plaintext buffer is captured and
    the record emitted with SOURCE_OPENSSL_UPROBE, running the same
    trace-id park/consume discipline as the syscall suite."""
    a = Asm()
    a.mov_reg(R6, R1)
    a.call(FN_get_current_pid_tgid)
    a.mov_reg(R7, R0)
    a.stx_mem(BPF_DW, R10, R7, _KEY)
    a.ld_map_fd(R1, maps.ssl_ctx)
    a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _KEY)
    a.call(FN_map_lookup_elem)
    a.jmp_imm(BPF_JEQ, R0, 0, "done")
    a.ldx_mem(BPF_DW, R9, R0, 0)                   # buf
    a.ldx_mem(BPF_DW, R1, R0, 8)
    a.stx_mem(BPF_DW, R10, R1, _FDSAVE)            # fd
    a.ld_map_fd(R1, maps.ssl_ctx)                  # consume the stash
    a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _KEY)
    a.call(FN_map_delete_elem)
    # uretprobe fires with the USER pt_regs at return: ax = SSL ret.
    # SSL_read/SSL_write return a C int — the 32-bit register write
    # zero-extends, so -1 arrives as 0x00000000FFFFFFFF; sign-extend
    # before the signed drop check or every failed/WANT_READ call
    # would emit a bogus 128-byte garbage record
    a.ldx_mem(BPF_DW, R8, R6, _PT_AX)
    a.alu_imm(BPF_LSH, R8, 32).alu_imm(BPF_ARSH, R8, 32)
    a.jmp_imm(BPF_JSLE, R8, 0, "done")             # error/WANT_READ
    _clamp_len(a)
    emit_record_tail(a, maps, direction, source=SOURCE_OPENSSL_UPROBE)
    a.label("done")
    a.exit_imm(0)
    return a


def build_go_tls_enter(maps: UprobeMaps) -> Asm:
    """uprobe on crypto/tls.(*Conn).Read/Write entry. Register ABI
    (go >= 1.17): receiver in AX, slice ptr in BX; stack ABI: receiver
    at sp+8, slice ptr at sp+16. The fd walk (Conn.conn iface ->
    net.conn.fd -> pfd.Sysfd) uses the per-binary offsets userspace
    pushed into proc_info — an unmanaged process (no entry) traces
    nothing, exactly the reference's proc_info_map gate."""
    a = Asm()
    a.mov_reg(R6, R1)
    a.call(FN_get_current_pid_tgid)
    a.mov_reg(R7, R0)
    a.stx_mem(BPF_DW, R10, R7, _KEY)
    a.mov_reg(R1, R7).alu_imm(BPF_RSH, R1, 32)
    a.stx_mem(BPF_W, R10, R1, _PIKEY)
    a.ld_map_fd(R1, maps.proc_info)
    a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _PIKEY)
    a.call(FN_map_lookup_elem)
    a.jmp_imm(BPF_JEQ, R0, 0, "done")
    # copy the offsets out before the next helper call invalidates R0
    a.ldx_mem(BPF_W, R1, R0, 0)                    # reg_abi
    a.stx_mem(BPF_DW, R10, R1, _PIOFFS + 0)
    a.ldx_mem(BPF_W, R1, R0, 4)                    # conn_off
    a.stx_mem(BPF_W, R10, R1, _PIOFFS + 8)
    a.ldx_mem(BPF_W, R1, R0, 8)                    # fd_off
    a.stx_mem(BPF_W, R10, R1, _PIOFFS + 12)
    a.ldx_mem(BPF_W, R1, R0, 12)                   # sysfd_off
    a.stx_mem(BPF_W, R10, R1, _SCRATCH)
    a.ldx_mem(BPF_W, R1, R0, 16)                   # goid_off
    a.stx_mem(BPF_W, R10, R1, _GOIDOFF)
    a.ldx_mem(BPF_W, R1, R0, 20)                   # fsbase_off
    a.stx_mem(BPF_W, R10, R1, _FSBOFF)
    _goid_rekey(a)                                 # stash keyed by goid
    a.ldx_mem(BPF_DW, R1, R6, _PT_SP)              # entry sp (exit's
    a.stx_mem(BPF_DW, R10, R1, _GOSTASH + 16)      # stack-ABI ret read)
    a.ldx_mem(BPF_DW, R1, R10, _PIOFFS + 0)
    a.jmp_imm(BPF_JEQ, R1, 0, "stack_abi")
    a.ldx_mem(BPF_DW, R8, R6, _PT_AX)              # receiver (Conn*)
    a.ldx_mem(BPF_DW, R1, R6, _PT_BX)              # slice data ptr
    a.stx_mem(BPF_DW, R10, R1, _GOSTASH + 0)
    a.jmp("walk")
    a.label("stack_abi")
    # {receiver, slice ptr} live at sp+8 in one contiguous 16B read
    a.ldx_mem(BPF_DW, R3, R10, _GOSTASH + 16)
    a.alu_imm(BPF_ADD, R3, 8)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _IOVPAIR)
    a.mov_imm(R2, 16)
    a.call(FN_probe_read)
    a.ldx_mem(BPF_DW, R8, R10, _IOVPAIR + 0)       # receiver
    a.ldx_mem(BPF_DW, R1, R10, _IOVPAIR + 8)       # slice data ptr
    a.stx_mem(BPF_DW, R10, R1, _GOSTASH + 0)
    a.label("walk")
    # hop 1: iface data = *(conn + conn_off + 8) (interface layout:
    # {itab, data})
    a.ldx_mem(BPF_W, R3, R10, _PIOFFS + 8)
    a.alu_reg(BPF_ADD, R3, R8).alu_imm(BPF_ADD, R3, 8)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _GOSTASH + 8)
    a.mov_imm(R2, 8)
    a.call(FN_probe_read)
    a.ldx_mem(BPF_DW, R8, R10, _GOSTASH + 8)
    a.jmp_imm(BPF_JEQ, R8, 0, "done")
    # hop 2: *netFD = *(data + fd_off)
    a.ldx_mem(BPF_W, R3, R10, _PIOFFS + 12)
    a.alu_reg(BPF_ADD, R3, R8)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _GOSTASH + 8)
    a.mov_imm(R2, 8)
    a.call(FN_probe_read)
    a.ldx_mem(BPF_DW, R8, R10, _GOSTASH + 8)
    a.jmp_imm(BPF_JEQ, R8, 0, "done")
    # hop 3: Sysfd (s32) = *(netFD + sysfd_off)
    a.ldx_mem(BPF_W, R3, R10, _SCRATCH)
    a.alu_reg(BPF_ADD, R3, R8)
    a.st_imm(BPF_DW, R10, _GOSTASH + 8, 0)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _GOSTASH + 8)
    a.mov_imm(R2, 4)
    a.call(FN_probe_read)
    a.ld_map_fd(R1, maps.go_conn)
    a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _KEY)
    a.mov_reg(R3, R10).alu_imm(BPF_ADD, R3, _GOSTASH)
    a.mov_imm(R4, 0)                               # BPF_ANY
    a.call(FN_map_update_elem)
    a.label("done")
    a.exit_imm(0)
    return a


def build_go_tls_exit(maps: UprobeMaps, direction: int) -> Asm:
    """uprobe at the RET offsets of crypto/tls.(*Conn).Read/Write
    (symbol.c's resolve_func_ret_addr role is x86_decode.py here).
    Byte count from AX (register ABI) or saved-entry-sp+40 (stack
    ABI); <= 0 drops."""
    a = Asm()
    a.mov_reg(R6, R1)
    a.call(FN_get_current_pid_tgid)
    a.mov_reg(R7, R0)
    a.stx_mem(BPF_DW, R10, R7, _KEY)
    # proc_info FIRST (the enter gated on it too): reg_abi for the ret
    # read, goid_off so the stash lookup key matches the enter's
    a.mov_reg(R1, R7).alu_imm(BPF_RSH, R1, 32)
    a.stx_mem(BPF_W, R10, R1, _PIKEY)
    a.ld_map_fd(R1, maps.proc_info)
    a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _PIKEY)
    a.call(FN_map_lookup_elem)
    a.jmp_imm(BPF_JEQ, R0, 0, "done")
    a.ldx_mem(BPF_W, R1, R0, 0)                    # reg_abi
    a.stx_mem(BPF_DW, R10, R1, _PIOFFS + 0)
    a.ldx_mem(BPF_W, R1, R0, 16)                   # goid_off
    a.stx_mem(BPF_W, R10, R1, _GOIDOFF)
    a.ldx_mem(BPF_W, R1, R0, 20)                   # fsbase_off
    a.stx_mem(BPF_W, R10, R1, _FSBOFF)
    _goid_rekey(a)                                 # same key the enter built
    a.ld_map_fd(R1, maps.go_conn)
    a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _KEY)
    a.call(FN_map_lookup_elem)
    a.jmp_imm(BPF_JEQ, R0, 0, "done")
    a.ldx_mem(BPF_DW, R9, R0, 0)                   # buf
    a.ldx_mem(BPF_DW, R1, R0, 8)
    a.stx_mem(BPF_DW, R10, R1, _FDSAVE)            # fd
    a.ldx_mem(BPF_DW, R1, R0, 16)
    a.stx_mem(BPF_DW, R10, R1, _GOSTASH + 16)      # entry sp
    a.ld_map_fd(R1, maps.go_conn)                  # consume the stash
    a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _KEY)
    a.call(FN_map_delete_elem)
    a.ldx_mem(BPF_DW, R1, R10, _PIOFFS + 0)        # reg_abi
    a.jmp_imm(BPF_JEQ, R1, 0, "stack_ret")
    a.ldx_mem(BPF_DW, R8, R6, _PT_AX)              # n in AX
    a.jmp("have_ret")
    a.label("stack_ret")
    # stack ABI: (n int, err error) at entry-sp +40 (go_tls_bpf.c:81)
    a.ldx_mem(BPF_DW, R3, R10, _GOSTASH + 16)
    a.alu_imm(BPF_ADD, R3, 40)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _SCRATCH)
    a.mov_imm(R2, 8)
    a.call(FN_probe_read)
    a.ldx_mem(BPF_DW, R8, R10, _SCRATCH)
    a.label("have_ret")
    a.jmp_imm(BPF_JSLE, R8, 0, "done")
    _clamp_len(a)
    emit_record_tail(a, maps, direction, source=SOURCE_GO_TLS_UPROBE)
    a.label("done")
    a.exit_imm(0)
    return a


class UprobeSuite:
    """The loaded TLS-uprobe program set. Construction runs every
    program through the kernel verifier (failure raises with the
    verifier log); pass a SocketTraceSuite's maps as `shared` so
    syscall and TLS records share one trace-id space."""

    def __init__(self,
                 shared: Optional[SocketTraceMaps] = None) -> None:
        self.maps = create_uprobe_maps(shared)
        loaded: List[Program] = []
        try:
            for builder in (lambda: build_ssl_enter(self.maps),
                            lambda: build_ssl_exit(self.maps, T_INGRESS),
                            lambda: build_ssl_exit(self.maps, T_EGRESS),
                            lambda: build_go_tls_enter(self.maps),
                            lambda: build_go_tls_exit(self.maps,
                                                      T_INGRESS),
                            lambda: build_go_tls_exit(self.maps,
                                                      T_EGRESS)):
                loaded.append(load(builder().assemble(),
                                   prog_type=BPF_PROG_TYPE_KPROBE))
        except OSError:
            for p in loaded:
                p.close()
            self.maps.close()
            raise
        (self.ssl_enter, self.ssl_exit_read, self.ssl_exit_write,
         self.go_enter, self.go_exit_read, self.go_exit_write) = loaded

    def programs(self) -> Dict[str, Program]:
        return {"ssl_enter": self.ssl_enter,
                "ssl_exit_read": self.ssl_exit_read,
                "ssl_exit_write": self.ssl_exit_write,
                "go_enter": self.go_enter,
                "go_exit_read": self.go_exit_read,
                "go_exit_write": self.go_exit_write}

    def close(self) -> None:
        for p in self.programs().values():
            p.close()
        self.maps.close()


# -- ELF plumbing (sections, sizes, vaddr->offset) -------------------------

def _read_elf(path: str) -> Optional[bytes]:
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if len(data) < 64 or data[:4] != b"\x7fELF" or data[4] != 2 \
            or data[5] != 1:
        return None
    return data


def elf_sections(path: str) -> Dict[str, Tuple[int, int, int]]:
    """section name -> (file offset, size, vaddr)."""
    data = _read_elf(path)
    if data is None:
        return {}
    e_shoff, = struct.unpack_from("<Q", data, 0x28)
    e_shentsize, e_shnum, e_shstrndx = struct.unpack_from(
        "<HHH", data, 0x3A)
    if e_shstrndx >= e_shnum:
        return {}
    stroff, strsz = struct.unpack_from(
        "<QQ", data, e_shoff + e_shstrndx * e_shentsize + 24)
    strtab = data[stroff:stroff + strsz]
    out: Dict[str, Tuple[int, int, int]] = {}
    for i in range(e_shnum):
        off = e_shoff + i * e_shentsize
        if off + 64 > len(data):
            break
        sh_name, = struct.unpack_from("<I", data, off)
        sh_addr, sh_offset, sh_size = struct.unpack_from(
            "<QQQ", data, off + 16)
        end = strtab.find(b"\0", sh_name)
        name = strtab[sh_name:end if end >= 0 else None].decode(
            "utf-8", "replace")
        if name:
            out[name] = (sh_offset, sh_size, sh_addr)
    return out


def elf_func_table(path: str) -> Dict[str, Tuple[int, int]]:
    """function name -> (vaddr, size) from .symtab + .dynsym STT_FUNC
    entries (profiler.elf_function_symbols returns addr->name for
    symbolization; probing additionally needs SIZES for the RET
    walk)."""
    data = _read_elf(path)
    if data is None:
        return {}
    e_shoff, = struct.unpack_from("<Q", data, 0x28)
    e_shentsize, e_shnum = struct.unpack_from("<HH", data, 0x3A)
    out: Dict[str, Tuple[int, int]] = {}
    for i in range(e_shnum):
        off = e_shoff + i * e_shentsize
        if off + 64 > len(data):
            break
        sh_type, = struct.unpack_from("<I", data, off + 4)
        if sh_type not in (2, 11):                 # SYMTAB / DYNSYM
            continue
        sh_offset, sh_size = struct.unpack_from("<QQ", data, off + 24)
        sh_link, = struct.unpack_from("<I", data, off + 40)
        sh_entsize, = struct.unpack_from("<Q", data, off + 56)
        if sh_entsize != 24 or sh_link >= e_shnum:
            continue
        stroff, strsz = struct.unpack_from(
            "<QQ", data, e_shoff + sh_link * e_shentsize + 24)
        strtab = data[stroff:stroff + strsz]
        for s in range(sh_offset,
                       min(sh_offset + sh_size, len(data)), 24):
            st_name, st_info = struct.unpack_from("<IB", data, s)
            if st_info & 0xF != 2:                 # STT_FUNC
                continue
            st_value, st_size = struct.unpack_from("<QQ", data, s + 8)
            if st_value == 0 or st_name >= len(strtab):
                continue
            end = strtab.find(b"\0", st_name)
            name = strtab[st_name:end if end >= 0 else None].decode(
                "utf-8", "replace")
            if name and name not in out:
                out[name] = (st_value, st_size)
    return out


def vaddr_to_offset(path: str, vaddr: int) -> Optional[int]:
    """Virtual address -> file offset via PT_LOAD program headers —
    uprobes attach at FILE offsets (symbol.c:170-181's
    resolve_bin_file role)."""
    data = _read_elf(path)
    if data is None:
        return None
    e_phoff, = struct.unpack_from("<Q", data, 0x20)
    e_phentsize, e_phnum = struct.unpack_from("<HH", data, 0x36)
    for i in range(e_phnum):
        off = e_phoff + i * e_phentsize
        if off + 56 > len(data):
            break
        p_type, = struct.unpack_from("<I", data, off)
        if p_type != 1:                            # PT_LOAD
            continue
        p_offset, p_vaddr, _p_paddr, p_filesz = struct.unpack_from(
            "<QQQQ", data, off + 8)
        if p_vaddr <= vaddr < p_vaddr + p_filesz:
            return vaddr - p_vaddr + p_offset
    return None


# -- Go binary inspection ---------------------------------------------------

_BUILDINFO_MAGIC = b"\xff Go buildinf:"


def go_version(path: str) -> Optional[str]:
    """Go toolchain version of a binary ("go1.20.4"), from the
    .go.buildinfo blob (go_tracer.c:418's go_version_offset read —
    the 1.18+ inline-string layout), falling back to scanning for the
    always-embedded runtime version string."""
    data = _read_elf(path)
    if data is None:
        return None
    secs = elf_sections(path)
    blob = None
    if ".go.buildinfo" in secs:
        off, size, _ = secs[".go.buildinfo"]
        blob = data[off:off + size]
    if blob is not None and blob[:14] == _BUILDINFO_MAGIC \
            and len(blob) > 33 and blob[15] & 2:
        # flags bit 1 = inline strings: varint length at +32
        n = blob[32]
        if n < 128 and 33 + n <= len(blob):
            v = blob[33:33 + n].decode("utf-8", "replace")
            if v.startswith("go"):
                return v
    # pointer-layout buildinfo (go < 1.18): the runtime always embeds
    # "go1.X.Y" — but ONLY trust the scan when the binary carries Go
    # structure (.go.buildinfo / .gopclntab / runtime symbols). A bare
    # byte match anywhere ('logo1.2' in libssl's docs) would misroute
    # a C library away from SSL attach with no error anywhere
    if not ({".go.buildinfo", ".gopclntab"} & set(secs)
            or ".note.go.buildid" in secs):
        return None
    m = re.search(rb"go1\.\d+(\.\d+)?", data)
    return m.group(0).decode() if m else None


def _go_release(version: Optional[str]) -> Optional[Tuple[int, int]]:
    """(major, minor) from a toolchain version string, tolerating
    prerelease suffixes ("go1.23rc1" -> (1, 23), "go1.24beta2" ->
    (1, 24)); None when unparseable. ONE parser for every
    version-gated decision below — two hand-rolled copies disagreed on
    the unparseable fallback once, which mis-keyed prerelease
    toolchains."""
    if not version or not version.startswith("go"):
        return None
    m = re.match(r"go(\d+)\.(\d+)", version)
    if not m:
        return None
    return int(m.group(1)), int(m.group(2))


def go_register_abi(version: Optional[str]) -> bool:
    """regabi (args in AX/BX/...) landed on amd64 in go 1.17
    (go_tracer.c's is_register_based_call)."""
    rel = _go_release(version)
    return True if rel is None else rel >= (1, 17)   # modern default


def go_goid_offset(version: Optional[str]) -> int:
    """Offset of runtime.g.goid for this toolchain version, 0 when
    keying must be disabled: an UNPARSEABLE version — a guessed offset
    on the wrong layout would read atomicstatus/stackLock, collapsing
    every goroutine onto one key and cross-wiring their stashes,
    strictly worse than the pid_tgid fallback's bounded loss. The
    152-byte prefix held from go 1.9 through 1.22 (both ABIs — the
    regabi transition did not reorder runtime.g; 1.5-1.8 carried
    stack-barrier fields (stkbar/stkbarPos) before goid, so those
    versions are REFUSED rather than mis-probed), and stack-ABI
    binaries key too, with g reached via %fs:-8 instead of R14
    (fsbase_off). The reference resolves this from its per-version
    data_members table (go_tracer.c:71-175); the layout history is in
    GOID_OFF_DEFAULT's comment."""
    rel = _go_release(version)
    if rel is None or rel < (1, 9):
        return 0
    return GOID_OFF_GO123 if rel >= (1, 23) else GOID_OFF_DEFAULT


# -- attach planning --------------------------------------------------------

GO_TLS_SYMBOLS = {"crypto/tls.(*Conn).Read": T_INGRESS,
                  "crypto/tls.(*Conn).Write": T_EGRESS}
SSL_SYMBOLS = {"SSL_read": T_INGRESS, "SSL_write": T_EGRESS}


@dataclass
class UprobeSpec:
    """One attachment: program `role` at `path`+`offset` (file
    offset). `retprobe` uses the PMU's uretprobe flavor; RET-offset
    exits instead carry extra entries, one per RET."""

    path: str
    symbol: str
    offset: int
    role: str            # key into UprobeSuite.programs()
    retprobe: bool = False


@dataclass
class GoProcPlan:
    version: str
    reg_abi: bool
    goid_off: int = 0    # runtime.g.goid offset (0 = pid_tgid keying)
    specs: List[UprobeSpec] = field(default_factory=list)
    undecodable: List[str] = field(default_factory=list)


def plan_ssl(path: str) -> List[UprobeSpec]:
    """Attach plan for a libssl image: uprobe at SSL_read/SSL_write
    entry + uretprobe at their returns (ssl_tracer.c probe table)."""
    funcs = elf_func_table(path)
    specs: List[UprobeSpec] = []
    for sym, direction in SSL_SYMBOLS.items():
        if sym not in funcs:
            continue
        vaddr, _size = funcs[sym]
        off = vaddr_to_offset(path, vaddr)
        if off is None:
            continue
        exit_role = ("ssl_exit_read" if direction == T_INGRESS
                     else "ssl_exit_write")
        specs.append(UprobeSpec(path, sym, off, "ssl_enter"))
        specs.append(UprobeSpec(path, sym, off, exit_role,
                                retprobe=True))
    return specs


def find_libssl(pid: int) -> Optional[str]:
    """The libssl image a process has mapped (ssl_tracer.c's
    per-process library discovery over /proc/<pid>/maps)."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 6 and "libssl" in parts[-1] \
                        and ".so" in parts[-1]:
                    return parts[-1]
    except OSError:
        pass
    return None


def plan_go(path: str) -> Optional[GoProcPlan]:
    """Attach plan for a Go binary: entry uprobes at
    crypto/tls.(*Conn).Read/Write plus exit uprobes at every RET of
    each (go_tracer.c + symbol.c:184). None = not a Go binary or no
    TLS symbols (pure-HTTP or stripped)."""
    from deepflow_tpu_torch.agent.x86_decode import DecodeError, \
        find_ret_offsets
    version = go_version(path)
    if version is None:
        return None
    funcs = elf_func_table(path)
    plan = GoProcPlan(version=version,
                      reg_abi=go_register_abi(version),
                      goid_off=go_goid_offset(version))
    data = _read_elf(path) or b""
    for sym, direction in GO_TLS_SYMBOLS.items():
        if sym not in funcs:
            continue
        vaddr, size = funcs[sym]
        off = vaddr_to_offset(path, vaddr)
        if off is None or size == 0:
            continue
        exit_role = ("go_exit_read" if direction == T_INGRESS
                     else "go_exit_write")
        plan.specs.append(UprobeSpec(path, sym, off, "go_enter"))
        try:
            rets = find_ret_offsets(data[off:off + size])
        except DecodeError:
            # never probe a guessed boundary: skip this function's
            # exits entirely and record why (the enter stash simply
            # expires unconsumed — loss, not corruption)
            plan.undecodable.append(sym)
            continue
        for r in rets:
            plan.specs.append(UprobeSpec(path, sym, off + r, exit_role))
    return plan if plan.specs else None


# -- attach capability ------------------------------------------------------

class TlsUprobeSource:
    """Live TLS capture for one agent: suite + attachments + perf
    reader, pumping kernel SOCK_DATA records into an EbpfTracer. The
    runtime-facing face of this module (trident wires it when the
    capability probe passes and config asks for it); targets are
    binary paths (a libssl image or a Go binary) or pids (libssl
    discovered via /proc/<pid>/maps).

    Reference: the ssl/go tracer lifecycles in
    agent/src/ebpf/user/{ssl_tracer.c,go_tracer.c} — probe tables
    built per process, attached through tracer.c, records through the
    shared perf reader."""

    def __init__(self, shared: Optional[SocketTraceMaps] = None,
                 cpus: Optional[List[int]] = None) -> None:
        from deepflow_tpu_torch.agent import perf_ring
        ok, why = attach_available()
        if not ok:
            raise OSError(95, f"uprobe attach unavailable: {why}")
        self.suite = UprobeSuite(shared)
        try:
            self.reader = perf_ring.BpfOutputReader(
                self.suite.maps.events, cpus=cpus)
        except OSError:
            self.suite.close()
            raise
        self._probes: List[object] = []
        self.targets: List[dict] = []
        # (kind, realpath) of images already probed: uprobes attach to
        # the INODE, so two pids mapping one libssl (nginx workers) or
        # a repeated enable call must not install duplicate probes —
        # every TLS call would fire both and emit doubled records that
        # corrupt session pairing downstream
        self._attached: set = set()
        self._http2_suite = None       # lazy, shares the events map
        self.records_pumped = 0

    def attach_ssl(self, path: str) -> int:
        """Attach the OpenSSL pair set to a libssl image; returns the
        probe count (0 = symbols not found or already attached)."""
        from deepflow_tpu_torch.agent import perf_ring
        key = ("openssl", os.path.realpath(path))
        if key in self._attached:
            return 0
        progs = self.suite.programs()
        specs = plan_ssl(path)
        for s in specs:
            self._probes.append(perf_ring.attach_uprobe(
                progs[s.role], s.path, s.offset, s.retprobe))
        if specs:
            self._attached.add(key)
            self.targets.append({"kind": "openssl", "path": path,
                                 "probes": len(specs)})
        return len(specs)

    def _push_proc_info(self, plan: GoProcPlan, tgid: int) -> None:
        """ONE place turning a plan into a proc_info row — every field
        added to the row (reg_abi, walk offsets, goid_off, ...) must
        reach both the fresh-attach and already-attached paths."""
        self.suite.maps.set_proc_info(
            tgid, reg_abi=plan.reg_abi, goid_off=plan.goid_off,
            **{k: GO_DEFAULT_INFO[k]
               for k in ("conn_off", "fd_off", "sysfd_off")})

    def attach_go(self, path: str, tgid: Optional[int] = None) -> int:
        """Attach the Go-TLS set to a Go binary and push its ABI/offset
        proc_info (for `tgid`, or every current process running that
        binary when omitted). An already-probed binary only refreshes
        proc_info for the new tgid (no duplicate probes)."""
        from deepflow_tpu_torch.agent import perf_ring
        key = ("go_tls", os.path.realpath(path))
        if key in self._attached:
            plan = plan_go(path)
            if plan is not None and tgid is not None:
                self._push_proc_info(plan, tgid)
                if self._http2_suite is not None:
                    # a NEW pid of an already-probed binary needs its
                    # http2_info row too, or its writeHeader probes
                    # fire into the prologue's map-miss exit and h2
                    # capture silently never happens for it
                    from deepflow_tpu_torch.agent.http2_trace import \
                        GO_HTTP2_DEFAULT_INFO
                    self._http2_suite.maps.set_info(
                        tgid, reg_abi=plan.reg_abi,
                        **GO_HTTP2_DEFAULT_INFO)
            return 0
        plan = plan_go(path)
        if plan is None:
            return 0
        self._attached.add(key)
        progs = self.suite.programs()
        for s in plan.specs:
            self._probes.append(perf_ring.attach_uprobe(
                progs[s.role], s.path, s.offset, s.retprobe))
        tgids = [tgid] if tgid is not None else _pids_running(path)
        for t in tgids:
            self._push_proc_info(plan, t)
        self.targets.append({"kind": "go_tls", "path": path,
                             "version": plan.version,
                             "reg_abi": plan.reg_abi,
                             "goid_off": plan.goid_off,
                             "probes": len(plan.specs),
                             "tgids": tgids,
                             "undecodable": plan.undecodable})
        # http2 write-side header sites ride along when the binary has
        # them (reference: go_tracer.c attaches the http2 probe table
        # next to the tls one); events land in the SAME perf rings
        from deepflow_tpu_torch.agent.http2_trace import (
                  GO_HTTP2_DEFAULT_INFO, Http2Suite, plan_go_http2)
        h2_specs = plan_go_http2(path)
        if h2_specs:
            if self._http2_suite is None:
                self._http2_suite = Http2Suite(
                    shared=self.suite.maps.shared)
            progs2 = self._http2_suite.programs()
            for s in h2_specs:
                self._probes.append(perf_ring.attach_uprobe(
                    progs2[s.role], s.path, s.offset, s.retprobe))
            for t in tgids:
                # the REAL walk/stream offsets (go_tracer.c defaults),
                # not set_info's zero defaults — stream_off=0 would
                # leave header events keyed stream 0 while end markers
                # carry the real id, and no group would ever complete
                self._http2_suite.maps.set_info(
                    t, reg_abi=plan.reg_abi, **GO_HTTP2_DEFAULT_INFO)
            self.targets.append({"kind": "go_http2", "path": path,
                                 "probes": len(h2_specs),
                                 "tgids": tgids})
        return len(plan.specs)

    def attach_pid(self, pid: int) -> int:
        """Discover a pid's TLS surface: mapped libssl and/or a Go main
        binary; attach whatever is found."""
        n = 0
        lib = find_libssl(pid)
        if lib:
            n += self.attach_ssl(lib)
        try:
            exe = os.readlink(f"/proc/{pid}/exe")
        except OSError:
            exe = None
        if exe and go_version(exe):
            n += self.attach_go(exe, tgid=pid)
        return n

    def pump(self, feed) -> int:
        """Drain the perf rings into `feed(raw_record_bytes)` — e.g.
        an EbpfTracer.feed_raw, or a wrapper adding a resolver and
        routing merged l7 records (trident._pump_tls_uprobes). Returns
        records moved; the ONLY place records_pumped accrues."""
        n = self.reader.pump(feed)
        self.records_pumped += n
        return n

    def counters(self) -> dict:
        return {"targets": self.targets,
                "probes_attached": len(self._probes),
                "records_pumped": self.records_pumped,
                "ring_lost": self.reader.lost}

    def close(self) -> None:
        for p in self._probes:
            p.close()
        self._probes = []
        self.reader.close()
        if self._http2_suite is not None:
            self._http2_suite.close()
            self._http2_suite = None
        self.suite.close()


def _pids_running(path: str) -> List[int]:
    """Current pids whose main binary is `path`."""
    out: List[int] = []
    real = os.path.realpath(path)
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            if os.path.realpath(f"/proc/{d}/exe") == real:
                out.append(int(d))
        except OSError:
            continue
    return out


_UPROBE_PMU = "/sys/bus/event_source/devices/uprobe/type"
_ATTACH_CACHE: Optional[Tuple[bool, str]] = None


def attach_available() -> Tuple[bool, str]:
    """Could uprobes attach here? Needs the uprobe PMU (perf) or a
    writable tracefs uprobe_events — both typically masked in
    containers, in which case the suite stays verifier-loaded +
    replay-driven (the socket_trace degradation contract)."""
    global _ATTACH_CACHE
    if _ATTACH_CACHE is not None:
        return _ATTACH_CACHE
    if not available():
        _ATTACH_CACHE = (False, "bpf(2) unavailable")
    elif os.path.exists(_UPROBE_PMU):
        _ATTACH_CACHE = (True, "uprobe PMU")
    else:
        for tracefs in ("/sys/kernel/tracing",
                        "/sys/kernel/debug/tracing"):
            if os.access(os.path.join(tracefs, "uprobe_events"),
                         os.W_OK):
                _ATTACH_CACHE = (True, f"tracefs at {tracefs}")
                break
        else:
            _ATTACH_CACHE = (False,
                             "no uprobe PMU and no writable tracefs")
    return _ATTACH_CACHE
