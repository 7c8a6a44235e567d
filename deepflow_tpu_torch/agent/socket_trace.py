"""socket_trace: in-kernel syscall tracing programs, built in-tree.

Reference: agent/src/ebpf/kernel/socket_trace.c — ~2.5k LoC of kprobe C
that hooks read/write/sendmsg/recvmsg, builds SK_BPF_DATA records
(pid/tid, timestamp, direction, capture seq, payload bytes) and applies
the thread-session trace-id discipline (ingress data on a thread parks
a fresh trace id in a map; egress on the same thread consumes it — the
implicit context propagation that chains a service's inbound request to
its outbound call). Records stream to userspace over a perf event
array; agent/src/ebpf/user/socket.c consumes them.

This module authors the same program suite directly in the in-tree
eBPF assembler (agent/bpf.py) — no clang, no libbpf, no ELF:

- maps: `active` (HASH pid_tgid -> {buf, fd, is_msg} syscall-entry
  stash), `trace` (HASH pid_tgid -> parked trace id), `conf` (ARRAY
  [next_trace_id, capture_seq] allocation cells), `events`
  (PERF_EVENT_ARRAY record stream);
- programs: two entry stashers (plain-buffer read/write vs msghdr
  sendmsg/recvmsg arg shapes) and two exit builders (ingress parks a
  freshly allocated trace id, egress consumes the parked one), each
  building the 192-byte SOCK_DATA record on the BPF stack — zero-fill,
  field stores, bounded payload probe_read — and emitting it via
  bpf_perf_event_output;
- the userspace image of the record (`parse_record`) feeds the SAME
  `EbpfTracer` pipeline the fixture replay does (`feed_raw`), so the
  kernel source and the replay source are interchangeable upstream of
  the session aggregator.

The programs LOAD through the kernel verifier wherever bpf(2) is
open (the tests assert it) — a program that loads
is kernel-checked for memory safety, not merely syntax-checked. ATTACH
needs a kprobe PMU (/sys/bus/event_source/devices/kprobe) or tracefs,
which containers typically mask; `attach_available()` probes for the
capability and the agent degrades to the fixture/replay path when it's
absent.

x86_64 ABI facts baked into the programs (documented, attach-point
contracts, not verifier requirements):
- syscall wrapper `__x64_sys_read(struct pt_regs *regs)`: the OUTER
  pt_regs' di (offset 112) holds a pointer to the INNER pt_regs whose
  di/si/dx are the user's fd/buf/count;
- kretprobe return value: pt_regs->ax at offset 80;
- struct user_msghdr: msg_iov at +16; struct iovec: iov_base at +0.

The port's own copy of the JAX package's `agent/socket_trace.py` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from deepflow_tpu_torch.agent.bpf import (BPF_ADD, BPF_DW, BPF_SUB,
                                          BPF_JEQ, BPF_JGE, BPF_JGT, BPF_JNE,
                                          BPF_JSLE, BPF_LSH,
                                          BPF_MAP_TYPE_HASH,
                                          BPF_MAP_TYPE_LRU_HASH, BPF_OR,
                                          BPF_RSH,
                                          BPF_MAP_TYPE_PERF_EVENT_ARRAY,
                                          BPF_PROG_TYPE_KPROBE, BPF_W,
                                          FN_get_current_comm,
                                          FN_get_current_pid_tgid,
                                          FN_ktime_get_ns, FN_map_delete_elem,
                                          FN_map_lookup_elem,
                                          FN_map_update_elem,
                                          FN_get_current_task,
                                          FN_perf_event_output,
                                          FN_probe_read, R0, R1, R2, R3,
                                          R4, R5, R6, R7, R8, R9, R10,
                                          Asm, Map, Program, available,
                                          load)

T_INGRESS, T_EGRESS = 0, 1

# data provenance, packed into the record direction word's high half
# (reference: process_data_extra_source, ebpf/kernel/include/common.h:79)
SOURCE_SYSCALL = 0
SOURCE_GO_TLS_UPROBE = 1
SOURCE_GO_HTTP2_UPROBE = 2
SOURCE_OPENSSL_UPROBE = 3
SOURCE_IO_EVENT = 4
TLS_SOURCES = (SOURCE_GO_TLS_UPROBE, SOURCE_GO_HTTP2_UPROBE,
               SOURCE_OPENSSL_UPROBE)

# -- SOCK_DATA record: the kernel->user wire image -------------------------
PAYLOAD_CAP = 128
RECORD_SIZE = 192
# <  pid_tgid  ts  trace_id cap_seq fd  dir len  comm16  payload128
_RECORD_FMT = "<QQQQQII16s128s"
assert struct.calcsize(_RECORD_FMT) == RECORD_SIZE

# x86_64 pt_regs field offsets
_PT_DI, _PT_SI, _PT_AX = 112, 104, 80
# struct user_msghdr / iovec hops
_MSG_IOV_OFF, _IOV_BASE_OFF, _IOV_LEN_OFF = 16, 0, 8

# stack frame (offsets from R10). The uprobe/http2 modules allocate
# their extra slots BELOW this frame's end (-264): extending the frame
# DOWNWARD means renumbering theirs too (uprobe_trace.py's _GOSTASH
# starts at -288) — which is why the goid slots live in the free space
# ABOVE the stash build area instead (-16..-1; the stash value ends at
# -17).
_GOIDVAL = -16       # goid scratch (8B, -16..-9)
_PIKEY = -8          # u32 tgid key for proc_info lookups (-8..-5)
_REC = -192          # SOCK_DATA record
_KEY = -200          # pid_tgid hash key
_CONFKEY = -208      # u32 conf array index
_FDSAVE = -216       # stashed fd across helper calls
_FLAG = -224         # is_msg flag
_SCRATCH = -232      # pointer-hop scratch
_IOVPAIR = -264      # first iovec {iov_base, iov_len} read as ONE 16B
                     # probe_read (-264..-249; -248.. is _TRVAL's 16B)
_TRVAL = -248        # trace-map value {id, fd} (16B)

# proc_info value layout shared with the uprobe suite (ONE map, pushed
# once per managed Go tgid): {reg_abi, conn_off, fd_off, sysfd_off,
# goid_off, fsbase_off} — the syscall programs read reg_abi (+0),
# goid_off (+16) and fsbase_off (+20: task_struct->thread.fsbase from
# kernel BTF, the stack-ABI g location %fs:-8; 0 = fs path
# unavailable)
_PI_REG_ABI = 0
_PI_GOID_OFF = 16
_PI_FSBASE_OFF = 20


@dataclass
class SocketTraceMaps:
    active: Map          # pid_tgid -> {buf, fd, is_msg, gokey, enter_ts}
    trace: Map           # pid_tgid | goid key -> {parked trace id, fd}
    conf: Map            # [0]=next trace id, [1]=capture seq
    events: Map          # perf record stream
    proc_info: Map       # tgid -> {reg_abi, walk offs, goid_off} (24B)

    def close(self) -> None:
        for m in (self.active, self.trace, self.conf, self.events,
                  self.proc_info):
            m.close()

    def set_proc_info(self, tgid: int, reg_abi: bool, conn_off: int = 0,
                      fd_off: int = 0, sysfd_off: int = 16,
                      goid_off: int = 0,
                      fsbase_off: Optional[int] = None) -> None:
        """One row enables goroutine-id trace keying for a tgid in BOTH
        suites (the uprobe maps alias this map when shared). For
        stack-ABI rows the programs reach g through %fs:-8 via
        task->thread.fsbase at `fsbase_off` (default: discovered from
        kernel BTF; 0 = unavailable, keying falls back to
        pid_tgid)."""
        if fsbase_off is None:
            from deepflow_tpu_torch.agent.btf import fsbase_offset
            fsbase_off = fsbase_offset() if not reg_abi else 0
        self.proc_info.update_bytes(
            struct.pack("<I", tgid),
            struct.pack("<IIIIII", 1 if reg_abi else 0, conn_off, fd_off,
                        sysfd_off, goid_off,
                        0 if reg_abi else fsbase_off))


def create_maps(ncpus: Optional[int] = None) -> SocketTraceMaps:
    ncpus = ncpus or os.cpu_count() or 1
    made: List[Map] = []
    try:
        # active + trace are LRU: entries whose consumer never runs (a
        # kill between enter and exit; a goroutine that parks an
        # ingress id and exits without an egress — goid keys are
        # monotonic and never naturally overwritten) must age out
        # instead of filling the map and silently stopping ALL
        # stash/park updates process-wide (socket_trace.c's maps are
        # LRU for the same reason). proc_info stays a plain HASH:
        # eviction there would silently disable goid keying for a
        # managed process, and its population is bounded by tgids.
        for args in ((8192, 40, BPF_MAP_TYPE_LRU_HASH, 8),
                     (8192, 16, BPF_MAP_TYPE_LRU_HASH, 8),
                     (2, 8),
                     (ncpus, 4, BPF_MAP_TYPE_PERF_EVENT_ARRAY),
                     (1024, 24, BPF_MAP_TYPE_HASH, 4)):
            made.append(Map(*args))
    except OSError:
        for m in made:           # no orphan fds on partial creation
            m.close()
        raise
    maps = SocketTraceMaps(*made)
    maps.conf.update(0, 1)       # trace ids allocate from 1 (0 = none)
    maps.conf.update(1, 0)
    return maps


def emit_fs_g_load(a: Asm, fsbase_slot: int, scratch_slot: int,
                   fault_label: str) -> None:
    """Stack-ABI g load: current task -> thread.fsbase (offset in the
    u32 stack slot `fsbase_slot`, BTF-discovered) -> *(fsbase - 8),
    i.e. %fs:-8 where pre-1.17 Go keeps g. Leaves g in R3; clobbers
    R0-R3 and `scratch_slot` (8B). Jumps to `fault_label` on any
    failed hop — ONE emitter for both suites, like emit_gokey_pack:
    the syscall and uprobe programs chain only while their g
    derivation is bit-identical."""
    a.call(FN_get_current_task)
    a.ldx_mem(BPF_W, R1, R10, fsbase_slot)
    a.mov_reg(R3, R0).alu_reg(BPF_ADD, R3, R1)     # &task->thread.fsbase
    a.st_imm(BPF_DW, R10, scratch_slot, 0)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, scratch_slot)
    a.mov_imm(R2, 8)
    a.call(FN_probe_read)
    a.jmp_imm(BPF_JNE, R0, 0, fault_label)
    a.ldx_mem(BPF_DW, R3, R10, scratch_slot)       # fsbase
    a.jmp_imm(BPF_JEQ, R3, 0, fault_label)
    a.alu_imm(BPF_SUB, R3, 8)                      # &(%fs:-8) = &g
    a.st_imm(BPF_DW, R10, scratch_slot, 0)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, scratch_slot)
    a.mov_imm(R2, 8)
    a.call(FN_probe_read)
    a.jmp_imm(BPF_JNE, R0, 0, fault_label)
    a.ldx_mem(BPF_DW, R3, R10, scratch_slot)       # g


def emit_gokey_pack(a: Asm) -> None:
    """bit63 | tgid<<32 | (goid & 0xffffffff) -> R1. Expects R1=goid,
    R7=pid_tgid; clobbers R2. ONE emitter for both suites — the
    syscall and uprobe programs chain trace ids across sources only
    while their keys are bit-identical, so the packing must be
    structural, not maintained-by-parallel-edit. Bit 63
    partitions goid keys from pid_tgid keys (whose high word is a
    tgid < 2^22)."""
    a.alu_imm(BPF_LSH, R1, 32).alu_imm(BPF_RSH, R1, 32)  # goid lo32
    a.mov_reg(R2, R7).alu_imm(BPF_RSH, R2, 32).alu_imm(BPF_LSH, R2, 32)
    a.alu_reg(BPF_OR, R1, R2)                      # | tgid<<32
    a.mov_imm(R2, 1).alu_imm(BPF_LSH, R2, 63)
    a.alu_reg(BPF_OR, R1, R2)                      # | bit63 partition


def build_enter(maps: SocketTraceMaps, is_msg: bool) -> Asm:
    """Syscall-entry stash: {buf_or_msghdr, fd, is_msg, gokey} keyed by
    pid_tgid, consumed by the exit program (socket_trace.c's
    active_*_args_map role).

    gokey: for a proc_info-managed register-ABI Go tgid, the
    bit63|tgid<<32|goid trace key, read HERE — at syscall entry the
    inner pt_regs carry the user registers, so g is reachable
    (inner->r14); at the kretprobe they don't. A goroutine cannot
    migrate OS threads while blocked IN a syscall, so the pid_tgid
    stash key stays correct — only the trace park/consume needs the
    goid key, and the exit reads it from the stash. This is what lets
    a TLS-uprobe park chain into a plaintext syscall consume (and
    vice versa) for Go processes: both sources build the IDENTICAL
    key (uprobe_trace._goid_rekey). Same fault discipline as the
    uprobe side: keying enabled but goid unreadable -> drop the call
    (no stash), never a mismatched-key record. A non-goroutine thread
    in a managed process (cgo, runtime sysmon) carries garbage in
    r14: its reads either fault (dropped — such threads are not app
    traffic) or yield a key whose top half still carries the REAL
    tgid with bit 63, so it cannot collide into another process or
    the pid_tgid key space."""
    a = Asm()
    a.mov_reg(R6, R1)
    a.call(FN_get_current_pid_tgid)
    a.mov_reg(R7, R0)
    a.stx_mem(BPF_DW, R10, R7, _KEY)
    # inner pt_regs* = outer->di
    a.ldx_mem(BPF_DW, R8, R6, _PT_DI)
    # stash value {buf@-56, fd@-48, is_msg@-40, gokey@-32,
    # enter_ts@-24}: arg fields live in the inner pt_regs (kernel
    # memory) -> probe_read, which zero-fills the destination on
    # fault, so a failed read degrades to payload_len 0 downstream
    # instead of leaking uninitialized stack. enter_ts is what lets
    # the exit compute the syscall's latency (the reference's
    # data_args->enter_ts, socket_trace.c:2433 — the io_event gate)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, -56)
    a.mov_imm(R2, 8)
    a.mov_reg(R3, R8).alu_imm(BPF_ADD, R3, _PT_SI)
    a.call(FN_probe_read)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, -48)
    a.mov_imm(R2, 8)
    a.mov_reg(R3, R8).alu_imm(BPF_ADD, R3, _PT_DI)
    a.call(FN_probe_read)
    a.st_imm(BPF_DW, R10, -40, 1 if is_msg else 0)
    a.st_imm(BPF_DW, R10, -32, 0)                  # gokey default: none
    a.call(FN_ktime_get_ns)
    a.stx_mem(BPF_DW, R10, R0, -24)                # enter_ts
    # -- goid trace key for managed Go tgids ------------------------------
    a.mov_reg(R1, R7).alu_imm(BPF_RSH, R1, 32)
    a.stx_mem(BPF_W, R10, R1, _PIKEY)
    a.ld_map_fd(R1, maps.proc_info)
    a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _PIKEY)
    a.call(FN_map_lookup_elem)
    a.jmp_imm(BPF_JEQ, R0, 0, "stash")             # unmanaged: pid_tgid
    a.ldx_mem(BPF_W, R9, R0, _PI_GOID_OFF)
    a.jmp_imm(BPF_JEQ, R9, 0, "stash")             # keying disabled
    a.ldx_mem(BPF_W, R1, R0, _PI_REG_ABI)
    a.jmp_imm(BPF_JNE, R1, 0, "g_reg")
    # stack-ABI Go (< 1.17): g lives at %fs:-8, reached through
    # task_struct->thread.fsbase at the BTF-discovered offset; 0 means
    # no BTF on this kernel — keying UNAVAILABLE, pid_tgid fallback
    # (not a fault: nothing was attempted)
    a.ldx_mem(BPF_W, R1, R0, _PI_FSBASE_OFF)
    a.jmp_imm(BPF_JEQ, R1, 0, "stash")
    a.stx_mem(BPF_W, R10, R1, _PIKEY)              # lookup done: reuse
    emit_fs_g_load(a, _PIKEY, _GOIDVAL, "drop")    # g -> R3
    a.jmp_imm(BPF_JEQ, R3, 0, "drop")
    a.jmp("g_have")
    a.label("g_reg")
    # register ABI: g value = inner pt_regs' saved user r14
    a.st_imm(BPF_DW, R10, _GOIDVAL, 0)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _GOIDVAL)
    a.mov_imm(R2, 8)
    a.mov_reg(R3, R8).alu_imm(BPF_ADD, R3, 8)      # &inner->r14
    a.call(FN_probe_read)
    a.jmp_imm(BPF_JNE, R0, 0, "drop")              # unreadable: drop
    a.ldx_mem(BPF_DW, R3, R10, _GOIDVAL)
    a.jmp_imm(BPF_JEQ, R3, 0, "drop")
    a.label("g_have")
    a.alu_reg(BPF_ADD, R3, R9)                     # &g.goid
    a.st_imm(BPF_DW, R10, _GOIDVAL, 0)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _GOIDVAL)
    a.mov_imm(R2, 8)
    a.call(FN_probe_read)
    a.jmp_imm(BPF_JNE, R0, 0, "drop")
    a.ldx_mem(BPF_DW, R1, R10, _GOIDVAL)
    a.jmp_imm(BPF_JEQ, R1, 0, "drop")
    emit_gokey_pack(a)
    a.stx_mem(BPF_DW, R10, R1, -32)                # gokey into stash
    a.label("stash")
    a.ld_map_fd(R1, maps.active)
    a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _KEY)
    a.mov_reg(R3, R10).alu_imm(BPF_ADD, R3, -56)
    a.mov_imm(R4, 0)                               # BPF_ANY
    a.call(FN_map_update_elem)
    a.exit_imm(0)
    # goid-read fault: this call is DROPPED, and any stale stash under
    # this pid_tgid must go with it — a missed kretprobe (maxactive
    # exhaustion) leaves the previous call's entry behind, and without
    # this delete THIS call's exit would pair with that stale stash
    # (wrong buf pointer, wrong enter_ts latency) instead of being
    # dropped. _KEY still holds pid_tgid: nothing on the
    # goid path writes it, and map helpers clobber only R0-R5.
    a.label("drop")
    a.ld_map_fd(R1, maps.active)
    a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _KEY)
    a.call(FN_map_delete_elem)
    a.exit_imm(0)
    return a


def build_exit(maps: SocketTraceMaps, direction: int) -> Asm:
    """Syscall-exit record builder + trace-id discipline. `direction`
    T_INGRESS (read/recvmsg: allocate + park a trace id) or T_EGRESS
    (write/sendmsg: consume the parked one)."""
    a = Asm()
    a.mov_reg(R6, R1)
    a.call(FN_get_current_pid_tgid)
    a.mov_reg(R7, R0)
    a.stx_mem(BPF_DW, R10, R7, _KEY)
    # entry stash (absent = a syscall we didn't see enter; drop)
    a.ld_map_fd(R1, maps.active)
    a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _KEY)
    a.call(FN_map_lookup_elem)
    a.jmp_imm(BPF_JEQ, R0, 0, "done")
    a.ldx_mem(BPF_DW, R9, R0, 0)                   # buf / msghdr*
    a.ldx_mem(BPF_DW, R1, R0, 8)
    a.stx_mem(BPF_DW, R10, R1, _FDSAVE)            # fd
    a.ldx_mem(BPF_DW, R1, R0, 16)
    a.stx_mem(BPF_DW, R10, R1, _FLAG)              # is_msg
    a.ldx_mem(BPF_DW, R1, R0, 24)                  # gokey (0 = none)
    a.stx_mem(BPF_DW, R10, R1, _GOIDVAL)
    a.ldx_mem(BPF_DW, R1, R0, 32)                  # enter_ts
    a.stx_mem(BPF_DW, R10, R1, _SCRATCH)
    a.ld_map_fd(R1, maps.active)                   # consume the stash
    a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _KEY)
    a.call(FN_map_delete_elem)
    # a goid-keyed call (Go process, enter read the key from g) parks/
    # consumes its trace id under the gokey — the SAME key the TLS
    # uprobe programs build, which is what chains a decrypted read to
    # this goroutine's plaintext egress across sources and threads
    a.ldx_mem(BPF_DW, R1, R10, _GOIDVAL)
    a.jmp_imm(BPF_JEQ, R1, 0, "pidkey")
    a.stx_mem(BPF_DW, R10, R1, _KEY)
    a.label("pidkey")
    # syscall latency = now - enter_ts, clamped to u32 ns (~4.3s cap):
    # rides the record fd word's high half (the fd itself is a small
    # int) so the wire image stays 192B. The userspace io-event gate
    # (reference: trace_io_event_common, socket_trace.c:2393) needs it
    # to attach slow file-IO spans to in-flight traces.
    a.call(FN_ktime_get_ns)
    a.mov_reg(R1, R0)
    a.ldx_mem(BPF_DW, R2, R10, _SCRATCH)           # enter_ts
    a.jmp_imm(BPF_JEQ, R2, 0, "lat_zero")          # old/faulted stash
    a.alu_reg(BPF_SUB, R1, R2)
    a.mov32_imm(R2, 0xFFFFFFFF)
    a.jmp_reg(BPF_JGT, R1, R2, "lat_cap")
    a.jmp("lat_done")
    a.label("lat_cap").mov_reg(R1, R2)
    a.jmp("lat_done")
    a.label("lat_zero").mov_imm(R1, 0)
    a.label("lat_done")
    a.stx_mem(BPF_DW, R10, R1, _SCRATCH)           # latency slot
    # ret bytes (kretprobe: pt_regs->ax); <= 0 = error/EOF, no record
    a.ldx_mem(BPF_DW, R8, R6, _PT_AX)
    a.jmp_imm(BPF_JSLE, R8, 0, "done")
    a.jmp_imm(BPF_JGT, R8, PAYLOAD_CAP, "clamp")
    a.jmp("len_ok")
    a.label("clamp").mov_imm(R8, PAYLOAD_CAP)
    a.label("len_ok")
    emit_record_tail(a, maps, direction, msghdr_check=True,
                     latency_slot=_SCRATCH)
    a.label("done")
    a.exit_imm(0)
    return a


def emit_record_tail(a: Asm, maps, direction: int, source: int = 0,
                     msghdr_check: bool = False,
                     latency_slot: int = None) -> Asm:
    """The shared SOCK_DATA record build + trace-id discipline + perf
    emit — the tail every record-producing exit program ends with
    (syscall kretprobes here; SSL/Go-TLS uprobe exits in
    agent/uprobe_trace.py, which is why `maps` is duck-typed: anything
    with .trace/.conf/.events Map attributes).

    Register/stack CONTRACT on entry (the callers' prologues establish
    it): R6=ctx, R7=pid_tgid, R8=payload length already clamped to
    (0, PAYLOAD_CAP], R9=user buffer pointer (or user_msghdr* when
    `msghdr_check` and the _FLAG slot is nonzero), _KEY holds the
    caller's park/consume key — pid_tgid here and for pid_tgid-keyed
    uprobe callers, the bit63|tgid|goid key for goid-keyed Go-TLS
    callers (uprobe_trace._goid_rekey) — and _FDSAVE the fd. The
    record's own pid_tgid field always comes from R7, whatever the
    key shape. Jumps target the "done" label the CALLER must
    place before its exit. `source` is the reference's
    process_data_extra_source (common.h:79): packed into the record's
    direction word's high half — SOURCE_SYSCALL (0) keeps the word
    byte-identical to pre-uprobe records."""
    # zero the whole record: the verifier requires every byte a helper
    # reads (perf_event_output) to be initialized, and holes must not
    # leak stale stack to userspace
    for k in range(RECORD_SIZE // 8):
        a.st_imm(BPF_DW, R10, _REC + 8 * k, 0)
    a.stx_mem(BPF_DW, R10, R7, _REC + 0)           # pid_tgid
    a.call(FN_ktime_get_ns)
    a.stx_mem(BPF_DW, R10, R0, _REC + 8)           # timestamp
    # -- trace-id discipline (socket_trace.c:960-1060 park/consume) ----
    if direction == T_INGRESS:
        # continuation first (socket_trace.c: ingress on the SAME
        # socket continues the parked id — an HTTP request arriving
        # over several read()s must not fragment into several traces);
        # a different socket's ingress allocates fresh and re-parks
        a.ld_map_fd(R1, maps.trace)
        a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _KEY)
        a.call(FN_map_lookup_elem)
        a.jmp_imm(BPF_JEQ, R0, 0, "alloc")
        a.ldx_mem(BPF_DW, R1, R0, 0)               # parked id
        a.ldx_mem(BPF_DW, R2, R0, 8)               # parked fd
        a.ldx_mem(BPF_DW, R3, R10, _FDSAVE)
        a.jmp_reg(BPF_JNE, R2, R3, "alloc")
        a.stx_mem(BPF_DW, R10, R1, _REC + 16)      # same socket: reuse
        a.jmp("no_trace")
        a.label("alloc")
        a.st_imm(BPF_W, R10, _CONFKEY, 0)
        a.ld_map_fd(R1, maps.conf)
        a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _CONFKEY)
        a.call(FN_map_lookup_elem)
        a.jmp_imm(BPF_JEQ, R0, 0, "no_trace")
        a.mov_imm(R1, 1)
        a.atomic_fetch_add(BPF_DW, R0, R1, 0)      # R1 = allocated id
        a.stx_mem(BPF_DW, R10, R1, _REC + 16)
        a.stx_mem(BPF_DW, R10, R1, _TRVAL)
        a.ldx_mem(BPF_DW, R1, R10, _FDSAVE)
        a.stx_mem(BPF_DW, R10, R1, _TRVAL + 8)
        a.ld_map_fd(R1, maps.trace)
        a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _KEY)
        a.mov_reg(R3, R10).alu_imm(BPF_ADD, R3, _TRVAL)
        a.mov_imm(R4, 0)
        a.call(FN_map_update_elem)
    else:
        # consume: the id parked by this thread's last ingress
        a.ld_map_fd(R1, maps.trace)
        a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _KEY)
        a.call(FN_map_lookup_elem)
        a.jmp_imm(BPF_JEQ, R0, 0, "no_trace")
        a.ldx_mem(BPF_DW, R1, R0, 0)
        a.stx_mem(BPF_DW, R10, R1, _REC + 16)
        a.ld_map_fd(R1, maps.trace)
        a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _KEY)
        a.call(FN_map_delete_elem)
    a.label("no_trace")
    # capture sequence: conf[1] fetch-add
    a.st_imm(BPF_W, R10, _CONFKEY, 1)
    a.ld_map_fd(R1, maps.conf)
    a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _CONFKEY)
    a.call(FN_map_lookup_elem)
    a.jmp_imm(BPF_JEQ, R0, 0, "no_seq")
    a.mov_imm(R1, 1)
    a.atomic_fetch_add(BPF_DW, R0, R1, 0)
    a.stx_mem(BPF_DW, R10, R1, _REC + 24)
    a.label("no_seq")
    a.ldx_mem(BPF_DW, R1, R10, _FDSAVE)
    if latency_slot is not None:
        # fd word = fd | latency_ns << 32 — _FDSAVE itself stays the
        # PURE fd (the trace park value and its continuation compare
        # use it; a latency-tainted fd would break same-socket
        # continuation). Only the emitted record carries the packing.
        a.alu_imm(BPF_LSH, R1, 32).alu_imm(BPF_RSH, R1, 32)
        a.ldx_mem(BPF_DW, R2, R10, latency_slot)
        a.alu_imm(BPF_LSH, R2, 32)
        a.alu_reg(BPF_OR, R1, R2)
    a.stx_mem(BPF_DW, R10, R1, _REC + 32)          # fd
    a.st_imm(BPF_W, R10, _REC + 40,
             direction | (source << 16))           # dir | source<<16
    a.stx_mem(BPF_W, R10, R8, _REC + 44)           # data_len
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _REC + 48)
    a.mov_imm(R2, 16)
    a.call(FN_get_current_comm)
    if msghdr_check:
        # msghdr shape: two probe_read hops to the first iovec's base
        a.ldx_mem(BPF_DW, R1, R10, _FLAG)
        a.jmp_imm(BPF_JEQ, R1, 0, "copy")
        a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _SCRATCH)
        a.mov_imm(R2, 8)
        a.mov_reg(R3, R9).alu_imm(BPF_ADD, R3, _MSG_IOV_OFF)
        a.call(FN_probe_read)
        a.ldx_mem(BPF_DW, R9, R10, _SCRATCH)       # iov*
        # whole first iovec {iov_base, iov_len} in ONE 16B probe_read
        # (advisor r4): a scattered sendmsg whose FIRST iovec is
        # shorter than the ret-clamped length must not capture
        # adjacent process memory — clamp the copy to
        # min(ret, iov_len, CAP) like the reference does
        a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _IOVPAIR)
        a.mov_imm(R2, 16)
        a.mov_reg(R3, R9)
        a.call(FN_probe_read)
        a.ldx_mem(BPF_DW, R9, R10, _IOVPAIR + _IOV_BASE_OFF)
        a.ldx_mem(BPF_DW, R1, R10, _IOVPAIR + _IOV_LEN_OFF)
        # verifier-friendly clamp: the JGT pins R1 <= CAP on
        # fallthrough (an imm bound the verifier tracks precisely),
        # so the mov leaves R8 bounded for the copy's size argument
        a.jmp_imm(BPF_JGT, R1, PAYLOAD_CAP, "iov_ok")
        a.jmp_reg(BPF_JGE, R1, R8, "iov_ok")
        a.mov_reg(R8, R1)
        a.stx_mem(BPF_W, R10, R8, _REC + 44)       # data_len reflects
        a.jmp_imm(BPF_JEQ, R8, 0, "emit")          # empty iovec
        a.label("iov_ok")
    a.label("copy")
    # bounded payload copy: R8 in (0, PAYLOAD_CAP] by the clamp above
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _REC + 64)
    a.mov_reg(R2, R8)
    a.mov_reg(R3, R9)
    a.call(FN_probe_read)
    a.jmp_imm(BPF_JEQ, R0, 0, "emit")
    a.st_imm(BPF_W, R10, _REC + 44, 0)             # faulted: len 0
    a.label("emit")
    # perf_event_output(ctx, events, CURRENT_CPU, rec, RECORD_SIZE)
    a.mov_reg(R1, R6)
    a.ld_map_fd(R2, maps.events)
    a.mov32_imm(R3, 0xFFFFFFFF)                    # BPF_F_CURRENT_CPU
    a.mov_reg(R4, R10).alu_imm(BPF_ADD, R4, _REC)
    a.mov_imm(R5, RECORD_SIZE)
    a.call(FN_perf_event_output)
    return a


# attach matrix: syscall -> (enter shape, exit direction)
SYSCALLS = {
    "read": ("buf", T_INGRESS),
    "recvmsg": ("msg", T_INGRESS),
    "write": ("buf", T_EGRESS),
    "sendmsg": ("msg", T_EGRESS),
}


class SocketTraceSuite:
    """The loaded program set + maps. Construction runs every program
    through the kernel verifier; failure raises with the verifier log
    (bpf.load surfaces it)."""

    def __init__(self) -> None:
        self.maps = create_maps()
        loaded: List[Program] = []
        try:
            for builder in (lambda: build_enter(self.maps, is_msg=False),
                            lambda: build_enter(self.maps, is_msg=True),
                            lambda: build_exit(self.maps, T_INGRESS),
                            lambda: build_exit(self.maps, T_EGRESS)):
                loaded.append(self._load(builder()))
        except OSError:
            # a kernel that rejects one program (e.g. pre-5.12 lacks
            # BPF_ATOMIC|BPF_FETCH) must not leak the maps or the
            # programs already loaded — probing callers retry
            for p in loaded:
                p.close()
            self.maps.close()
            raise
        (self.enter_buf, self.enter_msg,
         self.exit_ingress, self.exit_egress) = loaded

    @staticmethod
    def _load(asm: Asm) -> Program:
        return load(asm.assemble(), prog_type=BPF_PROG_TYPE_KPROBE)

    def programs(self) -> Dict[str, Tuple[Program, Program]]:
        """syscall -> (enter program, exit program), the kprobe/
        kretprobe pair to attach per SYSCALLS."""
        enter = {"buf": self.enter_buf, "msg": self.enter_msg}
        exit_ = {T_INGRESS: self.exit_ingress, T_EGRESS: self.exit_egress}
        return {name: (enter[shape], exit_[direction])
                for name, (shape, direction) in SYSCALLS.items()}

    def close(self) -> None:
        for p in (self.enter_buf, self.enter_msg, self.exit_ingress,
                  self.exit_egress):
            p.close()
        self.maps.close()


_ATTACH_CACHE: Optional[Tuple[bool, str]] = None


def attach_available() -> Tuple[bool, str]:
    """CAPABILITY probe: could kprobes be attached here? Needs the
    kprobe PMU (perf_event_open) or tracefs kprobe_events — both
    typically masked in containers. This reports capability only; the
    attach/perf-reader wiring that would switch the agent from the
    replay path to the kernel source keys off it. Cached: the answer is
    static per process and the available() gate costs real bpf(2)
    syscalls (a debug-dump poll loop must not re-pay them)."""
    global _ATTACH_CACHE
    if _ATTACH_CACHE is not None:
        return _ATTACH_CACHE
    if not available():
        _ATTACH_CACHE = (False, "bpf(2) unavailable")
    elif os.path.exists("/sys/bus/event_source/devices/kprobe/type"):
        _ATTACH_CACHE = (True, "kprobe PMU")
    else:
        for tracefs in ("/sys/kernel/tracing",
                        "/sys/kernel/debug/tracing"):
            if os.access(os.path.join(tracefs, "kprobe_events"), os.W_OK):
                _ATTACH_CACHE = (True, f"tracefs at {tracefs}")
                break
        else:
            _ATTACH_CACHE = (False,
                             "no kprobe PMU and no writable tracefs")
    return _ATTACH_CACHE


def parse_record(buf: bytes,
                 resolver: Optional[Callable] = None) -> "SyscallRecord":
    """One SOCK_DATA record -> the SyscallRecord the EbpfTracer
    pipeline consumes — the kernel source and the fixture replay are
    interchangeable above this line. `resolver(pid, fd)` may supply
    ((ip_src, ip_dst, port_src, port_dst)) from /proc; without it the
    flow tuple is zeros (sessions still pair per pid/fd/direction)."""
    from deepflow_tpu_torch.agent.ebpf_source import SyscallRecord

    (pid_tgid, ts, trace_id, cap_seq, fd_word, dirword, data_len, comm,
     payload) = struct.unpack(_RECORD_FMT, buf[:RECORD_SIZE])
    direction, source = dirword & 0xFFFF, dirword >> 16
    tgid, tid = pid_tgid >> 32, pid_tgid & 0xFFFFFFFF
    # fd word: fd in the low half, syscall latency (u32 ns, clamped in
    # kernel) in the high half — records from pre-latency sources have
    # 0 there, which reads as latency 0
    fd, latency_ns = fd_word & 0xFFFFFFFF, fd_word >> 32
    ips = (0, 0, 0, 0)
    if resolver is not None:
        got = resolver(tgid, fd)
        if got is not None:
            # resolver convention: (local, remote, lport, rport). The
            # record convention is ip_src = SENDER of the data, so an
            # ingress record (remote peer sent it) swaps the tuple —
            # otherwise every live inbound request exports client and
            # server reversed
            if direction == T_INGRESS:
                ips = (got[1], got[0], got[3], got[2])
            else:
                ips = got
    return SyscallRecord(
        pid=tgid, tid=tid, direction=direction, source=source, fd=fd,
        timestamp_ns=ts,
        ip_src=ips[0], ip_dst=ips[1], port_src=ips[2], port_dst=ips[3],
        cap_seq=cap_seq,
        latency_ns=latency_ns,
        process_kname=comm.split(b"\0", 1)[0].decode("latin-1"),
        payload=payload[:min(data_len, PAYLOAD_CAP)],
        kernel_trace_id=trace_id,
        from_kernel=True,
    )


def pack_record(pid: int, tid: int, direction: int, ts_ns: int,
                payload: bytes, fd: int = 3, trace_id: int = 0,
                cap_seq: int = 0, comm: str = "",
                source: int = SOURCE_SYSCALL,
                latency_ns: int = 0) -> bytes:
    """Build a SOCK_DATA record byte-image (tests + fixture replay in
    the kernel wire format — the inverse of parse_record). latency_ns
    rides the fd word's high half exactly as the kernel packs it."""
    fd_word = (fd & 0xFFFFFFFF) | (min(latency_ns, 0xFFFFFFFF) << 32)
    return struct.pack(
        _RECORD_FMT, (pid << 32) | tid, ts_ns, trace_id, cap_seq,
        fd_word, direction | (source << 16),
        min(len(payload), PAYLOAD_CAP),
        comm.encode("latin-1")[:16],
        payload[:PAYLOAD_CAP])
