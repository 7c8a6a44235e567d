"""Go HTTP/2 uprobe suite: header-level capture above HPACK, in-tree.

Reference: agent/src/ebpf/kernel/go_http2_bpf.c (1187 LoC) — uprobes
on the Go http2 internals capture DECODED header fields where the
byte stream is out of reach: `(*http2ClientConn).writeHeader(name,
value string)` fires once per request header, `writeHeaders(streamID,
...)` marks the header block's end, and the server-side mirrors them;
events carry (fd, stream id, k/v) and stream to userspace tagged
DATA_SOURCE_GO_HTTP2_UPROBE, where header groups reassemble into L7
requests. The fd comes from walking the conn struct with per-binary
offsets in proc_info_map, and unmanaged processes are skipped
(skip_http2_uprobe).

This module rebuilds that on the in-tree toolkit:

- kernel programs (agent/bpf.py assembler, kernel-verifier-loaded):
  `build_header_event` (one per-header event: clamped name/value
  copied at FIXED payload offsets — constant offsets are what the
  verifier can check) and `build_headers_end` (the end marker carrying
  the stream id). Both gate on the `http2_info` map (per-process
  offsets: tconn interface offset -> net.conn fd walk, stream-id
  offset, regabi flag) so an unmanaged process pays two map misses.
  Both Go ABIs: register (>= 1.17) and stack (< 1.17, every argument
  read becomes a probe_read of SP+8k — go_http2_bpf.c:26-29's branch,
  here as separate per-flavor programs selected by the attach plan).
- events ride the standard 192B SOCK_DATA wire (socket_trace.py)
  with SOURCE_GO_HTTP2_UPROBE in the direction word, so the perf
  reader and EbpfTracer plumbing need nothing new;
- `Http2Assembler` groups events per (pid, fd, stream, side) and, at
  the end marker, synthesizes an HTTP/1-shaped header block (pseudo-
  headers :method/:path/:authority/:status become request/status
  lines) — the existing deep HTTP parser then extracts method, path,
  host, UA, and trace context exactly as it does for every other
  source, and the l7 row comes out version="2", is_tls flagged
  (GO_HTTP2 is a TLS source).
- `plan_go_http2` resolves the probe sites (net/http and vendored
  golang.org/x/net/http2 symbol spellings, like go_tracer.c's table).

The server-side processHeaders slice walk IS authored too
(`build_process_headers`): a bounded unrolled loop (the reference's
`#pragma unroll` 9-field cap) copies already-HPACK-decoded
hpack.HeaderField entries from the MetaHeadersFrame's Fields slice,
one READ event each plus the READ|END marker with the frame's stream
id — the read-side leg for traffic whose byte stream is unreachable.

The port's own copy of the JAX package's `agent/http2_trace.py` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from deepflow_tpu_torch.agent.bpf import (BPF_ADD, BPF_DW, BPF_JEQ, BPF_JGT,
                                          BPF_JLE, BPF_JLT, BPF_JNE, BPF_LSH,
                                          BPF_MAP_TYPE_HASH, BPF_OR,
                                          BPF_PROG_TYPE_KPROBE, BPF_RSH,
                                          BPF_SUB, BPF_W,
                                          FN_get_current_comm,
                                          FN_get_current_pid_tgid,
                                          FN_ktime_get_ns,
                                          FN_map_lookup_elem,
                                          FN_perf_event_output,
                                          FN_probe_read,
                                          R0, R1, R2, R3, R4, R5, R6, R7, R8,
                                          R9, R10, Asm, Map, Program, load)
from deepflow_tpu_torch.agent.socket_trace import (RECORD_SIZE,
                                                   SOURCE_GO_HTTP2_UPROBE,
                                                   SocketTraceMaps, T_EGRESS,
                                                   T_INGRESS, create_maps)
from deepflow_tpu_torch.agent.socket_trace import (_FDSAVE, _KEY,  # noqa
                                                   _PT_AX, _REC, _SCRATCH)
from deepflow_tpu_torch.agent.uprobe_trace import (_GOSTASH, _PIKEY,  # noqa
                                                   _PT_BX, _PT_CX, _PT_SP,
                                                   UprobeSpec, elf_func_table,
                                                   go_version,
                                                   vaddr_to_offset)

_PT_SI, _PT_DI = 104, 112

# per-binary walk defaults (go_tracer.c data_members:
# net/http.http2ClientConn.tconn default 8, .nextStreamID default 176;
# the interface's net.conn fd walk reuses the tls defaults)
GO_HTTP2_DEFAULT_INFO = {"tconn_off": 8, "fd_off": 0, "sysfd_off": 16,
                         "stream_off": 176}

# server-side (http2serverConn) walk constants — the go_tracer.c
# data_members defaults: serverConn.conn at +16,
# MetaHeadersFrame.Fields at +8, FrameHeader.StreamID at +8 after one
# deref; hpack.HeaderField is {Name string, Value string, Sensitive
# bool} = 40B stride
_SRV_CONN_OFF = 16
_FIELDS_OFF = 8
_FRAME_STREAM_OFF = 8
_FIELD_STRIDE = 40
MAX_FIELDS = 9           # the reference's unrolled bound (#pragma
                         # unroll for idx < 9, go_http2_bpf.c:476)

# extra stack slots (below uprobe_trace's frame, which ends at -336
# since the goid slots _GOIDVAL/-328 and _GOIDOFF/-336 joined it —
# keeping the modules' frames disjoint is what lets these programs
# call shared uprobe_trace helpers safely)
_FRAME = -344            # saved MetaHeadersFrame*
_FIELDSV = -360          # fields slice {data ptr, len} (16B)
_FIELD = -400            # one copied HeaderField (40B)
_STREAMSV = -408         # stream id
_ARGSLOT = -416          # stack-ABI argument probe_read target

# event layout inside the SOCK_DATA payload (offsets from _REC+64):
#   u32 stream | u8 flags | u8 name_len | u8 value_len | u8 pad
#   name[64] at +8 | value[56] at +72       -> 128B = PAYLOAD_CAP
EV_FLAG_END = 1          # end-of-header-block marker
EV_FLAG_READ = 2         # read side (server-processed headers)
NAME_CAP, VALUE_CAP = 64, 56
_EV_FMT = "<IBBBx"
_PAYLOAD_OFF = 64        # payload offset inside the record


@dataclass
class Http2Maps:
    """http2_info: tgid -> {reg_abi, tconn_off, fd_off, sysfd_off,
    stream_off, pad} (24B — go_http2_bpf.c's proc_info offsets for
    the http2ClientConn walk); shared trace/conf/events as usual."""

    http2_info: Map
    shared: SocketTraceMaps
    owns_shared: bool = False

    @property
    def events(self) -> Map:
        return self.shared.events

    def set_info(self, tgid: int, reg_abi: bool = True,
                 tconn_off: int = 0, fd_off: int = 0,
                 sysfd_off: int = 16, stream_off: int = 0) -> None:
        self.http2_info.update_bytes(
            struct.pack("<I", tgid),
            struct.pack("<IIIIII", 1 if reg_abi else 0, tconn_off,
                        fd_off, sysfd_off, stream_off, 0))

    def close(self) -> None:
        self.http2_info.close()
        if self.owns_shared:
            self.shared.close()


def create_http2_maps(
        shared: Optional[SocketTraceMaps] = None) -> Http2Maps:
    owns = shared is None
    if shared is None:
        shared = create_maps()
    try:
        info = Map(1024, 24, BPF_MAP_TYPE_HASH, 4)
    except OSError:
        if owns:
            shared.close()
        raise
    return Http2Maps(info, shared=shared, owns_shared=owns)


def _load_arg(a: Asm, reg_abi: bool, idx: int, pt_off: int,
              dst) -> None:
    """Go argument `idx` (0 = receiver) -> dst register. Register ABI
    reads the mapped pt_regs register directly; stack ABI (go < 1.17)
    probe_reads the caller-pushed slot at SP + 8 + 8*idx (SP points at
    the return address at a function-entry uprobe) — the exact branch
    go_http2_bpf.c:26-29 takes per argument. Stack mode clobbers
    R1-R3 and _ARGSLOT; callers set probe_read args AFTER the load."""
    if reg_abi:
        a.ldx_mem(BPF_DW, dst, R6, pt_off)
        return
    a.ldx_mem(BPF_DW, R3, R6, _PT_SP)
    a.alu_imm(BPF_ADD, R3, 8 + 8 * idx)
    a.st_imm(BPF_DW, R10, _ARGSLOT, 0)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _ARGSLOT)
    a.mov_imm(R2, 8)
    a.call(FN_probe_read)
    a.ldx_mem(BPF_DW, dst, R10, _ARGSLOT)


def _prologue(a: Asm, maps: Http2Maps, reg_abi: bool = True) -> None:
    """ctx->R6, pid_tgid->R7/_KEY, http2_info lookup (absent ->
    "done"), offsets copied to the stack: tconn_off -> _SCRATCH(W),
    fd/sysfd/stream offs -> _GOSTASH+0/+4/+8 (W each)."""
    a.mov_reg(R6, R1)
    a.call(FN_get_current_pid_tgid)
    a.mov_reg(R7, R0)
    a.stx_mem(BPF_DW, R10, R7, _KEY)
    a.mov_reg(R1, R7).alu_imm(BPF_RSH, R1, 32)
    a.stx_mem(BPF_W, R10, R1, _PIKEY)
    a.ld_map_fd(R1, maps.http2_info)
    a.mov_reg(R2, R10).alu_imm(BPF_ADD, R2, _PIKEY)
    a.call(FN_map_lookup_elem)
    a.jmp_imm(BPF_JEQ, R0, 0, "done")
    # each program is built for ONE ABI; a process pushed with the
    # other flavor must exit here, not read garbage arg sources
    a.ldx_mem(BPF_W, R1, R0, 0)                    # reg_abi
    a.jmp_imm(BPF_JEQ if reg_abi else BPF_JNE, R1, 0, "done")
    a.ldx_mem(BPF_W, R1, R0, 4)                    # tconn_off
    a.stx_mem(BPF_W, R10, R1, _SCRATCH)
    a.ldx_mem(BPF_W, R1, R0, 8)                    # fd_off
    a.stx_mem(BPF_W, R10, R1, _GOSTASH + 0)
    a.ldx_mem(BPF_W, R1, R0, 12)                   # sysfd_off
    a.stx_mem(BPF_W, R10, R1, _GOSTASH + 4)
    a.ldx_mem(BPF_W, R1, R0, 16)                   # stream_off
    a.stx_mem(BPF_W, R10, R1, _GOSTASH + 8)


def _fd_walk(a: Asm, reg_abi: bool = True) -> None:
    """Receiver (arg 0) -> tconn iface data -> net.conn fd -> Sysfd,
    via the stacked offsets; result (u32, zero-filled on fault) lands
    in _FDSAVE. Mirrors get_fd_from_http2ClientConn
    (go_http2_bpf.c:51-64)."""
    _load_arg(a, reg_abi, 0, _PT_AX, R8)           # receiver
    a.ldx_mem(BPF_W, R3, R10, _SCRATCH)
    a.alu_reg(BPF_ADD, R3, R8).alu_imm(BPF_ADD, R3, 8)   # iface data
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _GOSTASH + 16)
    a.mov_imm(R2, 8)
    a.call(FN_probe_read)
    a.ldx_mem(BPF_DW, R8, R10, _GOSTASH + 16)
    a.st_imm(BPF_DW, R10, _FDSAVE, 0)
    a.jmp_imm(BPF_JEQ, R8, 0, "fd_done")
    a.ldx_mem(BPF_W, R3, R10, _GOSTASH + 0)
    a.alu_reg(BPF_ADD, R3, R8)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _GOSTASH + 16)
    a.mov_imm(R2, 8)
    a.call(FN_probe_read)
    a.ldx_mem(BPF_DW, R8, R10, _GOSTASH + 16)
    a.jmp_imm(BPF_JEQ, R8, 0, "fd_done")
    a.ldx_mem(BPF_W, R3, R10, _GOSTASH + 4)
    a.alu_reg(BPF_ADD, R3, R8)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _FDSAVE)
    a.mov_imm(R2, 4)
    a.call(FN_probe_read)
    a.label("fd_done")


def _emit_event(a: Asm, maps: Http2Maps, direction: int) -> None:
    """Zero + fill the SOCK_DATA framing (pid/ts/fd/dir|source/comm,
    data_len = 128) and perf-output the record. The event body must
    already sit in the payload area."""
    a.stx_mem(BPF_DW, R10, R7, _REC + 0)
    a.call(FN_ktime_get_ns)
    a.stx_mem(BPF_DW, R10, R0, _REC + 8)
    a.st_imm(BPF_DW, R10, _REC + 16, 0)            # trace id: none
    a.st_imm(BPF_DW, R10, _REC + 24, 0)
    a.ldx_mem(BPF_DW, R1, R10, _FDSAVE)
    a.stx_mem(BPF_DW, R10, R1, _REC + 32)
    a.st_imm(BPF_W, R10, _REC + 40,
             direction | (SOURCE_GO_HTTP2_UPROBE << 16))
    a.st_imm(BPF_W, R10, _REC + 44, 128)           # data_len = cap
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _REC + 48)
    a.mov_imm(R2, 16)
    a.call(FN_get_current_comm)
    a.mov_reg(R1, R6)
    a.ld_map_fd(R2, maps.events)
    a.mov32_imm(R3, 0xFFFFFFFF)
    a.mov_reg(R4, R10).alu_imm(BPF_ADD, R4, _REC)
    a.mov_imm(R5, RECORD_SIZE)
    a.call(FN_perf_event_output)


def _zero_record(a: Asm) -> None:
    for k in range(RECORD_SIZE // 8):
        a.st_imm(BPF_DW, R10, _REC + 8 * k, 0)


def _clamp_reg(a: Asm, reg: int, cap: int, tag: str) -> None:
    """Immediate-bound clamp (the verifier-trackable form) shared by
    every name/value length in this module — ONE copy of the caps
    contract."""
    a.jmp_imm(BPF_JGT, reg, cap, f"clamp_{tag}")
    a.jmp(f"ok_{tag}")
    a.label(f"clamp_{tag}").mov_imm(reg, cap)
    a.label(f"ok_{tag}")


def _pack_flags_word(a: Asm, flags: int) -> None:
    """R8=name_len, R9=value_len -> the packed little-endian event
    word (flags | name_len<<8 | value_len<<16) at payload+4 — ONE
    copy of the wire layout parse_event reads back."""
    a.mov_reg(R1, R9)
    a.mov_reg(R2, R8)
    a.alu_imm(BPF_LSH, R1, 16)
    a.alu_imm(BPF_LSH, R2, 8)
    a.alu_reg(BPF_OR, R1, R2)
    if flags:
        a.alu_imm(BPF_OR, R1, flags)
    a.stx_mem(BPF_W, R10, R1, _REC + _PAYLOAD_OFF + 4)


def build_header_event(maps: Http2Maps, direction: int,
                       reg_abi: bool = True) -> Asm:
    """uprobe on writeHeader(name, value string) (go_http2_bpf.c:540):
    one per-header event. Register ABI: receiver AX, name {ptr BX,
    len CX}, value {ptr DI, len SI}; stack ABI: the same five args at
    SP+8..SP+40. Name/value copy to FIXED payload offsets with
    immediate-bounded lengths."""
    a = Asm()
    _prologue(a, maps, reg_abi)
    _fd_walk(a, reg_abi)
    _zero_record(a)
    # stream id: *(receiver + stream_off), best-effort (cc.nextID)
    _load_arg(a, reg_abi, 0, _PT_AX, R8)
    a.ldx_mem(BPF_W, R3, R10, _GOSTASH + 8)
    a.jmp_imm(BPF_JEQ, R3, 0, "no_stream")
    a.alu_reg(BPF_ADD, R3, R8)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _REC + _PAYLOAD_OFF)
    a.mov_imm(R2, 4)
    a.call(FN_probe_read)
    # cc.nextStreamID is the NEXT (odd) client stream; the one being
    # written is next-2 (go_http2_bpf.c:566-568's `data.stream -= 2`
    # for go >= 1.16 — plan_go_http2 refuses older binaries, so both
    # ABI flavors here are >= 1.16), so the header events key under
    # the SAME id the end marker carries
    a.ldx_mem(BPF_W, R1, R10, _REC + _PAYLOAD_OFF)
    a.jmp_imm(BPF_JLT, R1, 2, "no_stream")
    a.alu_imm(BPF_SUB, R1, 2)
    a.stx_mem(BPF_W, R10, R1, _REC + _PAYLOAD_OFF)
    a.label("no_stream")
    _load_arg(a, reg_abi, 2, _PT_CX, R8)           # name len
    _clamp_reg(a, R8, NAME_CAP, "n")
    _load_arg(a, reg_abi, 4, _PT_SI, R9)           # value len
    _clamp_reg(a, R9, VALUE_CAP, "v")
    _pack_flags_word(a, 0)
    # name copy (bounded by the clamp above; the arg load must come
    # FIRST — stack mode clobbers R1-R3)
    _load_arg(a, reg_abi, 1, _PT_BX, R3)           # name ptr
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1,
                               _REC + _PAYLOAD_OFF + 8)
    a.mov_reg(R2, R8)
    a.call(FN_probe_read)
    # value copy
    _load_arg(a, reg_abi, 3, _PT_DI, R3)           # value ptr
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1,
                               _REC + _PAYLOAD_OFF + 8 + NAME_CAP)
    a.mov_reg(R2, R9)
    a.call(FN_probe_read)
    _emit_event(a, maps, direction)
    a.label("done")
    a.exit_imm(0)
    return a


def build_headers_end(maps: Http2Maps, direction: int,
                      reg_abi: bool = True) -> Asm:
    """uprobe on writeHeaders(streamID uint32, ...): the end-of-block
    marker (go_http2_bpf.c:600 — MSG_REQUEST_END role). Register ABI:
    streamID in BX; stack ABI: SP+16."""
    a = Asm()
    _prologue(a, maps, reg_abi)
    _fd_walk(a, reg_abi)
    _zero_record(a)
    _load_arg(a, reg_abi, 1, _PT_BX, R1)           # streamID
    a.stx_mem(BPF_W, R10, R1, _REC + _PAYLOAD_OFF)
    a.st_imm(BPF_W, R10, _REC + _PAYLOAD_OFF + 4, EV_FLAG_END)
    _emit_event(a, maps, direction)
    a.label("done")
    a.exit_imm(0)
    return a


def build_process_headers(maps: Http2Maps,
                          reg_abi: bool = True) -> Asm:
    """uprobe on (*http2serverConn).processHeaders(f
    *http2MetaHeadersFrame) — the server-side READ leg
    (go_http2_bpf.c:648-681 + submit_http2_headers:451-496): walk up
    to MAX_FIELDS already-HPACK-decoded header fields from the
    frame's Fields slice, one event each (EV_FLAG_READ), then the
    END marker carrying the frame's stream id. The per-binary struct
    offsets use the reference defaults baked above (a per-process
    override would need a second map row; subset documented)."""
    a = Asm()
    _prologue(a, maps, reg_abi)
    # frame* = arg 1 (BX register ABI / SP+16 stack ABI — the
    # prologue gated on the matching flavor)
    _load_arg(a, reg_abi, 1, _PT_BX, R8)
    a.stx_mem(BPF_DW, R10, R8, _FRAME)
    # fd via the serverConn.conn walk: override the prologue's
    # client-side tconn offset with the server struct's
    a.st_imm(BPF_W, R10, _SCRATCH, _SRV_CONN_OFF)
    _fd_walk(a, reg_abi)
    # stream: p = *(frame); stream = *(u32)(p + _FRAME_STREAM_OFF)
    a.ldx_mem(BPF_DW, R3, R10, _FRAME)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _FIELDSV)
    a.mov_imm(R2, 8)
    a.call(FN_probe_read)
    a.ldx_mem(BPF_DW, R3, R10, _FIELDSV)
    a.alu_imm(BPF_ADD, R3, _FRAME_STREAM_OFF)
    a.st_imm(BPF_DW, R10, _STREAMSV, 0)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _STREAMSV)
    a.mov_imm(R2, 4)
    a.call(FN_probe_read)
    # fields slice {data, len} at frame + _FIELDS_OFF, one 16B read
    a.ldx_mem(BPF_DW, R3, R10, _FRAME)
    a.alu_imm(BPF_ADD, R3, _FIELDS_OFF)
    a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _FIELDSV)
    a.mov_imm(R2, 16)
    a.call(FN_probe_read)
    # a faulted frame walk zero-fills: a NULL fields pointer means
    # nothing was decoded — emit NOTHING (an unconditional END marker
    # would fabricate an empty 200-status block downstream)
    a.ldx_mem(BPF_DW, R1, R10, _FIELDSV)
    a.jmp_imm(BPF_JEQ, R1, 0, "done")

    def _one_record(end: bool) -> None:
        """Zero + fill + emit one event record; for non-end records
        the caller copied name/value into _FIELD first."""
        _zero_record(a)
        a.ldx_mem(BPF_DW, R1, R10, _STREAMSV)
        a.stx_mem(BPF_W, R10, R1, _REC + _PAYLOAD_OFF)
        if end:
            a.st_imm(BPF_W, R10, _REC + _PAYLOAD_OFF + 4,
                     EV_FLAG_READ | EV_FLAG_END)
        else:
            # name/value lens were clamped into R8/R9 by the caller
            _pack_flags_word(a, EV_FLAG_READ)
            # bounded copies from the field's go-string pointers
            a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1,
                                       _REC + _PAYLOAD_OFF + 8)
            a.mov_reg(R2, R8)
            a.ldx_mem(BPF_DW, R3, R10, _FIELD + 0)     # name.ptr
            a.call(FN_probe_read)
            a.mov_reg(R1, R10).alu_imm(
                BPF_ADD, R1, _REC + _PAYLOAD_OFF + 8 + NAME_CAP)
            a.mov_reg(R2, R9)
            a.ldx_mem(BPF_DW, R3, R10, _FIELD + 16)    # value.ptr
            a.call(FN_probe_read)
        _emit_event(a, maps, T_INGRESS)

    for idx in range(MAX_FIELDS):
        # if fields.len <= idx: done (the reference's unrolled bound)
        a.ldx_mem(BPF_DW, R1, R10, _FIELDSV + 8)
        a.jmp_imm(BPF_JLE, R1, idx, "fields_done")
        # copy HeaderField idx: {name{ptr,len}, value{ptr,len}, ...}
        a.ldx_mem(BPF_DW, R3, R10, _FIELDSV)
        a.alu_imm(BPF_ADD, R3, idx * _FIELD_STRIDE)
        a.mov_reg(R1, R10).alu_imm(BPF_ADD, R1, _FIELD)
        a.mov_imm(R2, 32)          # name ptr/len + value ptr/len
        a.call(FN_probe_read)
        a.ldx_mem(BPF_DW, R8, R10, _FIELD + 8)         # name.len
        _clamp_reg(a, R8, NAME_CAP, f"n{idx}")
        a.ldx_mem(BPF_DW, R9, R10, _FIELD + 24)        # value.len
        _clamp_reg(a, R9, VALUE_CAP, f"v{idx}")
        _one_record(end=False)
    a.label("fields_done")
    _one_record(end=True)
    a.label("done")
    a.exit_imm(0)
    return a


class Http2Suite:
    """Loaded program set (all kernel-verifier-checked): every role in
    BOTH ABI flavors — register (go >= 1.17) and stack (go < 1.17,
    args at SP+8k; `<role>_stack` names). The per-process http2_info
    reg_abi flag gates in-program, so a mixed fleet can share one
    suite: each probe only fires usefully on processes of its own
    flavor."""

    def __init__(self,
                 shared: Optional[SocketTraceMaps] = None) -> None:
        self.maps = create_http2_maps(shared)
        self._progs: Dict[str, Program] = {}
        try:
            for abi_name, reg in (("", True), ("_stack", False)):
                for role, builder in (
                        ("header_write",
                         lambda r: build_header_event(
                             self.maps, T_EGRESS, r)),
                        ("header_read",
                         lambda r: build_header_event(
                             self.maps, T_INGRESS, r)),
                        ("end_write",
                         lambda r: build_headers_end(
                             self.maps, T_EGRESS, r)),
                        ("end_read",
                         lambda r: build_headers_end(
                             self.maps, T_INGRESS, r)),
                        ("process_headers",
                         lambda r: build_process_headers(self.maps, r))):
                    self._progs[role + abi_name] = load(
                        builder(reg).assemble(),
                        prog_type=BPF_PROG_TYPE_KPROBE)
        except OSError:
            for p in self._progs.values():
                p.close()
            self.maps.close()
            raise
        (self.header_write, self.header_read,
         self.end_write, self.end_read,
         self.process_headers) = (self._progs[r] for r in (
             "header_write", "header_read", "end_write", "end_read",
             "process_headers"))

    def programs(self) -> Dict[str, Program]:
        return dict(self._progs)

    def close(self) -> None:
        for p in self._progs.values():
            p.close()
        self.maps.close()


# -- userspace: event wire + attach plan -----------------------------------

def pack_event(stream: int, flags: int, name: bytes,
               value: bytes) -> bytes:
    """Event body byte-image (tests/replay — the inverse of
    parse_event, fixed-slot layout like the kernel programs write)."""
    name, value = name[:NAME_CAP], value[:VALUE_CAP]
    return (struct.pack(_EV_FMT, stream, flags, len(name), len(value))
            + name.ljust(NAME_CAP, b"\0")
            + value.ljust(VALUE_CAP, b"\0"))


def parse_event(payload: bytes
                ) -> Optional[Tuple[int, int, bytes, bytes]]:
    """(stream, flags, name, value) from an event payload; None on a
    short/garbled body."""
    if len(payload) < 8 + NAME_CAP + VALUE_CAP:
        return None
    stream, flags, nlen, vlen = struct.unpack_from(_EV_FMT, payload)
    nlen, vlen = min(nlen, NAME_CAP), min(vlen, VALUE_CAP)
    name = payload[8:8 + nlen]
    value = payload[8 + NAME_CAP:8 + NAME_CAP + vlen]
    return stream, flags, name, value


HTTP2_SYMBOLS = {
    # (symbol spelling, role, direction): net/http's bundled copy and
    # the vendored golang.org/x/net/http2 spelling (go_tracer.c:226+)
    "net/http.(*http2ClientConn).writeHeader":
        ("header_write", T_EGRESS),
    "golang.org/x/net/http2.(*ClientConn).writeHeader":
        ("header_write", T_EGRESS),
    "net/http.(*http2ClientConn).writeHeaders":
        ("end_write", T_EGRESS),
    "golang.org/x/net/http2.(*ClientConn).writeHeaders":
        ("end_write", T_EGRESS),
    "net/http.(*http2serverConn).processHeaders":
        ("process_headers", T_INGRESS),
    "golang.org/x/net/http2.(*serverConn).processHeaders":
        ("process_headers", T_INGRESS),
}


def plan_go_http2(path: str) -> List[UprobeSpec]:
    """Entry-uprobe specs for whichever http2 spellings the binary
    carries (no RET probes: header events fire at entry). Roles carry
    the `_stack` suffix for stack-ABI (go < 1.17) binaries so the
    attach loop picks the matching program flavor."""
    from deepflow_tpu_torch.agent.uprobe_trace import (_go_release,
                                                       go_register_abi)
    version = go_version(path)
    if version is None:
        return []
    rel = _go_release(version)
    if rel is not None and rel < (1, 16):
        # the header-event programs apply the reference's
        # `nextStreamID - 2` correction, which go_http2_bpf.c:566-568
        # only applies for go >= 1.16 — on older runtimes it would
        # mis-key every header group against its end marker and
        # silently lose all h2 capture; those runtimes predate
        # mainstream h2 deployment, so they get no probes (loud here,
        # not silent loss downstream)
        return []
    suffix = "" if go_register_abi(version) else "_stack"
    funcs = elf_func_table(path)
    specs: List[UprobeSpec] = []
    for sym, (role, _direction) in HTTP2_SYMBOLS.items():
        if sym not in funcs:
            continue
        vaddr, _size = funcs[sym]
        off = vaddr_to_offset(path, vaddr)
        if off is not None:
            specs.append(UprobeSpec(path, sym, off, role + suffix))
    return specs


# -- userspace: header-group assembly --------------------------------------

class Http2Assembler:
    """Per-(pid, fd, stream, side) header groups -> synthesized
    HTTP/1-shaped payloads at the end marker, so the ordinary deep
    HTTP parser (agent/l7.py) extracts method/path/host/trace context
    from uprobe-captured h2 headers (the role go_http2_bpf.c's
    userspace reassembly plays)."""

    def __init__(self, max_groups: int = 4096,
                 max_headers: int = 64,
                 timeout_ns: int = 30 * 1_000_000_000) -> None:
        # key -> [last_ts_ns, [(name, value), ...]]
        self._groups: Dict[tuple, list] = {}
        self.max_groups = max_groups
        self.max_headers = max_headers
        self.timeout_ns = timeout_ns
        self.events_in = 0
        self.blocks_out = 0
        self.dropped = 0

    def feed(self, rec) -> Optional[bytes]:
        """One SOURCE_GO_HTTP2_UPROBE SyscallRecord in; a synthesized
        header-block payload out when its group completes. Grouped by
        (pid, FD, stream, side): stream ids are per-CONNECTION (two h2
        conns both use 1,3,5...) and goroutines migrate OS threads, so
        fd — walked in-kernel exactly for this — is the connection
        identity, never the tid."""
        ev = parse_event(rec.payload)
        if ev is None:
            self.dropped += 1
            return None
        stream, flags, name, value = ev
        side = T_INGRESS if flags & EV_FLAG_READ else rec.direction
        key = (rec.pid, getattr(rec, "fd", 0), stream, side)
        self.events_in += 1
        if not flags & EV_FLAG_END:
            if len(self._groups) >= self.max_groups \
                    and key not in self._groups:
                self.dropped += 1          # bounded under stream floods
                return None
            if name:
                g = self._groups.setdefault(key, [0, []])
                g[0] = rec.timestamp_ns
                if len(g[1]) < self.max_headers:   # header-flood bound
                    g[1].append((name, value))
                else:
                    self.dropped += 1
            return None
        _, headers = self._groups.pop(key, (0, []))
        self.blocks_out += 1
        return synthesize_block(headers, side)

    def expire(self, now_ns: int) -> int:
        """Drop groups whose END marker never arrived (perf-ring loss
        drops markers; an orphaned group must not pin a max_groups
        slot for the agent's lifetime). EbpfTracer.expire drives
        this."""
        dead = [k for k, g in self._groups.items()
                if now_ns - g[0] > self.timeout_ns]
        for k in dead:
            del self._groups[k]
        self.dropped += len(dead)
        return len(dead)

    def counters(self) -> dict:
        return {"events_in": self.events_in,
                "blocks_out": self.blocks_out,
                "groups_pending": len(self._groups),
                "dropped": self.dropped}


def synthesize_block(headers: List[Tuple[bytes, bytes]],
                     side: int) -> bytes:
    """Pseudo-headers -> request/status line; the rest -> an HTTP/1-
    shaped header block the existing parser consumes (version is
    rewritten to "2" downstream via the HTTP/2 marker line)."""
    pseudo = {n: v for n, v in headers if n.startswith(b":")}
    plain = [(n, v) for n, v in headers if not n.startswith(b":")]
    if side == T_EGRESS or b":method" in pseudo:
        line = (pseudo.get(b":method", b"GET") + b" "
                + pseudo.get(b":path", b"/") + b" HTTP/2\r\n")
        if b":authority" in pseudo and not any(
                n == b"host" for n, _ in plain):
            plain.insert(0, (b"host", pseudo[b":authority"]))
    else:
        line = b"HTTP/2 " + pseudo.get(b":status", b"200") + b" \r\n"
    return line + b"".join(n + b": " + v + b"\r\n"
                           for n, v in plain) + b"\r\n"
