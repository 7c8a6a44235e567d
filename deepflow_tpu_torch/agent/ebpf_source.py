"""eBPF-output front end: syscall-record stream -> l7 wire records.

The reference's defining datapath is a kernel eBPF program
(agent/src/ebpf/kernel/socket_trace.c) whose output records — socket
read/write syscalls with thread identity, TCP seq at capture, per-socket
capture sequence, and a thread-session trace id — make syscall-level L7
logs joinable with packet captures and with EACH OTHER across services.
This module implements the USERSPACE semantics that make that data
usable, fed by the in-kernel suites (agent/socket_trace.py,
agent/uprobe_trace.py) where they attach, else fixture/replay-driven:

- the thread-session trace-id state machine (socket_trace.c:960-1060):
  * INGRESS data on a thread assigns a fresh trace id (or continues the
    same-direction socket's previous one) and parks it in the trace map;
  * the next EGRESS on that thread CONSUMES the parked id — that is the
    implicit context propagation: service A's inbound request and its
    outbound call to service B share one syscall_trace_id;
  * a client-only egress request parks a zero marker so the later
    ingress response doesn't fabricate a new trace (the "traceID: 0"
    scenes in the kernel comments);
  * goroutine/coroutine ids substitute for the thread id when present
    (the ebpf_dispatcher's pseudo-thread treatment).
- TCP-seq <-> flow association: req_tcp_seq / resp_tcp_seq land in the
  l7 row from the syscall records, so an l7 log row joins the packet
  pipeline's flow rows on (5-tuple, seq).
- capture-sequence propagation (syscall_cap_seq_0/1) for loss detection.

Records parse through the SAME L7 parser registry as packet payloads
(agent/l7.py) and pair through the same SessionAggregator; merged
sessions serialize as standard PROTOCOLLOG wire records, so a real eBPF
agent can ship into this backend losslessly (the e2e test drives
syscall records through the wire into l7_flow_log rows and joins them
on the trace id).

The port's own copy of the JAX package's `agent/ebpf_source.py` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

from deepflow_tpu_torch.agent.l7 import (MSG_REQUEST, MSG_RESPONSE,
                                         SessionAggregator, parse_payload)

T_INGRESS = 0
T_EGRESS = 1


class ProcFdResolver:
    """(pid, fd) -> (ip_src, ip_dst, port_src, port_dst) from /proc:
    the fd symlink names the socket inode, /proc/<pid>/net/{tcp,udp}
    maps inodes to 4-tuples (the reference resolves the same via its
    socket info cache, user/socket.c). IPv4 addresses in those tables
    are little-endian hex. Lookups are cached per (pid, fd) for
    `ttl_s` — one kernel record burst must not rescan the proc tables
    per record."""

    def __init__(self, ttl_s: float = 3.0) -> None:
        self.ttl_s = ttl_s
        self._cache: Dict[Tuple[int, int], Tuple[float, object]] = {}

    def __call__(self, pid: int, fd: int):
        import time as _time
        now = _time.monotonic()
        hit = self._cache.get((pid, fd))
        if hit is not None and now - hit[0] < self.ttl_s:
            return hit[1]
        got = self._resolve(pid, fd)
        if len(self._cache) > 4096:           # bounded under fd churn
            self._cache.clear()
        self._cache[(pid, fd)] = (now, got)
        return got

    @staticmethod
    def _resolve(pid: int, fd: int):
        import os
        try:
            tgt = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            return None
        if not tgt.startswith("socket:["):
            return None
        inode = tgt[8:-1]
        for tbl in ("tcp", "udp"):
            try:
                with open(f"/proc/{pid}/net/{tbl}") as f:
                    lines = f.readlines()[1:]
            except OSError:
                continue
            for ln in lines:
                parts = ln.split()
                if len(parts) < 10 or parts[9] != inode:
                    continue
                l_ip, _, l_port = parts[1].partition(":")
                r_ip, _, r_port = parts[2].partition(":")
                if len(l_ip) != 8:            # IPv6 rows: not handled
                    continue
                return (int.from_bytes(bytes.fromhex(l_ip), "little"),
                        int.from_bytes(bytes.fromhex(r_ip), "little"),
                        int(l_port, 16), int(r_port, 16))
        return None


@dataclass
class SyscallRecord:
    """One SK_BPF_DATA-like record (the socket_trace.c output contract,
    userspace image)."""

    pid: int
    tid: int
    direction: int                 # T_INGRESS (read) / T_EGRESS (write)
    timestamp_ns: int
    ip_src: int
    ip_dst: int
    port_src: int
    port_dst: int
    proto: int = 6
    fd: int = 0                    # socket fd in the traced process
    tcp_seq: int = 0               # TCP seq at the syscall boundary
    cap_seq: int = 0               # per-socket capture sequence
    coroutine_id: int = 0          # goroutine id when nonzero
    latency_ns: int = 0            # syscall enter->exit latency (u32 ns)
    process_kname: str = ""
    payload: bytes = b""
    # from_kernel: the in-kernel socket_trace programs already ran the
    # park/consume discipline (agent/socket_trace.py) — their id
    # (kernel_trace_id, possibly 0 = "no trace") is authoritative and
    # the userspace replay machine stands down COMPLETELY: a zero-id
    # kernel record must not park userspace markers nothing consumes
    kernel_trace_id: int = 0
    from_kernel: bool = False
    # provenance (reference process_data_extra_source): SOURCE_SYSCALL
    # for plaintext syscalls; the OpenSSL / Go-TLS uprobe sources mean
    # the payload is DECRYPTED application data captured above the TLS
    # layer — the l7 row is flagged is_tls downstream
    source: int = 0


@dataclass
class _SideMeta:
    """Per-side syscall metadata captured when a record parses."""

    tcp_seq: int = 0
    trace_id: int = 0
    thread: int = 0
    coroutine: int = 0
    cap_seq: int = 0
    kname: str = ""


class EbpfTracer:
    """Syscall records in, merged l7 wire records out — plus IO events
    out-of-band (`io_events`): slow file-IO syscalls attached to
    in-flight traces, the reference's io_event tracepoint
    (agent/src/ebpf/kernel/socket_trace.c:2393 trace_io_event_common).

    The reference distinguishes socket vs file fds IN KERNEL (conn_info
    sk lookup) and routes files to its io_event program; this suite's
    kernel side treats every fd uniformly and the distinction happens
    here, where the /proc resolver already had to look each fd up: a
    record whose fd did NOT resolve to a socket tuple is file-class.
    Gate (reference parity): collect_mode 0=off, 1=only when the
    record rides an in-flight trace id, 2=all; plus a minimum latency
    (reference default 1ms) — the kernel packs enter->exit latency
    into every record's fd word. bytes_count is capped at the
    kernel's PAYLOAD_CAP clamp (the reference ships the true ret;
    documented deviation — the cap marks "at least this much")."""

    def __init__(self, vtap_id: int = 0,
                 io_event_collect_mode: int = 1,
                 io_event_minimal_duration_ns: int = 1_000_000) -> None:
        self.vtap_id = vtap_id
        self.io_event_collect_mode = io_event_collect_mode
        self.io_event_minimal_duration_ns = io_event_minimal_duration_ns
        self.io_events: List[bytes] = []      # serialized ProcEvents
        self.io_events_dropped = 0
        self._IO_EVENTS_CAP = 4096
        self._fd_path_cache: Dict[Tuple[int, int], tuple] = {}
        # /proc fd-class gate arming: zero ip tuples only mean "proven
        # non-socket" when a resolver actually ran over the record's fd
        # (the live perf-ring drain path, feed_raw(resolver=...)). A
        # replay/fixture feed never resolves, so its zero tuples are
        # AMBIGUOUS — classifying them against this machine's
        # /proc/<pid>/fd would let a pid collision with a live local
        # process swallow an L7 session as a spurious IO event
        # False until a resolver is seen.
        self._fd_class_active = False
        self.sessions = SessionAggregator()
        # trace map: (pid, coroutine|tid) -> (parked trace id, socket
        # key, direction); id 0 = the client-only zero marker
        self._trace_map: Dict[Tuple[int, int], tuple] = {}
        self._next_trace_id = 0
        self._meta: Dict[tuple, Dict[int, _SideMeta]] = {}
        self._meta_ts: Dict[tuple, int] = {}
        self._last_expire_ns = 0
        self.records_in = 0
        self.parse_failed = 0
        # GPIDSync plumbing: pids observed here ride the agent's sync
        # request; the controller's global allocation comes back into
        # gpid_map and is stamped onto every later wire record.
        # pid -> [name, first_ts, last_ts]; pruned in expire() — an
        # unbounded set would inflate every sync body and, past the
        # controller's per-sync cap, starve NEW pids of allocation
        self._seen_procs: Dict[int, list] = {}
        self.gpid_map: Dict[int, int] = {}
        self._http2 = None           # lazy Http2Assembler

    def expire(self, now_ns: int,
               timeout_ns: int = 30 * 1_000_000_000) -> None:
        """Drop unpaired per-session metadata older than the timeout —
        one-sided captures and aborted connections must not grow _meta
        without bound. Called opportunistically from feed()."""
        dead = [k for k, t in self._meta_ts.items()
                if now_ns - t > timeout_ns]
        for k in dead:
            self._meta.pop(k, None)
            self._meta_ts.pop(k, None)
        # prune processes with no records for 10x the session timeout
        # (process exit): their gpid allocations stay valid controller-
        # side; re-appearing pids simply re-report
        proc_timeout = timeout_ns * 10
        for pid in [p for p, sp in self._seen_procs.items()
                    if now_ns - sp[2] > proc_timeout]:
            del self._seen_procs[pid]
            self.gpid_map.pop(pid, None)
        if self._http2 is not None:
            # orphaned h2 header groups (lost END markers) expire on
            # the same cadence as the other per-session maps
            self._http2.expire(now_ns)

    # -- trace-id state machine -------------------------------------------
    def _trace_id_for(self, rec: SyscallRecord, msg_type: int,
                      skey: tuple) -> int:
        key = (rec.pid, rec.coroutine_id or rec.tid)
        if rec.direction == T_INGRESS:
            parked = self._trace_map.get(key)
            if parked is not None and parked[0] == 0 \
                    and msg_type == MSG_RESPONSE:
                # client thread reading its own response: no tracking
                del self._trace_map[key]
                return 0
            # continuation: more ingress data on the SAME socket keeps
            # the session's id (socket_trace.c pre_trace_id); a new
            # socket/direction means a new inbound request
            if parked is not None and parked[0] \
                    and parked[1:] == (skey, T_INGRESS):
                return parked[0]
            self._next_trace_id += 1
            tid = self._next_trace_id
            self._trace_map[key] = (tid, skey, T_INGRESS)
            return tid
        parked = self._trace_map.pop(key, None)
        if parked is not None and parked[0]:
            return parked[0]             # egress consumes the parked id
        if msg_type == MSG_REQUEST:
            # client-only request: (re-)park the zero marker — a client
            # pipelining several requests must keep it parked, or its
            # eventual response would fabricate a fresh trace id
            self._trace_map[key] = (0, skey, T_EGRESS)
        return 0

    # -- data path ---------------------------------------------------------
    def feed_raw(self, buf: bytes,
                 resolver=None) -> Optional[bytes]:
        """One kernel SOCK_DATA record (the in-tree socket_trace
        program suite's perf output, agent/socket_trace.py) through the
        same pipeline the fixture replay uses — the two sources are
        interchangeable at this boundary. A non-None resolver arms the
        IO-event fd-class gate: from here on, a zero ip tuple means the
        resolver genuinely failed to find a socket."""
        from deepflow_tpu_torch.agent.socket_trace import parse_record
        if resolver is not None:
            self._fd_class_active = True
        return self.feed(parse_record(buf, resolver=resolver))

    def feed(self, rec: SyscallRecord) -> Optional[bytes]:
        """Process one record; returns a serialized AppProtoLogsData when
        a request/response session merges. File-class records (fd never
        resolved to a socket tuple) route to the IO-event gate instead
        of session parsing."""
        self.records_in += 1
        from deepflow_tpu_torch.agent.socket_trace import (
            SOURCE_GO_HTTP2_UPROBE, SOURCE_SYSCALL)
        if (self.io_event_collect_mode and rec.latency_ns
                and self._fd_class_active
                and rec.source == SOURCE_SYSCALL
                and rec.ip_src == 0 and rec.ip_dst == 0
                and rec.latency_ns >= self.io_event_minimal_duration_ns
                and (self.io_event_collect_mode == 2
                     or rec.kernel_trace_id)):
            # zero tuple = the resolver made no socket of this fd, but
            # that also covers IPv6/unix sockets and closed-fd races —
            # only a PROVEN regular path becomes an IO event; anything
            # else ("socket:[N]", "pipe:[N]", anon inodes, dead pids)
            # falls through to session parsing exactly as before this
            # gate existed (a swallowed slow IPv6 read would lose its
            # L7 session). This is the reference's in-kernel
            # is_regular_file done where the fd table is readable.
            path = self._fd_path(rec.pid, rec.fd)
            if path is not None:
                self._emit_io_event(rec, path)
                return None
        if rec.source == SOURCE_GO_HTTP2_UPROBE:
            # header-level events (agent/http2_trace.py): group per
            # stream; only a COMPLETED block continues into parsing,
            # as a synthesized HTTP-shaped payload — every consumer
            # (live pump, replay) gets h2 handling for free here
            if self._http2 is None:
                from deepflow_tpu_torch.agent.http2_trace import \
                    Http2Assembler
                self._http2 = Http2Assembler()
            block = self._http2.feed(rec)
            if block is None:
                return None
            rec = replace(rec, payload=block)
        sp = self._seen_procs.get(rec.pid)
        if sp is None:
            self._seen_procs[rec.pid] = [rec.process_kname,
                                         rec.timestamp_ns,
                                         rec.timestamp_ns]
        else:
            sp[2] = rec.timestamp_ns
        parsed = parse_payload(
            rec.payload, proto=rec.proto, port_src=rec.port_src,
            port_dst=rec.port_dst, ts_ns=rec.timestamp_ns,
            ip_src=rec.ip_src, ip_dst=rec.ip_dst)
        if parsed is None:
            self.parse_failed += 1
            return None
        skey = tuple(sorted([(rec.ip_src, rec.port_src),
                             (rec.ip_dst, rec.port_dst)])) + (rec.proto,)
        trace_id = rec.kernel_trace_id if rec.from_kernel else \
            self._trace_id_for(rec, parsed.msg_type, skey)
        if rec.timestamp_ns - self._last_expire_ns > 1_000_000_000:
            self._last_expire_ns = rec.timestamp_ns
            self.expire(rec.timestamp_ns)
        side = 0 if parsed.msg_type == MSG_REQUEST else 1
        self._meta_ts[skey] = rec.timestamp_ns
        meta = self._meta.setdefault(skey, {})
        meta[side] = _SideMeta(
            tcp_seq=rec.tcp_seq, trace_id=trace_id,
            thread=rec.coroutine_id or rec.tid,
            coroutine=rec.coroutine_id, cap_seq=rec.cap_seq,
            kname=rec.process_kname)
        if parsed.msg_type == MSG_REQUEST:
            flow = (rec.ip_src, rec.ip_dst, rec.port_src, rec.port_dst,
                    rec.proto)
        else:
            flow = (rec.ip_dst, rec.ip_src, rec.port_dst, rec.port_src,
                    rec.proto)
        merged = self.sessions.offer(skey, parsed, rec.timestamp_ns)
        if merged is None:
            return None
        sides = self._meta.pop(skey, {})
        self._meta_ts.pop(skey, None)
        return self._wire_record(flow, merged, rec, sides)

    def _fd_path(self, pid: int, fd: int) -> Optional[str]:
        """The fd's regular-file path, or None when it is anything
        else (socket/pipe/anon inode — readlink yields "type:[N]") or
        unknowable (dead pid, closed fd). Resolution happens at
        ring-drain time, up to a tick after the syscall: an fd closed
        and reused inside that window resolves to its CURRENT target —
        a reuse onto a non-file makes the record fall back to session
        parsing; a reuse onto a different file mislabels the event's
        filename (the reference avoids this by capturing the name
        in-kernel at event time; a /proc-based design cannot).
        Probabilistic and bounded by the drain latency — documented,
        not hidden. A short-TTL cache keeps a sustained slow-IO
        stream (fsync-heavy logger) from paying one /proc readlink
        per record on the drain hot path. Positive entries (a real
        path) expire faster than negative ones: a cached PATH that
        outlives an fd close/reopen mislabels the next event's
        filename, so its staleness window stays near the drain
        latency, while "not a file" verdicts (sockets held open for
        whole sessions) can afford the longer TTL. At the cap the
        OLDEST entries evict first — a wholesale clear would drop
        every hot entry at once and pay a readlink burst to rebuild."""
        import os as _os
        import time as _time
        now = _time.monotonic()
        cache = self._fd_path_cache
        got = cache.get((pid, fd))
        if got is not None and now - got[1] < \
                (1.0 if got[0] is not None else 3.0):
            return got[0]
        try:
            path = _os.readlink(f"/proc/{pid}/fd/{fd}")
            result = path if path.startswith("/") else None
        except OSError:
            result = None
        # pop-then-insert keeps dict order ≈ recency, so the eviction
        # loop below prunes the stalest entries, not arbitrary ones
        cache.pop((pid, fd), None)
        cache[(pid, fd)] = (result, now)
        while len(cache) > 4096:
            cache.pop(next(iter(cache)))
        return result

    def _emit_io_event(self, rec: SyscallRecord, path: str) -> None:
        """Build the ProcEvent the event pipeline ingests
        (wire/protos/telemetry.proto; pipelines/event.py _handle_proc).

        collect-mode caveat vs the reference: mode 1's "in-flight
        trace" evidence is EXACT for writes (a nonzero id means the
        kernel consumed one genuinely parked by earlier ingress) but
        approximate for reads — the kernel's ingress discipline
        allocates a fresh id for every read (it cannot see fd class),
        so a pure file-reading process still passes mode 1 on its
        reads. The reference gates on its thread-level trace_map
        in-kernel before its own parking; a userspace gate has no
        equivalent signal. Mode choice therefore controls read-side
        VOLUME, not linkage correctness."""
        from deepflow_tpu_torch.agent.socket_trace import T_INGRESS
        from deepflow_tpu_torch.wire.gen import telemetry_pb2

        if len(self.io_events) >= self._IO_EVENTS_CAP:
            self.io_events_dropped += 1
            return
        ev = telemetry_pb2.ProcEvent()
        ev.pid = rec.pid
        ev.thread_id = rec.tid
        ev.coroutine_id = rec.coroutine_id
        ev.process_kname = rec.process_kname.encode("latin-1", "replace")
        ev.end_time = rec.timestamp_ns
        ev.start_time = rec.timestamp_ns - rec.latency_ns
        ev.event_type = telemetry_pb2.IoEvent
        io = ev.io_event_data
        io.bytes_count = len(rec.payload)
        io.operation = (telemetry_pb2.Read if rec.direction == T_INGRESS
                        else telemetry_pb2.Write)
        io.latency = rec.latency_ns
        io.filename = path.encode("utf-8", "replace")[:255]
        self.io_events.append(ev.SerializeToString())

    def _wire_record(self, flow, merged: dict, rec: SyscallRecord,
                     sides: Dict[int, _SideMeta]) -> bytes:
        from deepflow_tpu_torch.agent.trident import l7_session_message
        req = sides.get(0, _SideMeta())
        resp = sides.get(1, _SideMeta())
        # the shared builder owns orientation + common fields; only the
        # syscall identities are eBPF-specific
        m = l7_session_message(flow, merged, rec.timestamp_ns,
                               self.vtap_id)
        b = m.base
        b.req_tcp_seq = req.tcp_seq
        b.resp_tcp_seq = resp.tcp_seq
        b.syscall_trace_id_request = req.trace_id
        b.syscall_trace_id_response = resp.trace_id
        b.syscall_trace_id_thread_0 = req.thread
        b.syscall_trace_id_thread_1 = resp.thread
        b.syscall_coroutine_0 = req.coroutine
        b.syscall_coroutine_1 = resp.coroutine
        b.syscall_cap_seq_0 = req.cap_seq
        b.syscall_cap_seq_1 = resp.cap_seq
        b.process_kname_0 = req.kname
        b.process_kname_1 = resp.kname
        b.process_id_0 = rec.pid
        # controller-allocated global process id (GPIDSync): what joins
        # this span to the same process seen from other vtaps
        b.gpid_0 = self.gpid_map.get(rec.pid, 0)
        from deepflow_tpu_torch.agent.socket_trace import TLS_SOURCES
        if rec.source in TLS_SOURCES:
            # uprobe-captured plaintext of encrypted traffic: the l7
            # row carries the TLS bit (flow_log.proto AppProtoLogsData
            # .flags bit 0 -> columnar is_tls) so queries can tell
            # decrypted-uprobe spans from plaintext-syscall ones
            m.flags = m.flags | 1
        return m.SerializeToString()

    def seen_processes(self) -> list:
        """Processes observed on this tracer, in the sync request's
        GPIDSync shape (start_time = first-record timestamp, the
        stable-across-pid-reuse key component). Most-recently-active
        first and bounded: under pid churn the controller's per-sync
        cap must see live processes, not ancient ones."""
        items = sorted(self._seen_procs.items(),
                       key=lambda kv: -kv[1][2])[:4096]
        return [{"pid": pid, "name": sp[0], "start_time": sp[1]}
                for pid, sp in items]

    def counters(self) -> dict:
        out = {"records_in": self.records_in,
               "parse_failed": self.parse_failed,
               "trace_map_entries": len(self._trace_map),
               "next_trace_id": self._next_trace_id,
               # the cap's drops must be visible in the ebpf debug
               # dump, or an operator can never see the loss
               "io_events_pending": len(self.io_events),
               "io_events_dropped": self.io_events_dropped}
        if self._http2 is not None:
            out["http2"] = self._http2.counters()
        return out
