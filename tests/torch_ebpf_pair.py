"""Helpers for the tests that hold the port's eBPF tracer front
(`deepflow_tpu_torch/agent/{socket_trace,uprobe_trace,http2_trace,
perf_ring,ebpf_source,btf,x86_decode}.py`) against the JAX package's:
both packages' modules, program suites recorded instead of loaded (the
maps get fixed fds, `load` keeps the instruction bytes), and a seeded
stream of syscall records. Not a test file."""

import contextlib
import importlib
import itertools
import types

PKGS = ("deepflow_tpu", "deepflow_tpu_torch")
MODULES = ("bpf", "btf", "x86_decode", "socket_trace", "perf_ring",
           "ebpf_source", "uprobe_trace", "http2_trace")


def mods(pkg):
    """The tracer-front modules of `pkg` by name."""
    ns = types.SimpleNamespace(pkg=pkg)
    for name in MODULES:
        setattr(ns, name, importlib.import_module(f"{pkg}.agent.{name}"))
    return ns


def both():
    return [mods(p) for p in PKGS]


class _FakeMap:
    """A map that is never created: a fixed fd, its shape and every
    update kept in the log."""

    def __init__(self, log, fds, *args):
        self.fd = next(fds)
        self._log = log
        log.append(("map", self.fd, args))

    def update(self, key, value):
        self._log.append(("update", self.fd, key, value))

    def update_bytes(self, key, value):
        self._log.append(("update_bytes", self.fd, bytes(key), bytes(value)))

    def close(self):
        pass


class _FakeProgram:
    def __init__(self, insns, prog_type):
        self.insns, self.prog_type = bytes(insns), prog_type

    def close(self):
        pass


@contextlib.contextmanager
def recording(m, monkeypatch):
    """While open, `m`'s program suites build against fake maps (fds from
    100 up) and `load` returns the instruction bytes instead of calling
    bpf(2). Yields the log: maps, updates and programs in order."""
    log, fds = [], itertools.count(100)

    def fake_load(insns, prog_type=0, license_=b"GPL"):
        log.append(("prog", prog_type, bytes(insns)))
        return _FakeProgram(insns, prog_type)

    with monkeypatch.context() as mp:
        for name in ("socket_trace", "uprobe_trace", "http2_trace"):
            mod = getattr(m, name)
            mp.setattr(mod, "Map", lambda *a, _l=log, _f=fds:
                       _FakeMap(_l, _f, *a))
            mp.setattr(mod, "load", fake_load)
        yield log


# -- a seeded stream of syscall records -----------------------------------
CLIENT_NET, SERVICE_NET = 0x0A640000, 0x0AC80000
T0 = 1_700_000_000 * 1_000_000_000
MS = 1_000_000


def _http(resp, i):
    if resp:
        return (f"HTTP/1.1 {(200, 200, 404, 500)[i % 4]} OK\r\n"
                f"Content-Length: {i % 50}\r\n\r\n").encode()
    return (f"GET /api/v{i % 3}/item/{i} HTTP/1.1\r\nHost: svc{i % 7}\r\n"
            f"traceparent: 00-{i:032x}-{i + 1:016x}-01\r\n\r\n").encode()


def _redis(resp, i):
    if resp:
        return b"$5\r\nvalue\r\n" if i % 5 else b"-ERR wrong type\r\n"
    key = f"k{i}".encode()
    return b"*2\r\n$3\r\nGET\r\n$" + str(len(key)).encode() + b"\r\n" + key \
        + b"\r\n"


def _mysql(resp, i):
    if resp:
        body = b"\x00\x00\x00\x02\x00\x00\x00" if i % 3 else \
            b"\xff\x15\x04#28000denied"
        return len(body).to_bytes(3, "little") + b"\x01" + body
    q = f"\x03SELECT * FROM t{i % 5} WHERE id = {i}".encode()
    return len(q).to_bytes(3, "little") + b"\x00" + q


PROTOCOLS = ((80, _http), (6379, _redis), (3306, _mysql))


def record_stream(rng, n_conv=96, procs=6, threads=3):
    """Seeded syscall records as SyscallRecord keyword dicts, each thread's
    conversations in sequence (threads interleave in time). Kinds: a
    two-hop call (client -> svc -> upstream -> svc -> client: the
    ingress request parks a trace id, the egress call consumes it), a
    client-only exchange (the zero marker), a continued ingress (two
    request segments on one socket keep one id), and a Go HTTP/2 header
    exchange (SOURCE_GO_HTTP2_UPROBE events, the assembler's groups).
    Process 0 runs with goroutine ids; one conversation in 8 is tagged
    with a TLS uprobe source. Every record carries its socket's fd, and
    `sockets` maps (pid, fd) to (local ip, remote ip, local port, remote
    port), the ProcFdResolver's answer. Returns (records, sockets)."""
    from deepflow_tpu.agent import http2_trace as h2
    from deepflow_tpu.agent.socket_trace import (SOURCE_GO_HTTP2_UPROBE,
                                                 SOURCE_GO_TLS_UPROBE,
                                                 SOURCE_OPENSSL_UPROBE,
                                                 SOURCE_SYSCALL, T_EGRESS,
                                                 T_INGRESS)
    slots = [(1000 + p, 100 + p * 10 + t) for p in range(procs)
             for t in range(threads)]
    clock = {s: T0 + int(rng.integers(0, 5 * MS)) for s in slots}
    fds = {}
    sockets = {}
    out = []

    def sock(pid, local, remote, lport, rport):
        fd = fds.setdefault(pid, 3) + 1
        fds[pid] = fd
        sockets[(pid, fd)] = (local, remote, lport, rport)
        return fd

    for c in range(n_conv):
        pid, tid = slots[c % len(slots)]
        kind = int(rng.integers(0, 4))
        source = SOURCE_SYSCALL
        if rng.integers(0, 8) == 0:
            source = (SOURCE_OPENSSL_UPROBE, SOURCE_GO_TLS_UPROBE)[c % 2]
        coroutine = int(rng.integers(1, 1 << 20)) if pid == 1000 else 0
        me = SERVICE_NET + pid
        client = CLIENT_NET + int(rng.integers(1, 250))
        upstream = SERVICE_NET + 0x100 + int(rng.integers(0, 8))
        port_in, gen_in = PROTOCOLS[int(rng.integers(0, 3))]
        port_up, gen_up = PROTOCOLS[int(rng.integers(0, 3))]
        eph = 30000 + c
        t = clock[(pid, tid)]
        recs = []

        def rec(direction, src, dst, sport, dport, fd, payload, dt):
            nonlocal t
            t += dt
            recs.append(dict(
                pid=pid, tid=tid, direction=direction, timestamp_ns=t,
                ip_src=src, ip_dst=dst, port_src=sport, port_dst=dport,
                fd=fd, tcp_seq=int(rng.integers(1, 1 << 31)),
                cap_seq=len(recs) + 1, coroutine_id=coroutine,
                process_kname=f"svc-{pid}", payload=payload,
                source=source))

        if kind == 0:
            fd_in = sock(pid, me, client, port_in, eph)
            fd_up = sock(pid, me, upstream, eph + 1, port_up)
            rec(T_INGRESS, client, me, eph, port_in, fd_in,
                gen_in(False, c), MS)
            rec(T_EGRESS, me, upstream, eph + 1, port_up, fd_up,
                gen_up(False, c + 1), 2 * MS)
            rec(T_INGRESS, upstream, me, port_up, eph + 1, fd_up,
                gen_up(True, c + 1), 5 * MS)
            rec(T_EGRESS, me, client, port_in, eph, fd_in,
                gen_in(True, c), MS)
        elif kind == 1:
            fd_up = sock(pid, me, upstream, eph, port_up)
            rec(T_EGRESS, me, upstream, eph, port_up, fd_up,
                gen_up(False, c), MS)
            rec(T_INGRESS, upstream, me, port_up, eph, fd_up,
                gen_up(True, c), 3 * MS)
        elif kind == 2:
            fd_in = sock(pid, me, client, 80, eph)
            req = _http(False, c)
            rec(T_INGRESS, client, me, eph, 80, fd_in, req[:20], MS)
            rec(T_INGRESS, client, me, eph, 80, fd_in, req, MS)
            rec(T_EGRESS, me, client, 80, eph, fd_in, _http(True, c),
                2 * MS)
        else:
            source = SOURCE_GO_HTTP2_UPROBE
            fd_up = sock(pid, me, upstream, eph, 443)
            stream = 1 + 2 * int(rng.integers(0, 50))
            for name, value in ((b":method", b"POST"),
                                (b":path", f"/rpc/{c}".encode()),
                                (b":authority", b"grpc.svc"),
                                (b"content-type", b"application/grpc")):
                rec(T_EGRESS, me, upstream, eph, 443, fd_up,
                    h2.pack_event(stream, 0, name, value), 1000)
            rec(T_EGRESS, me, upstream, eph, 443, fd_up,
                h2.pack_event(stream, h2.EV_FLAG_END, b"", b""), 1000)
            rec(T_INGRESS, upstream, me, 443, eph, fd_up,
                h2.pack_event(stream, h2.EV_FLAG_READ, b":status",
                              (b"200", b"503")[c % 2]), 2 * MS)
            rec(T_INGRESS, upstream, me, 443, eph, fd_up,
                h2.pack_event(stream, h2.EV_FLAG_READ | h2.EV_FLAG_END,
                              b"", b""), 1000)
        clock[(pid, tid)] = t + int(rng.integers(1, 3 * MS))
        out.extend(recs)
    out.sort(key=lambda r: (r["timestamp_ns"], r["pid"], r["tid"]))
    return out, sockets


def kernel_trace_ids(rng, n):
    """Seeded in-kernel trace ids, 0 (no trace) for about a quarter."""
    ids = rng.integers(1, 1 << 40, n)
    ids[rng.integers(0, 4, n) == 0] = 0
    return [int(x) for x in ids]


def kernel_images(m, records, trace_ids):
    """Each record as the SOCK_DATA image `m.socket_trace.pack_record`
    builds, with its in-kernel trace id."""
    return [m.socket_trace.pack_record(
        r["pid"], r["tid"], r["direction"], r["timestamp_ns"], r["payload"],
        fd=r["fd"], trace_id=tid, cap_seq=r["cap_seq"],
        comm=r["process_kname"], source=r["source"])
        for r, tid in zip(records, trace_ids)]
