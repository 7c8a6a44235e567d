"""The port's agent process (`deepflow_tpu_torch/agent/{trident,__main__,
dispatcher,policy,pcap,flow_aggr,packet_sequence,guard,afpacket,platform}.py`)
against the JAX package's, on the CPU.

The same seeded frames (TCP conversations whose payloads speak the
protocol of their server port -- HTTP, TLS, MySQL, Redis, Kafka,
PostgreSQL -- DNS over UDP, and some malformed frames) go through the
JAX `Agent` and the port's `Agent(cfg, device="cpu")` with explicit
`tick(now_ns)` and `tick(final=True)`. Each agent's senders point at a
loopback receiver of their own, and every frame of every message type
must be equal byte for byte, then `counters()`. Cases: the columnar and
the protobuf wire, `l4_log_aggr_s` 60 and a hot switch 0 -> 60 -> 0
through `_apply_config`, packet sequence on, a throttling L7 cap, and
a pushed policy with NPB (VXLAN over UDP), PCAP and DROP actions.

Managed mode runs each agent against its own package's
`ControllerServer` over HTTP, the JAX agent against the JAX controller
and the port's against the port's, and every step must be equal; so
must the controller-distributed plugins (`pkg://` .so and wasm pushes,
each fetch failure, `[]`, the cache with the controller down) with
their PROTOCOLLOG bytes, and the apiserver watch taking precedence over
the resource file. The bootstrap cases hold both packages'
`load_bootstrap`, `main` and `build_source` (the bpf filter, the xdp
engine) to the same answers and messages. The process case runs `python -m
deepflow_tpu_torch.agent --device cpu` over a pcap into the port's
`Server` on the CPU and stops it with SIGTERM.
"""

import builtins
import contextlib
import io
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from deepflow_tpu.agent import __main__ as jmain
from deepflow_tpu.agent import policy as jpolicy
from deepflow_tpu.agent import trident as jtrident
from deepflow_tpu.replay.frames import (ACK, FIN, PSH, RST, SYN, eth_ipv4_tcp,
                                        eth_ipv4_udp, ip4)
from deepflow_tpu_torch.agent import __main__ as tmain
from deepflow_tpu_torch.agent import packet_sequence as tpseq
from deepflow_tpu_torch.agent import pcap as tpcap
from deepflow_tpu_torch.agent import policy as tpolicy
from deepflow_tpu_torch.agent import trident as ttrident

REPO = Path(__file__).resolve().parent.parent
NS = 1_000_000_000
T0 = 1_700_000_000 * NS
SECONDS = 3
PORTS = {"http": 80, "tls": 443, "mysql": 3306, "redis": 6379,
         "kafka": 9092, "pg": 5432, "dns": 53}
KINDS = tuple(PORTS)


# -- traffic -------------------------------------------------------------------
def l7_pair(kind, i, rng):
    """One request and its response, in the protocol of `kind`."""
    if kind == "http":
        status = (200, 200, 404, 503)[i % 4]
        return ((f"GET /api/v{i % 3}/items/{i}?q={rng.integers(99)} "
                 f"HTTP/1.1\r\nHost: svc{i % 5}.local\r\nUser-Agent: t/1"
                 f"\r\nX-Request-Id: r{i}\r\n\r\n").encode(),
                (f"HTTP/1.1 {status} X\r\nContent-Length: 2\r\n\r\nok"
                 ).encode())
    if kind == "tls":
        sni = f"api{i % 7}.example.com".encode()
        ext = struct.pack(">HHHBH", 0, len(sni) + 5, len(sni) + 3, 0,
                          len(sni)) + sni
        body = (b"\x03\x03" + bytes(32) + b"\x00" + b"\x00\x02\x13\x01"
                + b"\x01\x00" + struct.pack(">H", len(ext)) + ext)
        hs = b"\x01" + len(body).to_bytes(3, "big") + body
        sh_body = b"\x03\x03" + bytes(32) + b"\x00\x13\x01\x00"
        sh = b"\x02" + len(sh_body).to_bytes(3, "big") + sh_body
        return (b"\x16\x03\x01" + struct.pack(">H", len(hs)) + hs,
                b"\x16\x03\x03" + struct.pack(">H", len(sh)) + sh)
    if kind == "mysql":
        q = f"\x03SELECT * FROM t{i % 4} WHERE id = {i}".encode()
        ok = b"\x00\x00\x00\x02\x00\x00\x00" if i % 5 else \
            b"\xff\x15\x04#28000denied"
        return (len(q).to_bytes(3, "little") + b"\x00" + q,
                len(ok).to_bytes(3, "little") + b"\x01" + ok)
    if kind == "redis":
        key = f"user:{i}".encode()
        return (b"*2\r\n$3\r\nGET\r\n$" + str(len(key)).encode() + b"\r\n"
                + key + b"\r\n", b"$2\r\nhi\r\n" if i % 6 else b"-ERR x\r\n")
    if kind == "kafka":
        client = f"client-{i % 3}".encode()
        corr = 21 + i % 30000
        hdr = struct.pack(">hhih", i % 4, 7, corr, len(client)) + client
        body = hdr + bytes(8)
        resp = struct.pack(">i", corr) + bytes(6)
        return (struct.pack(">i", len(body)) + body,
                struct.pack(">i", len(resp)) + resp)
    if kind == "pg":
        q = f"SELECT a, b FROM t{i % 3} WHERE x = {i} AND y = 'v'\x00" \
            .encode()
        resp = b"T" + struct.pack(">i", 6) + b"\x00\x00" \
            if i % 4 else b"E" + struct.pack(">i", 12) + b"SERROR\x00\x00\x00"
        return b"Q" + struct.pack(">i", len(q) + 4) + q, resp
    name = b"".join(bytes([len(p)]) + p for p in
                    (f"h{i % 9}".encode(), b"example", b"com")) + b"\x00"
    head = struct.pack(">HHHHHH", i & 0xFFFF, 0x0100, 1, 0, 0, 0)
    rhead = struct.pack(">HHHHHH", i & 0xFFFF, 0x8180 | (i % 3 == 0) * 3,
                        1, 1, 0, 0)
    q = name + struct.pack(">HH", 1, 1)
    return head + q, rhead + q + b"\xc0\x0c" + struct.pack(
        ">HHIH", 1, 1, 60, 4) + bytes([10, 0, 0, i % 250])


def traffic(seed, n_flows=42, seconds=SECONDS, t0=T0):
    """Per second, the list of (frames, stamps) capture batches."""
    rng = np.random.default_rng(seed)
    pkts = []

    def add(ts, frame):
        pkts.append((int(ts), frame))
    for f in range(n_flows):
        kind = KINDS[f % len(KINDS)]
        cli = ip4(10, 1 + f // 200, f % 200, 1 + f % 3)
        srv = ip4(172, 16, f % 5, 10 + f % 7)
        cport, sport = 30000 + 7 * f, PORTS[kind]
        t = t0 + int(rng.integers(0, seconds * NS * 2 // 3))
        cycles = int(rng.integers(1, 6))
        if kind == "dns":
            for c in range(cycles):
                q, r = l7_pair(kind, 100 * f + c, rng)
                add(t, eth_ipv4_udp(cli, srv, cport, sport, q))
                if rng.random() < 0.9:
                    add(t + 2_000_000, eth_ipv4_udp(srv, cli, sport, cport, r))
                t += int(rng.integers(5_000_000, 200_000_000))
            continue
        cs, ss = int(rng.integers(0, 1 << 31)), int(rng.integers(0, 1 << 31))
        if rng.random() < 0.8:       # else: the capture starts mid-stream
            add(t, eth_ipv4_tcp(cli, srv, cport, sport, SYN, seq=cs))
            add(t + 1_000_000, eth_ipv4_tcp(srv, cli, sport, cport, SYN | ACK,
                                            seq=ss, ack=cs + 1))
            add(t + 2_000_000, eth_ipv4_tcp(cli, srv, cport, sport, ACK,
                                            seq=cs + 1, ack=ss + 1))
            cs, ss, t = cs + 1, ss + 1, t + 3_000_000
        for c in range(cycles):
            q, r = l7_pair(kind, 100 * f + c, rng)
            add(t, eth_ipv4_tcp(cli, srv, cport, sport, PSH | ACK, q,
                                seq=cs, ack=ss))
            if rng.random() < 0.1:   # a retransmitted request
                add(t + 300_000_000, eth_ipv4_tcp(cli, srv, cport, sport,
                                                  PSH | ACK, q, seq=cs,
                                                  ack=ss))
            cs += len(q)
            rtt = int(rng.integers(100_000, 40_000_000))
            add(t + rtt // 2, eth_ipv4_tcp(srv, cli, sport, cport, ACK,
                                           seq=ss, ack=cs))
            add(t + rtt, eth_ipv4_tcp(srv, cli, sport, cport, PSH | ACK, r,
                                      seq=ss, ack=cs,
                                      win=0 if c == 3 else 8192))
            ss += len(r)
            add(t + rtt + 500_000, eth_ipv4_tcp(cli, srv, cport, sport, ACK,
                                                seq=cs, ack=ss))
            t += rtt + int(rng.integers(1_000_000, 300_000_000))
        end = rng.random()
        if end < 0.6:
            add(t, eth_ipv4_tcp(cli, srv, cport, sport, FIN | ACK, seq=cs,
                                ack=ss))
            add(t + 1_000_000, eth_ipv4_tcp(srv, cli, sport, cport,
                                            FIN | ACK, seq=ss, ack=cs + 1))
            add(t + 2_000_000, eth_ipv4_tcp(cli, srv, cport, sport, ACK,
                                            seq=cs + 1, ack=ss + 1))
        elif end < 0.8:
            add(t, eth_ipv4_tcp(srv, cli, sport, cport, RST, seq=ss))
    for k in range(12):              # malformed: runts and a bad ethertype
        add(t0 + int(rng.integers(0, seconds * NS)),
            bytes(rng.integers(0, 256, 10 + 3 * k, dtype=np.uint8))
            if k % 2 else b"\x00" * 12 + b"\x88\xcc" + bytes(40))
    pkts.sort(key=lambda p: p[0])
    out = [[] for _ in range(seconds + 1)]
    for ts, frame in pkts:
        out[min((ts - t0) // NS, seconds)].append((ts, frame))
    batches = []
    for sec in out:
        b = []
        for lo in range(0, len(sec), 37):
            chunk = sec[lo:lo + 37]
            b.append(([f for _, f in chunk],
                      np.array([t for t, _ in chunk], np.uint64)))
        batches.append(b)
    return batches


# -- loopback receivers ----------------------------------------------------------
class Sink:
    """A loopback TCP receiver: each connection's bytes, in accept order."""

    def __init__(self):
        self.srv = socket.create_server(("127.0.0.1", 0))
        self.port = self.srv.getsockname()[1]
        self.conns = []            # [bytearray, eof Event]
        self._lock = threading.Lock()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                c, _ = self.srv.accept()
            except OSError:
                return
            buf, eof = bytearray(), threading.Event()
            with self._lock:
                self.conns.append((buf, eof))
            threading.Thread(target=self._read, args=(c, buf, eof),
                             daemon=True).start()

    @staticmethod
    def _read(c, buf, eof):
        with c:
            while True:
                chunk = c.recv(1 << 16)
                if not chunk:
                    break
                buf += chunk
        eof.set()

    def drain(self, senders, timeout=30.0):
        """Close the senders and wait for their connections' EOF;
        returns {message type byte: every frame's bytes, in order}."""
        want = 0
        for s in senders.values():
            s.close()
            want += s.sent_frames > 0
        deadline = time.time() + timeout
        while True:
            with self._lock:
                conns = list(self.conns)
            if len(conns) >= want and all(e.is_set() for _, e in conns):
                break
            assert time.time() < deadline, "sink: senders never closed"
            time.sleep(0.01)
        out = {}
        for buf, _ in conns:
            data = bytes(buf)
            if data:
                out.setdefault(data[4], []).append(data)
        return {k: b"".join(v) for k, v in out.items()}

    def close(self):
        self.srv.close()


class UdpSink:
    def __init__(self):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]

    def read(self):
        out = []
        while True:
            try:
                out.append(self.sock.recv(1 << 16))
            except socket.timeout:
                return out

    def close(self):
        self.sock.close()


# -- the byte-for-byte cases ------------------------------------------------------
ACLS = [{"id": 3, "protocol": 6, "dst_ports": "6379",
         "npb_actions": [{"tunnel_type": 1}]},
        {"id": 4, "protocol": 6, "src_ports": "3306",
         "npb_actions": [{"tunnel_type": 2}]},
        {"id": 5, "protocol": 17, "src_ports": "53",
         "npb_actions": [{"tunnel_type": 3}]}]
CASES = {
    "columnar": ({}, {}),
    "protobuf": ({"wire_mode": "protobuf"}, {}),
    "aggr60": ({"l4_log_aggr_s": 60}, {}),
    "aggr_switch": ({"wire_mode": "protobuf"},
                    {1: {"l4_log_aggr_s": 60}, 2: {"l4_log_aggr_s": 0}}),
    "packet_sequence": ({"packet_sequence": True}, {}),
    "throttle": ({"l7_log_rate": 3}, {}),
    "policy": ({"npb_tunnel": "vxlan"},
               {0: {"flow_acls": ACLS, "acl_version": 7}}),
}


def run_agent(package, case, batches, tmp):
    """Drive one package's Agent over `batches` with explicit ticks;
    returns what it sent, its counters and its policy actions' output."""
    extra, pushes = CASES[case]
    sink, udp = Sink(), UdpSink()
    mod = jtrident if package == "jax" else ttrident
    kw = dict(extra)
    if case == "policy":
        kw.update(npb_addr=f"127.0.0.1:{udp.port}",
                  pcap_policy_dir=str(tmp / package / "pcap"))
    cfg = mod.AgentConfig(ingester_addr=f"127.0.0.1:{sink.port}", **kw)
    agent = mod.Agent(cfg) if package == "jax" else \
        mod.Agent(cfg, device="cpu")
    agent.set_vtap_id(9)
    sent = []
    try:
        for sec, per_sec in enumerate(batches):
            if sec in pushes:
                agent._apply_config(dict(pushes[sec]))
            for frames, stamps in per_sec:
                sent.append(("feed", agent.feed(frames, stamps)))
            now = T0 + (sec + 1) * NS
            sent.append(agent.tick(now, final=sec == len(batches) - 1))
        streams = sink.drain(agent.senders)
        counters = agent.counters()
        # every Countable but the Guard's RSS reading (the process's)
        stats = {s.module: {k: v for k, v in s.values.items()
                            if k != "rss_mb"}
                 for s in agent.stats.peek()}
        npb = udp.read()
    finally:
        agent.close()
        sink.close()
        udp.close()
    pcaps = {}
    pdir = tmp / package / "pcap"
    if pdir.exists():
        pcaps = {p.name: p.read_bytes() for p in sorted(pdir.iterdir())}
    return {"sent": sent, "streams": streams, "counters": counters,
            "stats": stats, "npb": npb, "pcaps": pcaps}


@pytest.fixture(scope="module")
def batches():
    return traffic(16)


@pytest.mark.parametrize("case", sorted(CASES))
def test_agent_sends_reference_bytes(case, batches, tmp_path):
    j = run_agent("jax", case, batches, tmp_path)
    t = run_agent("port", case, batches, tmp_path)
    assert sorted(t["streams"]) == sorted(j["streams"])
    for mt in j["streams"]:
        assert t["streams"][mt] == j["streams"][mt], f"message type {mt}"
    assert t["sent"] == j["sent"]
    assert t["counters"] == j["counters"]
    assert t["stats"] == j["stats"]
    assert t["npb"] == j["npb"] and t["pcaps"] == j["pcaps"]
    c = j["counters"]
    # the case exercised what it names
    assert c["sessions_merged"] > 20 and c["sent_metrics"] > 0
    flows = "sent_columnar_flow" if CASES[case][0].get(
        "wire_mode", "columnar") == "columnar" else "sent_taggedflow"
    assert c[flows] > 0
    if case == "throttle":
        assert c["l7_throttled"] > 0
    if case == "packet_sequence":
        data = j["streams"][ttrident.MessageType.PACKETSEQUENCE]
        size = struct.unpack_from(">I", data)[0]     # the first frame
        rows, bad = tpseq.decode_blocks(data[5 + 14:size], 9)
        assert c["sent_packetsequence"] > 0 and rows and not bad
    if case == "policy":
        assert j["npb"] and j["pcaps"]
        assert j["stats"]["agent.enforcer"]["dropped"] > 0
    if case.startswith("aggr"):
        assert j["stats"]["agent.flow_aggr"]["rows_in"] > 0 or \
            case == "aggr_switch"


# -- managed mode ----------------------------------------------------------------
def _controller(package):
    """A started ControllerServer of `package` ("jax" or "port") with one
    ingester, and its registry."""
    import importlib
    pkg = "deepflow_tpu" if package == "jax" else "deepflow_tpu_torch"
    ctl = importlib.import_module(f"{pkg}.controller")
    mon_mod = importlib.import_module(f"{pkg}.controller.monitor")

    reg = ctl.VTapRegistry()
    mon = mon_mod.FleetMonitor(reg)
    mon.set_ingesters(["127.0.0.1:39999"])
    srv = ctl.ControllerServer(ctl.ResourceModel(), reg, mon, port=0)
    srv.start()
    return srv, reg


def _managed_run(package, tmp):
    """One agent against a fresh controller: registration, pushes, a
    bad upgrade, a plugin push, then the controller gone and the escape
    timer. Returns what each step showed."""
    srv, reg = _controller(package)
    mod = jtrident if package == "jax" else ttrident
    pol = jpolicy if package == "jax" else tpolicy
    cfg = mod.AgentConfig(controller_url=f"http://127.0.0.1:{srv.port}",
                          ctrl_ip="10.5.5.5", host="it-host",
                          escape_after_s=0.3, self_telemetry=False,
                          upgrade_dir=str(tmp / package))
    os.makedirs(cfg.upgrade_dir, exist_ok=True)
    agent = mod.Agent(cfg) if package == "jax" else \
        mod.Agent(cfg, device="cpu")
    steps = {}
    try:
        assert agent.sync_once()
        steps["register"] = (agent.vtap_id, sorted(
            {s.port for s in agent.senders.values()}),
            abs(agent.ntp_offset_ns) < 5 * NS, agent.config_version)
        reg.set_config("default", {"l7_log_rate": 7, "flow_acls": ACLS,
                                   "l4_log_aggr_s": 60,
                                   "l7_log_enabled": True})
        assert agent.sync_once()
        steps["push"] = (agent.cfg.l7_log_rate, agent.cfg.l4_log_aggr_s,
                         agent.flow_aggr.interval_s,
                         [vars(r) for r in agent.policy.rules],
                         agent.policy.version,
                         [r.action for r in agent.policy.rules] ==
                         [pol.ACTION_NPB, pol.ACTION_PCAP, pol.ACTION_DROP])
        reg.set_upgrade("default", "v2", "agent-v2.bin", "0" * 64)
        srv._packages["agent-v2.bin"] = b"new-agent" * 64
        agent.sync_once()
        steps["bad_upgrade"] = (agent.upgrade_errors,
                                agent.upgrades_applied, agent.cfg.revision)
        reg.clear_upgrade("default")
        agent.escape.check()
        steps["fresh"] = (agent.escaped, agent.cfg.l7_enabled)
    finally:
        srv.close()
    time.sleep(0.4)
    ok = agent.sync_once()
    agent.escape.check()
    steps["escape"] = (ok, agent.escaped, agent.cfg.l7_enabled,
                       agent.counters()["escaped"])
    agent.close()
    return steps


def test_managed_mode_matches_reference(tmp_path):
    j = _managed_run("jax", tmp_path)
    t = _managed_run("port", tmp_path)
    assert t == j
    assert j["register"][:3] == (1, [39999], True)
    assert j["push"][:3] == (7, 60, 60) and j["push"][-1]
    assert j["bad_upgrade"] == (1, 0, "deepflow-tpu-agent")
    assert j["escape"] == (False, True, False, 1)


def test_pushed_plugins_fail_the_sync_round(tmp_path):
    """A pushed plugin path neither package can load does not fail the
    sync round (the JAX package's contract: a broken plugin only logs):
    both agents sync, load nothing and count no sync error; [] loads
    nothing either."""
    out = {}
    for package in ("jax", "port"):
        srv, reg = _controller(package)
        mod = jtrident if package == "jax" else ttrident
        cfg = mod.AgentConfig(controller_url=f"http://127.0.0.1:{srv.port}",
                              self_telemetry=False)
        agent = mod.Agent(cfg) if package == "jax" else \
            mod.Agent(cfg, device="cpu")
        steps = []
        try:
            assert agent.sync_once()
            for key in ("so_plugins", "wasm_plugins"):
                reg.set_config("default", {key: ["/nonexistent/p.plugin"]})
                steps.append((agent.sync_once(), dict(agent.so_plugins),
                              dict(agent.wasm_plugins), agent.sync_errors))
            reg.set_config("default", {"so_plugins": [],
                                       "wasm_plugins": []})
            steps.append((agent.sync_once(), dict(agent.so_plugins),
                          dict(agent.wasm_plugins), agent.sync_errors))
        finally:
            srv.close()
            agent.close()
        out[package] = steps
    assert out["port"] == out["jax"] == [(True, {}, {}, 0)] * 3


# the fields the plugin, profiler and watch modules build: an Agent with
# them constructs as the JAX package's does
_BUILT = ("so_plugins", "wasm_plugins", "profile_pids", "k8s_apiserver_url")


def _tls_outcome(agent):
    """enable_tls_uprobes on a library that is not there: the exception
    type where the uprobe PMU is masked (or the image unreadable), else
    the counters."""
    try:
        return agent.enable_tls_uprobes(["/nonexistent/libssl.so.3"])
    except Exception as e:  # noqa: BLE001 -- the outcome is compared
        return type(e).__name__


@pytest.mark.parametrize("field,value", [
    ("so_plugins", ("/x.so",)), ("wasm_plugins", ("/x.wasm",)),
    ("profile_pids", (0,)), ("k8s_apiserver_url", "https://k8s:6443"),
    ("debug_port", 0)])
def test_unported_branches_raise(field, value):
    """Every branch the JAX Agent builds, the port's builds alike: the
    plugin, profiler and watch fields give the JAX Agent's senders and
    plugin sets; `debug_port` opens a debug server with the JAX one's
    handlers, whose `ebpf` dump has the JAX one's keys and values;
    `enable_tls_uprobes` ends as the JAX Agent's does (the same exception
    type where the uprobe PMU is masked, the same counters where not)."""
    t = ttrident.Agent(ttrident.AgentConfig(**{field: value}), device="cpu")
    j = jtrident.Agent(jtrident.AgentConfig(**{field: value}))
    try:
        assert sorted(int(m) for m in t.senders) == \
            sorted(int(m) for m in j.senders)
        if field in _BUILT:
            assert (t.so_plugins, t.wasm_plugins, t.api_watcher) == \
                (j.so_plugins, j.wasm_plugins, j.api_watcher) == ({}, {},
                                                                   None)
            assert t.debug is None and j.debug is None
        else:
            assert sorted(t.debug._handlers) == sorted(j.debug._handlers)
            assert {"policy", "rpc", "platform", "plugins", "ebpf"} <= \
                set(t.debug._handlers)
            dump = t.debug._handlers["ebpf"]({})
            assert dump == j.debug._handlers["ebpf"]({})
            assert {"bpf_available", "socket_trace_attach_capable",
                    "socket_trace_attach_reason", "tls_uprobe_attach_capable",
                    "tls_uprobe_attach_reason"} <= set(dump)
        tls = _tls_outcome(t)
        assert tls == _tls_outcome(j)
        if not isinstance(tls, str):
            # the TLS source now rides the ebpf dump (and the tracer)
            for a in (t, j):
                if a.debug is not None:
                    got = a.debug._handlers["ebpf"]({})
                    assert {"tls_uprobes", "tracer"} <= set(got)
    finally:
        t.close()
        j.close()


def test_managed_agent_reports_tracer_processes():
    """A managed Agent whose eBPF tracer has seen records reports those
    processes in its GPIDSync leg beside its own, as the JAX Agent does,
    and the controller's allocation comes back into the tracer."""
    from deepflow_tpu.agent.ebpf_source import (EbpfTracer as JTracer,
                                                SyscallRecord as JRec)
    from deepflow_tpu_torch.agent.ebpf_source import (EbpfTracer as TTracer,
                                                      SyscallRecord as TRec)
    t0 = 1_700_000_000 * 10**9
    req = b"GET /x HTTP/1.1\r\nHost: a\r\n\r\n"
    out = {}
    for name, trident, tracer_cls, rec_cls in (
            ("jax", jtrident, JTracer, JRec),
            ("port", ttrident, TTracer, TRec)):
        srv, _reg = _controller(name)
        kw = {} if name == "jax" else {"device": "cpu"}
        agent = trident.Agent(trident.AgentConfig(
            controller_url=f"http://127.0.0.1:{srv.port}",
            ctrl_ip="10.1.2.3", host="traced"), **kw)
        try:
            agent.ebpf_tracer = tracer_cls(vtap_id=1)
            for pid in (4242, 4343):
                agent.ebpf_tracer.feed(rec_cls(
                    pid, pid + 1, 0, t0 + pid, 0x0A000001, 0x0A000002,
                    5000 + pid % 7, 80, payload=req,
                    process_kname=f"svc-{pid}"))
            procs = agent._local_processes()
            assert agent.sync_once()
            assert agent.ebpf_tracer.gpid_map is agent.gpid_map
            out[name] = (procs, dict(agent.gpid_map))
        finally:
            agent.close()
            srv.close()
    assert out["port"] == out["jax"]
    pids = [p["pid"] for p in out["port"][0]]
    assert pids[0] == os.getpid() and sorted(pids[1:]) == [4242, 4343]
    assert {4242, 4343} <= set(out["port"][1])


# -- controller-distributed plugins (pkg://) ------------------------------------
MC_SERVER, MC_CLIENT = ip4(172, 20, 0, 7), ip4(10, 9, 0, 1)


def _memcached_frames(rng, n, t0):
    """n memcached sessions on 11211 beside HTTP ones: (frames, stamps)."""
    frames, stamps = [], []
    for i in range(n):
        cport = 20000 + i
        key = f"k{int(rng.integers(1 << 20))}"
        req, resp = rng.choice([("get", f"VALUE {key} 0 1\r\nx\r\nEND"),
                                ("delete", "NOT_FOUND"),
                                ("set", "STORED")])
        body = f"{req} {key}" + (" 0 0 1\r\nx" if req == "set" else "")
        t = t0 + i * 3_000_000
        frames += [eth_ipv4_tcp(MC_CLIENT, MC_SERVER, cport, 11211, ACK,
                                f"{body}\r\n".encode(), seq=i),
                   eth_ipv4_tcp(MC_SERVER, MC_CLIENT, 11211, cport, ACK,
                                f"{resp}\r\n".encode(), seq=i),
                   eth_ipv4_tcp(MC_CLIENT, MC_SERVER, cport + 1, 80, ACK,
                                b"GET /x HTTP/1.1\r\n\r\n", seq=i),
                   eth_ipv4_tcp(MC_SERVER, MC_CLIENT, 80, cport + 1, ACK,
                                b"HTTP/1.1 200 OK\r\n\r\n", seq=i)]
        stamps += [t, t + 1_000_000, t + 1_500_000, t + 2_000_000]
    return frames, np.asarray(stamps, np.uint64)


def _plugin_run(package, tmp, so_bytes, wasm, batches):
    """One agent managed by its own package's controller: plugins pushed
    as pkg:// packages, a batch under each, the fetch failures (a bad
    name, a missing package, a sha256 mismatch in transit, the controller
    down with and without a cache), then []. Returns what each step
    showed and the PROTOCOLLOG stream."""
    import base64
    import importlib
    pkg = "deepflow_tpu" if package == "jax" else "deepflow_tpu_torch"
    ctl = importlib.import_module(f"{pkg}.controller")
    mod = jtrident if package == "jax" else ttrident
    sink = Sink()
    reg = ctl.VTapRegistry()
    srv = ctl.ControllerServer(ctl.ResourceModel(), reg, port=0)
    srv.monitor.set_ingesters([f"127.0.0.1:{sink.port}"])
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    for name, data in (("mc.so", so_bytes), ("mc.wasm", wasm),
                       ("tampered.so", so_bytes)):
        urllib.request.urlopen(urllib.request.Request(
            f"{base}/v1/upgrade-package", data=json.dumps({
                "name": name, "data_b64": base64.b64encode(data).decode()
            }).encode(), headers={"Content-Type": "application/json"}),
            timeout=10).read()
    cfg = mod.AgentConfig(controller_url=base, ctrl_ip="10.6.6.6",
                          host="plugin-host", self_telemetry=False,
                          upgrade_dir=str(tmp / package))
    agent = mod.Agent(cfg) if package == "jax" else \
        mod.Agent(cfg, device="cpu")
    steps = []

    def step(push, frames=None):
        reg.set_config("default", push)
        ok = agent.sync_once()
        if frames is not None:
            agent.feed(*frames)
            agent.tick(int(frames[1][-1]) + NS)
        steps.append((ok, sorted(os.path.basename(p)
                                 for p in agent.so_plugins),
                      sorted(os.path.basename(p) for p in agent.wasm_plugins),
                      agent.plugin_fetch_errors, agent.sync_errors))
    real = urllib.request.urlopen

    def tampering(req, *a, **k):
        resp = real(req, *a, **k)
        url = req if isinstance(req, str) else req.full_url
        if "name=tampered.so" not in url or "meta=1" in url:
            return resp
        doc = json.load(resp)
        doc["sha256"] = "0" * 64
        return io.BytesIO(json.dumps(doc).encode())
    try:
        step({"so_plugins": ["pkg://mc.so"], "wasm_plugins": [],
              "l7_log_rate": 0}, batches[0])
        step({"so_plugins": [], "wasm_plugins": ["pkg://mc.wasm"],
              "l7_log_rate": 0}, batches[1])
        step({"so_plugins": ["pkg://", "pkg://../x.so", "pkg://nope.so"]})
        urllib.request.urlopen = tampering
        try:
            step({"so_plugins": ["pkg://tampered.so"]})
        finally:
            urllib.request.urlopen = real
        step({"so_plugins": [], "wasm_plugins": []}, batches[2])
    finally:
        srv.close()
    # the controller down: the cache is trusted, no cache is an error
    steps.append((os.path.basename(agent._resolve_plugin_path("pkg://mc.so")),
                  agent._resolve_plugin_path("pkg://never.so"),
                  agent.plugin_fetch_errors))
    agent.tick(final=True)
    streams = sink.drain(agent.senders)
    agent.close()
    sink.close()
    return steps, streams.get(int(ttrident.MessageType.PROTOCOLLOG), b"")


def test_distributed_plugins_match_reference(tmp_path):
    from deepflow_tpu_torch.agent.plugin import build_sample_plugin
    from deepflow_tpu_torch.agent.wasm_samples import build_memcached_wasm
    with open(build_sample_plugin(), "rb") as f:
        so_bytes = f.read()
    wasm = build_memcached_wasm()
    rng = np.random.default_rng(0xC3)
    batches = [_memcached_frames(rng, 12, T0 + k * NS) for k in range(3)]
    j = _plugin_run("jax", tmp_path, so_bytes, wasm, batches)
    t = _plugin_run("port", tmp_path, so_bytes, wasm, batches)
    assert t[0] == j[0]
    assert t[1] == j[1] and len(j[1]) > 0
    assert [s[1:3] for s in j[0][:2]] == [(["mc.so"], []), ([], ["mc.wasm"])]
    # a bad name (empty, a path) x2 and a missing package, then the
    # sha256 mismatch; [] unloads; offline: cache trusted, none counted
    assert [s[3] for s in j[0][2:5]] == [3, 4, 4]
    assert j[0][4][1:3] == ([], [])
    assert j[0][5] == ("mc.so", None, 5)
    from deepflow_tpu.wire.gen import flow_log_pb2
    protos = []
    for rec in stream_records(j[1]):
        protos.append(flow_log_pb2.AppProtoLogsData.FromString(
            rec).base.head.proto)
    assert protos.count(201) == 12 and protos.count(202) == 12


def stream_records(stream):
    from deepflow_tpu_torch.wire.codec import iter_pb_records
    from deepflow_tpu_torch.wire.framing import FrameReader
    return [r for f in FrameReader().feed(stream)
            for r in iter_pb_records(f.payload)]


def test_apiserver_watch_preferred_over_the_file(tmp_path):
    """k8s_apiserver_url and k8s_resource_file both set: each package's
    agent lists the apiserver, and its controller's model holds the
    apiserver's pods, not the file's."""
    import chip_smoke
    objects = {"pods": [chip_smoke.k8s_obj("pods", f"api-{i}", 1, ns="ns",
                                           ip=f"10.1.0.{i + 1}", node="n1")
                        for i in range(5)],
               "nodes": [chip_smoke.k8s_obj("nodes", "n1", 1,
                                            ip="10.255.0.1")],
               "namespaces": [chip_smoke.k8s_obj("namespaces", "ns", 1)],
               "services": []}
    api = chip_smoke.FakeApiserver(objects, hold_s=0.3)
    path = tmp_path / "k8s.json"
    path.write_text(json.dumps([{"type": "pod", "name": "file-pod",
                                 "ip": "10.2.0.1"}]))
    out = {}
    try:
        for package in ("jax", "port"):
            srv, _ = _controller(package)
            mod = jtrident if package == "jax" else ttrident
            cfg = mod.AgentConfig(
                controller_url=f"http://127.0.0.1:{srv.port}",
                k8s_apiserver_url=api.url, k8s_resource_file=str(path),
                platform_sync_interval_s=0.2, self_telemetry=False)
            agent = mod.Agent(cfg) if package == "jax" else \
                mod.Agent(cfg, device="cpu")
            agent.start()
            try:
                deadline = time.time() + 30
                names = set()
                while time.time() < deadline and len(names) < 5:
                    names = {r.name for r in srv.model.list(type="pod")}
                    time.sleep(0.05)
                out[package] = (sorted(names), agent.api_watcher is not None,
                                agent.k8s_watcher.lister ==
                                agent.api_watcher.snapshot)
            finally:
                agent.close()
                srv.close()
    finally:
        api.close()
    assert out["port"] == out["jax"] == (
        [f"api-{i}" for i in range(5)], True, True)


# -- the bootstrap -----------------------------------------------------------------
BOOTSTRAPS = [
    "",
    "controller_url: http://10.0.0.1:20417\nhost: h1\n",
    "capture: {engine: pcap, path: /tmp/x.pcap}\nwire_mode: protobuf\n",
    "capture: {engine: ring, iface: eth0, block_size: 1048576, "
    "block_count: 8, bpf: {proto: 6, port: 80, sample_shift: 2}}\n",
    "capture: {engine: raw, iface: eth0, snaplen: 128, poll_ms: 5}\n",
    "capture: {engine: xdp, iface: eth0, queue: 1, frame_count: 4096}\n",
    "capture: null\nso_plugins: [/a.so, /b.so]\nlocal_macs: [aa]\n",
    "capture: {engine: none, colour: red}\n",
    "capture: {engine: dpdk}\n",
    "capture: {engine: pcap}\n",
    "capture: {engine: xdp}\n",
    "capture: {engine: ring, iface: eth0, snaplen: 9}\n",
    "capture: {engine: raw, iface: eth0, block_size: 9}\n",
    "capture: {engine: ring, iface: eth0, queue: 1}\n",
    "capture: {engine: pcap, path: x, bpf: {proto: 6}}\n",
    "capture: {engine: raw, iface: eth0, bpf: {proto: 6, vlan: 1}}\n",
    "capture: {engine: raw, iface: eth0, bpf: {port: 70000}}\n",
    "capture: {engine: raw, iface: eth0, bpf: {sample_shift: x}}\n",
    "capture: {engine: raw, iface: eth0, bpf: {proto: true}}\n",
    "ingester: 1.2.3.4\n",
    "host: [unclosed\n",
    "l7_log_rate: {}\n",
]


def _load(mod, path):
    try:
        cfg, capture = mod.load_bootstrap(str(path))
    except Exception as e:      # the answer compared is the exception
        return type(e).__name__, str(e).replace(str(path), "<path>")
    return vars(cfg), capture


@pytest.mark.parametrize("i", range(len(BOOTSTRAPS)))
def test_bootstrap_matches_reference(i, tmp_path):
    path = tmp_path / "agent.yaml"
    path.write_text(BOOTSTRAPS[i])
    j, t = _load(jmain, path), _load(tmain, path)
    assert t == j
    out = {}
    for name, mod in (("jax", jmain), ("port", tmain)):
        so, se = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            rc = mod.main(["-f", str(path), "--dry-run"])
        out[name] = (rc, so.getvalue(), se.getvalue())
    assert out["port"] == out["jax"]


def test_bootstrap_reads_json_without_pyyaml(tmp_path, monkeypatch):
    real = builtins.__import__

    def no_yaml(name, *a, **k):
        if name == "yaml":
            raise ImportError("no yaml")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_yaml)
    good = tmp_path / "a.json"
    good.write_text(json.dumps({"host": "h", "capture": {
        "engine": "pcap", "path": "/x.pcap"}, "local_macs": ["m"]}))
    cfg, capture = tmain.load_bootstrap(str(good))
    assert cfg.host == "h" and cfg.local_macs == ("m",)
    assert capture == {"engine": "pcap", "path": "/x.pcap"}
    bad = tmp_path / "b.yaml"
    bad.write_text("host: h\n")
    with pytest.raises(ValueError, match="PyYAML is not installed"):
        tmain.load_bootstrap(str(bad))
    assert tmain.main(["-f", str(bad), "--dry-run"]) == 2


@pytest.mark.parametrize("capture", [
    {"engine": "xdp", "iface": "eth0"},
    {"engine": "raw", "iface": "eth0", "bpf": {"proto": 6}}])
def test_unported_capture_raises(capture):
    """The xdp engine and the bpf filter are built now: on an interface
    this host may lack, both packages' build_source end alike (the
    source, or the same error with the filter closed)."""
    out = []
    for mod in (jmain, tmain):
        try:
            src = mod.build_source(dict(capture))
        except Exception as e:  # noqa: BLE001 -- the answer compared
            out.append((type(e).__name__, str(e)))
        else:
            out.append(type(src).__name__)
            if getattr(src, "bpf", None) is not None:
                src.bpf.close()
            src.close()
    assert out[1] == out[0]


def test_build_source_builds_filter_and_xdp(monkeypatch):
    """capture.bpf builds a BpfFilter that rides the source (attached
    before bind); engine xdp builds an XdpSource with the block's
    keywords: as the JAX package's build_source does."""
    from deepflow_tpu.agent import bpf as jbpf
    from deepflow_tpu.agent import xdp as jxdp
    from deepflow_tpu_torch.agent import bpf as tbpf
    from deepflow_tpu_torch.agent import xdp as txdp
    if not tbpf.available():
        pytest.skip("bpf(2) socket filters refused here")
    capture = {"engine": "raw", "iface": "lo", "snaplen": 256,
               "poll_ms": 5, "bpf": {"proto": 17, "port": 5353,
                                     "sample_shift": 1}}
    got = []
    for mod, bpf in ((jmain, jbpf), (tmain, tbpf)):
        src = mod.build_source(dict(capture))
        try:
            assert isinstance(src.bpf, bpf.BpfFilter)
            got.append((type(src).__name__, src.bpf.spec, src.snaplen,
                        src.bpf.counters()))
        finally:
            src.close()
            src.bpf.close()
    assert got[1] == got[0]
    # the XDP source is recorded, not attached (a redirect on lo consumes
    # its ingress while the suite runs)
    calls = []
    for mod, xdp in ((jmain, jxdp), (tmain, txdp)):
        monkeypatch.setattr(xdp, "XdpSource",
                            lambda iface, **kw: calls.append((iface, kw))
                            or types.SimpleNamespace())
        mod.build_source({"engine": "xdp", "iface": "lo", "queue": 1,
                          "frame_count": 128, "batch_size": 64,
                          "poll_ms": 7})
    assert calls[1] == calls[0] == ("lo", {"queue": 1, "frame_count": 128,
                                           "batch_size": 64, "poll_ms": 7})


# -- the process -------------------------------------------------------------------
def _agent_process(cfg_path, *extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-m", "deepflow_tpu_torch.agent", "-f",
         str(cfg_path), *extra], cwd=str(REPO), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_process_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    path = tmp_path / "agent.json"
    path.write_text(json.dumps({"self_telemetry": False}))
    p = _agent_process(path)
    out, err = p.communicate(timeout=120)
    assert p.returncode != 0 and "torch.cuda.is_available() is False" in err


def test_process_replays_a_pcap_into_the_server(tmp_path):
    """The agent process on the CPU replays a pcap into the port's Server
    (on the CPU); SIGTERM ends it with exit 0, and what the server took in
    adds up to the pcap."""
    from deepflow_tpu_torch import server as tserver
    from deepflow_tpu_torch.agent.packet import decode_packets

    frames, stamps = [], []
    # stamped from now, so the agent's wall-clock ticks see live flows
    for per_sec in traffic(7, n_flows=28, t0=time.time_ns() // NS * NS):
        for f, s in per_sec:
            frames += f
            stamps += s.tolist()
    pcap = tmp_path / "capture.pcap"
    tpcap.write_pcap(str(pcap), frames, stamps)
    valid = decode_packets(frames, np.asarray(stamps, np.uint64))["valid"]
    scfg = tmp_path / "server.json"
    scfg.write_text(json.dumps({
        "controller": {"enabled": False},
        "ingester": {"port": 0, "store_path": str(tmp_path / "store"),
                     "n_decoders": 1},
        "querier": {"enabled": False}, "self_telemetry": False}))
    srv = tserver.Server(str(scfg), device="cpu")
    srv.start()
    try:
        ing = srv.ingester
        acfg = tmp_path / "agent.json"
        acfg.write_text(json.dumps({
            "ingester_addr": f"127.0.0.1:{ing.port}",
            "packet_sequence": True,
            "capture": {"engine": "pcap", "path": str(pcap)}}))
        p = _agent_process(acfg, "--device", "cpu")
        try:
            # the first tick's frames arrive once the replay is under way
            deadline = time.time() + 120
            while time.time() < deadline and p.poll() is None and \
                    not ing.receiver.counters().get("rx_frames"):
                time.sleep(0.1)
            time.sleep(1.5)
            p.send_signal(signal.SIGTERM)
            out, err = p.communicate(timeout=60)
        finally:
            if p.poll() is None:
                p.kill()
        assert p.returncode == 0, err[-2000:]

        def packets():
            ing.flush()
            l4 = ing.store.table("flow_log", "l4_flow_log").scan()
            return int(l4["packet_tx"].sum() + l4["packet_rx"].sum())
        deadline = time.time() + 30
        while packets() != int(valid.sum()) and time.time() < deadline:
            time.sleep(0.2)
        assert packets() == int(valid.sum())
        for db, table in (("flow_log", "l7_flow_log"),
                          ("flow_log", "l4_packet"),
                          ("deepflow_system", "ext_samples")):
            deadline = time.time() + 30
            while not ing.store.table(db, table).row_count() and \
                    time.time() < deadline:
                time.sleep(0.2)
                ing.flush()
            assert ing.store.table(db, table).row_count() > 0, table
    finally:
        srv.close()
