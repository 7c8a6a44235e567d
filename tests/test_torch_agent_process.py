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

Managed mode runs both agents against the JAX package's
`ControllerServer` over HTTP (the port never imports it). The bootstrap
cases hold both packages' `load_bootstrap` and `main` to the same
answers and messages. The process case runs `python -m
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
def _controller():
    from deepflow_tpu.controller import (ControllerServer, ResourceModel,
                                         VTapRegistry)
    from deepflow_tpu.controller.monitor import FleetMonitor

    reg = VTapRegistry()
    mon = FleetMonitor(reg)
    mon.set_ingesters(["127.0.0.1:39999"])
    srv = ControllerServer(ResourceModel(), reg, mon, port=0)
    srv.start()
    return srv, reg


def _managed_run(package, tmp):
    """One agent against a fresh controller: registration, pushes, a
    bad upgrade, a plugin push, then the controller gone and the escape
    timer. Returns what each step showed."""
    srv, reg = _controller()
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
    """A pushed plugin list the port cannot load fails the round: the
    synchronizer counts it in sync_errors as it counts any failed round."""
    srv, reg = _controller()
    agent = ttrident.Agent(ttrident.AgentConfig(
        controller_url=f"http://127.0.0.1:{srv.port}", self_telemetry=False),
        device="cpu")
    try:
        assert agent.sync_once()
        for key in ("so_plugins", "wasm_plugins"):
            reg.set_config("default", {key: ["/nonexistent/p.plugin"]})
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                agent.sync_once()
        before = agent.sync_errors
        agent.cfg.sync_interval_s = 0.05     # the default push set 60
        th = threading.Thread(target=agent._sync_loop, daemon=True)
        th.start()
        deadline = time.time() + 10
        while agent.sync_errors < before + 2 and time.time() < deadline:
            time.sleep(0.02)
        agent._stop.set()
        th.join(timeout=5)
        assert agent.sync_errors >= before + 2
        reg.set_config("default", {"so_plugins": [], "wasm_plugins": []})
        agent._stop.clear()
        assert agent.sync_once()      # an empty list loads nothing
    finally:
        agent._stop.set()
        srv.close()
        agent.close()


@pytest.mark.parametrize("field,value", [
    ("so_plugins", ("/x.so",)), ("wasm_plugins", ("/x.wasm",)),
    ("profile_pids", (0,)), ("k8s_apiserver_url", "https://k8s:6443"),
    ("debug_port", 0)])
def test_unported_branches_raise(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        ttrident.Agent(ttrident.AgentConfig(**{field: value}), device="cpu")
    agent = ttrident.Agent(ttrident.AgentConfig(), device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            agent.enable_tls_uprobes(["/lib/libssl.so"])
    finally:
        agent.close()


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
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        tmain.build_source(capture)


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
