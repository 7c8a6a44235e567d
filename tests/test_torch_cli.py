"""The port's ops CLI (`python -m deepflow_tpu_torch.cli`) against the
JAX package's `df-ctl`, on the CPU.

One script of subcommands (fleet listing, group-config CRUD and its
example, a domain push and the resource listing, a filereader cloud
domain's add/refresh/list/delete, genesis and the recorder, SQL with
its error, PromQL, the upgrade status, an empty incident directory,
the live-agent debug commands) runs through both packages' CLIs
against one set of servers, first the port's (controller, querier, an
`Agent` with a debug port), then the JAX package's: exit codes,
standard output and standard error are equal, under a frozen clock.
`replay-pcap` gives equal counts through both packages' Agents, and
both packages' agent processes answer the port's df-ctl alike on their
debug ports. `lint`, `lint --list-rules`, `verify` and `verify
--mutants` give the reference's exit codes and rule and mutant lists,
each package over its own tree. The JAX package's
`test_cli.py` then runs against the port
(`torch_ctl_pair.adopt_reference_tests`).
"""

import importlib
import json
import re

import numpy as np
import pytest

import torch_ctl_pair as cp
from torch_plugin_pair import agent_on_cpu  # noqa: F401

from deepflow_tpu import cli as jcli
from deepflow_tpu_torch import cli as tcli


@pytest.fixture
def cpu_defaults(monkeypatch):
    """The port's querier defaults to the card; here, to the CPU (the
    reference test bodies build it without a device)."""
    from deepflow_tpu_torch.querier.engine import QueryEngine
    from deepflow_tpu_torch.querier.server import QuerierServer
    for init in (QueryEngine.__init__, QuerierServer.__init__):
        monkeypatch.setattr(init, "__defaults__", tuple(
            "cpu" if d == "cuda" else d for d in init.__defaults__))


def _stack(pkg, tmp, device):
    """Controller, querier and an agent with a debug port, of `pkg`."""
    ctl = importlib.import_module(f"{pkg}.controller")
    mon = importlib.import_module(f"{pkg}.controller.monitor")
    qs = importlib.import_module(f"{pkg}.querier.server")
    table = importlib.import_module(f"{pkg}.store.table")
    db = importlib.import_module(f"{pkg}.store.db")
    dicts = importlib.import_module(f"{pkg}.store.dict_store")
    trident = importlib.import_module(f"{pkg}.agent.trident")
    reg = ctl.VTapRegistry()
    reg.sync("10.0.0.1", "node-1", revision="v1.0")
    srv = ctl.ControllerServer(ctl.ResourceModel(), reg,
                               mon.FleetMonitor(reg), port=0)
    srv.start()
    store = db.Store(str(tmp / "store"))
    t = store.create_table("flow_log", table.TableSchema(
        name="flows", columns=(
            table.ColumnSpec("timestamp", np.dtype(np.uint32),
                             table.AggKind.KEY),
            table.ColumnSpec("bytes", np.dtype(np.uint32),
                             table.AggKind.SUM))))
    t.append({"timestamp": np.arange(10, dtype=np.uint32),
              "bytes": np.arange(10, dtype=np.uint32) * 7})
    kw = {} if device is None else {"device": device}
    qsrv = qs.QuerierServer(store, dicts.TagDictRegistry(None), port=0, **kw)
    qsrv.start()
    agent = trident.Agent(trident.AgentConfig(
        debug_port=0, controller_url="http://127.0.0.1:1"), **kw)
    agent.start()
    return srv, qsrv, agent


def _script(tmp, ctl, q, dbg):
    snap = tmp / "resources.json"
    snap.write_text(json.dumps([{"type": "pod", "id": 1, "name": "p1",
                                 "ip": "10.0.0.9"},
                                {"type": "pod", "id": 2, "name": "p2",
                                 "ip": "10.0.0.10"}]))
    doc = tmp / "cloud.json"
    doc.write_text(json.dumps({"vpcs": [{"name": "vpc1"}],
                               "regions": [{"name": "r1"}]}))
    cfg = tmp / "group.yaml"
    cfg.write_text("l7_log_enabled: false\nmax_memory_mb: 512\n")
    (tmp / "incidents").mkdir()
    c, qq, d = ("--controller", ctl), ("--querier", q), ("--debug-port",
                                                         str(dbg))
    return [
        [*c, "agent", "list"],
        [*c, "agent-group-config", "set", "--set", "max_cpus=8"],
        [*c, "agent-group-config", "set", "--file", str(cfg)],
        [*c, "agent-group-config"],
        [*c, "agent-group-config", "--set", "max_cpus=2"],
        [*c, "agent-group-config", "set", "--set", "so_plugins=/x.so"],
        ["agent-group-config", "example"],
        [*c, "domain", "k8s", "-f", str(snap)],
        [*c, "resource", "--type", "pod"],
        [*c, "resource"],
        [*c, "cloud", "add", "file-d", "--platform", "filereader",
         "--path", str(doc), "--interval", "3600"],
        [*c, "cloud", "refresh", "file-d"],
        [*c, "cloud", "list"],
        [*c, "cloud", "delete", "file-d"],
        [*c, "cloud", "add", "bad", "--platform", "tencent"],
        [*c, "genesis"],
        [*c, "agent-upgrade", "status"],
        [*qq, "query", "SELECT Sum(bytes) AS total, Count(*) AS n FROM "
         "flows", "-d", "flow_log"],
        [*qq, "query", "SELECT timestamp, bytes FROM flows WHERE "
         "bytes > 20 ORDER BY bytes DESC LIMIT 3", "-d", "flow_log"],
        [*qq, "query", "SELECT nope FROM missing"],
        [*qq, "promql", "sum(nothing_here)"],
        ["incident", "list", "--dir", str(tmp / "incidents")],
        ["incident", "show", "--dir", str(tmp / "incidents"), "--id", "x"],
        ["agent", "ping"],
        [*d, "agent", "ping"],
        [*d, "agent", "rpc"],
        [*d, "agent", "plugins"],
        [*d, "agent", "policy"],
        [*d, "agent", "platform"],
        [*c, "recorder"],
    ]


def _masked(argv, out):
    """`cloud list`'s COST_S column is a measured time: dropped."""
    if argv[-2:] != ["cloud", "list"]:
        return out
    return "\n".join(" ".join(w for i, w in enumerate(line.split())
                               if i != 5) for line in out.splitlines())


def _run(main, argv, capsys):
    rc = main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("servers", ["deepflow_tpu_torch", "deepflow_tpu"])
def test_cli_output_equal(servers, tmp_path, capsys, monkeypatch):
    cp.FrozenClock(monkeypatch)
    runs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        tmp = tmp_path / name
        tmp.mkdir()
        srv, qsrv, agent = _stack(
            servers, tmp, "cpu" if servers == "deepflow_tpu_torch" else None)
        try:
            script = _script(tmp, f"http://127.0.0.1:{srv.port}",
                             f"http://127.0.0.1:{qsrv.port}",
                             agent.debug.port)
            runs[name] = []
            for argv in script:
                rc, out, err = _run(main, argv, capsys)
                runs[name].append((rc, _masked(argv, out), err))
            # the genesis route between the listings
            import urllib.request
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/genesis",
                data=json.dumps({"ctrl_ip": "10.0.0.1", "host": "n1",
                                 "interfaces": [{"name": "eth0",
                                                 "ip": "10.0.0.1"}]}
                                ).encode(),
                headers={"Content-Type": "application/json"})).read()
            runs[name].append(_run(main, ["--controller",
                                          f"http://127.0.0.1:{srv.port}",
                                          "genesis"], capsys))
        finally:
            agent.close()
            qsrv.close()
            srv.close()
    port = [(rc, out.replace(str(tmp_path / "port"), "<tmp>"),
             err.replace(str(tmp_path / "port"), "<tmp>"))
            for rc, out, err in runs["port"]]
    jax = [(rc, out.replace(str(tmp_path / "jax"), "<tmp>"),
            err.replace(str(tmp_path / "jax"), "<tmp>"))
           for rc, out, err in runs["jax"]]
    for i, (p, j) in enumerate(zip(port, jax)):
        assert p == j, (i, p, j)
    assert len(port) == len(jax)
    rcs = [r[0] for r in port]
    assert rcs.count(0) > len(rcs) // 2 and set(rcs) <= {0, 1, 2}
    assert "pong" in port[24][1] and "n1:eth0" in port[-1][1]


_ELAPSED = re.compile(r"elapsed=[0-9.]+s|\[([0-9]+ states), [0-9.]+s\]")


def _jax_conform_in_lockstep(monkeypatch, tmp_path):
    """The JAX package's conformance store rebuilt from its own tree
    into tmp_path (its committed one is behind its tree), so its
    `verify` gates on the models alone, as the port's does."""
    from deepflow_tpu.analysis import core
    from deepflow_tpu.analysis.model import conform
    _ctxs, index, errors = core.build_index(core.load_package_sources())
    store, missing = conform.build_store(index)
    assert errors == [] and missing == []
    path = tmp_path / "model-conform.json"
    conform.save_store(store, str(path))
    monkeypatch.setattr(core, "default_conform_store_path",
                        lambda: str(path))


@pytest.mark.parametrize("cmd", [["lint"], ["lint", "--list-rules"],
                                 ["verify"], ["verify", "--mutants"]])
def test_analysis_commands_match_the_reference(cmd, capsys, monkeypatch,
                                               tmp_path):
    """`lint` (each package's self-scan with no baseline: both find
    findings), `lint --list-rules` (the same rules, word for word),
    `verify` (the same models proven, conformance clean) and `verify
    --mutants` (the same mutants killed with the same traces): the
    reference's exit codes and lists."""
    if cmd[0] == "verify":
        _jax_conform_in_lockstep(monkeypatch, tmp_path)
    rp, out_p, _ = _run(tcli.main, cmd, capsys)
    rj, out_j, _ = _run(jcli.main, cmd, capsys)
    assert rp == rj == (1 if cmd == ["lint"] else 0)
    if cmd == ["lint"]:
        assert "deepflow_tpu_torch/" in out_p
        assert "deepflow_tpu/" not in out_p.replace("deepflow_tpu_torch/", "")
        return
    assert _ELAPSED.sub(r"\1", out_p) == _ELAPSED.sub(r"\1", out_j)
    if cmd == ["verify"]:
        assert out_p.count("result: OK") == 4
        assert "conformance: models and code agree" in out_p
    elif cmd[0] == "verify":
        assert "all 14 seeded mutants killed" in out_p


def test_replay_pcap_equal(tmp_path, capsys):
    """`replay-pcap` through both packages' Agents (the port's on the CPU)
    into an ingester that is not there: the same frame, packet and send
    counts."""
    from deepflow_tpu_torch.agent.pcap import PcapWriter
    frames, stamps = [], []
    for i in range(64):
        payload = b"GET /x HTTP/1.1\r\nHost: h\r\n\r\n" if i % 2 == 0 \
            else b"HTTP/1.1 200 OK\r\nContent-Length: 0\r\n\r\n"
        src, dst = (0x0A000001, 0x0A000002) if i % 2 == 0 else \
            (0x0A000002, 0x0A000001)
        sp, dp = (40000 + i // 2, 80) if i % 2 == 0 else (80, 40000 + i // 2)
        ip = (b"\x45\x00" + (40 + len(payload)).to_bytes(2, "big")
              + b"\x00\x00\x40\x00\x40\x06\x00\x00" + src.to_bytes(4, "big")
              + dst.to_bytes(4, "big"))
        tcp = (sp.to_bytes(2, "big") + dp.to_bytes(2, "big")
               + (1000 + i).to_bytes(4, "big") + (2000 + i).to_bytes(4, "big")
               + b"\x50\x18\xff\xff\x00\x00\x00\x00")
        frames.append(b"\x02" * 6 + b"\x04" * 6 + b"\x08\x00" + ip + tcp
                      + payload)
        stamps.append(1_700_000_000_000_000_000 + i * 1_000_000)
    path = tmp_path / "c.pcap"
    w = PcapWriter(str(path))
    w.write(frames, stamps)
    w.close()
    argv = ["replay-pcap", str(path), "--ingester", "127.0.0.1:1",
            "--batch", "16"]
    j = _run(jcli.main, argv, capsys)
    t = _run(tcli.main, argv + ["--device", "cpu"], capsys)
    assert t == j and t[0] == 0
    assert json.loads(t[1])["valid_packets"] == 64


def _free_udp_port():
    import socket
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_agent_processes_answer_equal(tmp_path, capsys):
    """Both packages' agent processes (`python -m <pkg>.agent`, no capture,
    a debug port each): the port's df-ctl gets equal answers from both,
    their ebpf dumps are equal, and SIGTERM ends both with 0."""
    import os
    import signal
    import subprocess
    import sys
    import time

    from deepflow_tpu_torch.runtime.debug import debug_request
    repo = cp.TESTS.parent
    procs, ports = {}, {}
    try:
        for pkg in ("deepflow_tpu", "deepflow_tpu_torch"):
            ports[pkg] = _free_udp_port()
            boot = tmp_path / f"{pkg}.json"
            boot.write_text(json.dumps({
                "controller_url": "http://127.0.0.1:1",
                "debug_port": ports[pkg], "capture": {"engine": "none"}}))
            extra = ["--device", "cpu"] if pkg == "deepflow_tpu_torch" \
                else []
            procs[pkg] = subprocess.Popen(
                [sys.executable, "-m", f"{pkg}.agent", "-f", str(boot),
                 *extra], cwd=repo, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                env=dict(os.environ, PYTHONPATH=str(repo)))
        for pkg, port in ports.items():
            deadline = time.monotonic() + 120
            while True:
                try:
                    if debug_request("ping", port=port,
                                     timeout=0.5).get("ok"):
                        break
                except OSError:
                    pass
                assert procs[pkg].poll() is None, procs[pkg].stderr.read()
                assert time.monotonic() < deadline, f"{pkg}: no debug port"
        answers = {}
        for pkg, port in ports.items():
            answers[pkg] = [_run(tcli.main, ["--debug-port", str(port),
                                             "agent", cmd], capsys)
                            for cmd in ("ping", "plugins", "rpc", "policy")]
            answers[pkg].append(debug_request("ebpf", port=port))
        assert answers["deepflow_tpu_torch"] == answers["deepflow_tpu"]
        assert answers["deepflow_tpu_torch"][0][0] == 0
        assert "bpf_available" in answers["deepflow_tpu_torch"][-1]["data"]
        for pkg, p in procs.items():
            p.send_signal(signal.SIGTERM)
            p.communicate(timeout=60)
            assert p.returncode == 0, pkg
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


# -- the JAX package's CLI tests, on the port -------------------------------
@pytest.fixture(autouse=True)
def _ref_on_cpu(agent_on_cpu, cpu_defaults):  # noqa: F811
    """The reference bodies build the port's querier and Agent on the
    CPU."""


cp.adopt_reference_tests(globals(), cp.TESTS / "test_cli.py")
