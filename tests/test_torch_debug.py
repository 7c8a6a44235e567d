"""The port's UDP debug server (runtime/debug.py) and the Ingester's debug
commands against the JAX package's, on the CPU.

Built-in commands: both servers over registries holding the same
Countables answer `ping` and `counters` alike, and `supervisor` alike
over fresh supervision trees; `lint` answers with the reference's keys
and findings over one fixture tree (each package's analyzer), and the
server keeps serving; an unknown command gets the
reference's error. The Ingester's commands: both packages' ingesters,
built on the same config (small ingest queues, a disk spill, storage,
the timeline off) and not started, get the same frames put into their
l4 ingest queue with the spill armed and the same put outcomes through
a flaky exporter: `queues`, `breakers` and `spill` answer alike."""

import numpy as np
import pytest

from deepflow_tpu.pipelines.ingester import Ingester as JIngester
from deepflow_tpu.pipelines.ingester import IngesterConfig as JConfig
from deepflow_tpu.runtime import debug as jdebug
from deepflow_tpu.runtime import faults as jfaults
from deepflow_tpu.runtime import supervisor as jsup
from deepflow_tpu.runtime.stats import StatsRegistry as JStats
from deepflow_tpu_torch.pipelines.ingester import Ingester, IngesterConfig
from deepflow_tpu_torch.runtime import debug as tdebug
from deepflow_tpu_torch.runtime import faults as tfaults
from deepflow_tpu_torch.runtime import supervisor as tsup
from deepflow_tpu_torch.runtime.stats import StatsRegistry as TStats
from deepflow_tpu_torch.wire import framing as tframing


@pytest.fixture(autouse=True)
def _disarm():
    yield
    jfaults.default_faults().disarm()
    tfaults.default_faults().disarm()


def _stats(cls):
    s = cls()
    s.register("receiver", lambda: {"rx_frames": 12, "mode": "tcp"},
               tags={"port": "30033"})
    s.register("exporter.tpu_sketch", lambda: {"rows_in": 4096,
                                               "h2d_bytes": 65536.5})
    return s


@pytest.fixture
def servers(monkeypatch):
    """One debug server per package, each on a fresh supervision tree."""
    sups = {"t": tsup.Supervisor(), "j": jsup.Supervisor()}
    monkeypatch.setattr(tsup, "default_supervisor", lambda: sups["t"])
    monkeypatch.setattr(jsup, "default_supervisor", lambda: sups["j"])
    t = tdebug.DebugServer(_stats(TStats), port=0)
    j = jdebug.DebugServer(_stats(JStats), port=0)
    t.start()
    j.start()
    try:
        yield t, j
    finally:
        t.close()
        j.close()
        sups["t"].close()
        sups["j"].close()


@pytest.mark.parametrize("req", [
    {"cmd": "ping"}, {"cmd": "counters"},
    {"cmd": "counters", "module": "exporter"},
    {"cmd": "supervisor"}, {"cmd": "supervisor", "module": "debug"},
    {"cmd": "no-such-command"}])
def test_builtin_replies_equal(servers, req):
    t, j = servers
    kw = {k: v for k, v in req.items() if k != "cmd"}
    rt = tdebug.debug_request(req["cmd"], port=t.port, **kw)
    rj = jdebug.debug_request(req["cmd"], port=j.port, **kw)
    assert rt == rj
    if req["cmd"] == "supervisor":
        assert rt["data"]["threads"][0]["name"] == "debug-udp"


# one fixture tree with findings of several rules (an unsupervised
# thread, an emit under a lock, a drop nothing counts)
_LINT_TREE = {
    "pkg/threads.py": "import threading\nt = threading.Thread(target=print)\n",
    "runtime/q.py": ("import threading\n"
                     "class Q:\n"
                     "    def __init__(self):\n"
                     "        self._lock = threading.Lock()\n"
                     "    def go(self, sink, x):\n"
                     "        with self._lock:\n"
                     "            sink.emit(x)\n"),
    "runtime/d.py": ("class D:\n"
                     "    def put(self, batch):\n"
                     "        if self._closed:\n"
                     "            return\n"
                     "        self._emit(batch)\n"),
}


def test_lint_answers_like_the_reference_and_the_server_keeps_serving(
        servers, monkeypatch):
    """Each package's debug `lint` over its own analyzer's scan of one
    fixture tree: the reference's keys, totals, `by_rule` and findings;
    `module` filters alike; the server answers `ping` after."""
    from deepflow_tpu import analysis as janalysis
    from deepflow_tpu_torch import analysis as tanalysis
    for mod in (janalysis, tanalysis):
        monkeypatch.setattr(
            mod, "scan_package",
            lambda run=mod.run_on_sources: run(_LINT_TREE))
    t, j = servers
    for kw in ({}, {"module": "runtime/"}):
        rt = tdebug.debug_request("lint", port=t.port, timeout=60.0, **kw)
        rj = jdebug.debug_request("lint", port=j.port, timeout=60.0, **kw)
        assert rt["ok"] and rj["ok"]
        assert sorted(rt["data"]) == ["by_rule", "findings", "total"]
        assert rt == rj
    assert rt["data"]["by_rule"] == {"emit-under-lock": 1, "silent-drop": 1}
    assert tdebug.debug_request("ping", port=t.port) == \
        {"ok": True, "data": "pong"}


@pytest.mark.parametrize("cmd", ["latency", "spans", "rrt",
                                 "trace-export", "stacks"])
def test_recorder_commands_answer_with_the_reference_keys(servers, cmd):
    t, j = servers
    rt = tdebug.debug_request(cmd, port=t.port)
    rj = jdebug.debug_request(cmd, port=j.port)
    assert rt["ok"] and rj["ok"]
    if cmd != "stacks":
        assert sorted(rt["data"]) == sorted(rj["data"])


class _Flaky:
    """An exporter whose puts fail on a seeded schedule."""

    name = "flaky"

    def __init__(self, fails):
        self.fails = list(fails)

    def start(self):
        pass

    def close(self):
        pass

    def is_export_data(self, stream, cols):
        return True

    def put(self, stream, decoder_index, cols):
        if self.fails.pop(0):
            raise ValueError("flaky")


def _frames(mod_frame_reader, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        payload = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
        raw = tframing.encode_frame(
            tframing.MessageType.TAGGEDFLOW, payload,
            tframing.FlowHeader(sequence=i + 1, vtap_id=3))
        out.extend(mod_frame_reader().feed(raw))
    return out


def _ingester(cls, cfg_cls, root, fails, device=None):
    cfg = cfg_cls(listen_port=0, debug_port=0, store_path=str(root),
                  spill_dir=str(root / "spill"), n_decoders=1,
                  queue_size=64, spill_segment_bytes=4096,
                  timeline_sample_s=0)
    ing = cls(cfg) if device is None else cls(cfg, device=device)
    ing.exporters.register(_Flaky(fails))
    return ing


def test_ingester_commands_equal(tmp_path):
    from deepflow_tpu.wire.framing import FrameReader as JReader
    from deepflow_tpu_torch.wire.framing import FrameReader as TReader
    fails = list(np.random.default_rng(4).random(40) < 0.6)
    t = _ingester(Ingester, IngesterConfig, tmp_path / "t", fails, "cpu")
    j = _ingester(JIngester, JConfig, tmp_path / "j", fails)
    try:
        for ing, reader in ((t, TReader), (j, JReader)):
            ing.debug.start()
            ing.spill.start()
            q = dict(ing._own_queues())["ingest.l4_flow_log"]
            frames = _frames(reader, 100, 9)
            for i in range(0, 100, 10):
                q.puts(3, frames[i:i + 10])
            for _ in range(40):
                ing.exporters.put("l4_flow_log", 0, {"x": np.zeros(2)})
        for req in ({"cmd": "queues", "module": "ingest.l4_flow_log"},
                    {"cmd": "queues", "module": "ingest.flow_metrics"},
                    {"cmd": "breakers"},
                    {"cmd": "spill", "module": "ingest.l4_flow_log"},
                    {"cmd": "datasource"}):
            kw = {k: v for k, v in req.items() if k != "cmd"}
            rt = tdebug.debug_request(req["cmd"], port=t.debug.port, **kw)
            rj = jdebug.debug_request(req["cmd"], port=j.debug.port, **kw)
            assert rt["ok"] and rt == rj, req
        spill = tdebug.debug_request("spill", port=t.debug.port,
                                     module="ingest.l4_flow_log")
        spill = spill["data"]["queues"]
        q = tdebug.debug_request("queues", port=t.debug.port,
                                 module="ingest.l4_flow_log")["data"]
        assert sum(c["spilled_records"] for c in spill.values()) == \
            q["ingest.l4_flow_log"]["spilled"] > 0
        br = tdebug.debug_request("breakers", port=t.debug.port)["data"]
        assert br["flaky"]["failures"] > 0
    finally:
        t.close()
        j.close()
