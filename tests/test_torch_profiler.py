"""The port's OnCPU profiler (`deepflow_tpu_torch/agent/profiler.py`) and
the port's `Agent` profile loop against the JAX package's, on the CPU.

Both packages' ELF readers on a compiled C binary (no PIE), on a PIE
shared library and on the interpreter; both `Symbolizer`s over a
running child's mappings, at seeded addresses; `folded_to_profile_records`
on seeded folded stacks, serialized bytes equal. The agents' profile
loop (`_profile_loop`) runs one cycle in each package with the sampler
replaced by one that returns the same folded stacks (a live target, the
agent itself as pid 0, and a pid that does not exist): the PROFILE
stream each ships and the counters must be equal. One live sample (the
JAX package's hot-function test, run against the port) resolves the
busy function; the JAX package's other live sampling tests stay with
the JAX suite.
"""

import os
import subprocess
import threading
import time

import numpy as np
import pytest

import chip_smoke
import torch_ctl_pair as cp
from torch_plugin_pair import agent_on_cpu  # noqa: F401

from deepflow_tpu.agent import profiler as jprof
from deepflow_tpu.agent import trident as jtrident
from deepflow_tpu_torch.agent import profiler as tprof
from deepflow_tpu_torch.agent import trident as ttrident
from deepflow_tpu_torch.wire import MessageType

_PIE_LIB = r"""
int lib_a(int x) { return x * 3; }
int lib_b(int x) { return lib_a(x) + 1; }
static int lib_static(int x) { return x - 1; }
int lib_c(int x) { return lib_static(x); }
"""


@pytest.fixture(scope="module")
def binaries(tmp_path_factory):
    d = tmp_path_factory.mktemp("elf")
    (d / "burner.c").write_text(_REF_MOD._BURNER_C)
    (d / "lib.c").write_text(_PIE_LIB)
    try:
        subprocess.run(["gcc", "-O1", "-fno-omit-frame-pointer", "-no-pie",
                        "-o", str(d / "burner"), str(d / "burner.c")],
                       check=True, capture_output=True)
        subprocess.run(["gcc", "-O1", "-shared", "-fPIC", "-o",
                        str(d / "lib.so"), str(d / "lib.c")],
                       check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        pytest.skip("no working C toolchain")
    return d


def test_elf_function_symbols_equal(binaries):
    paths = [binaries / "burner", binaries / "lib.so",
             os.path.realpath("/proc/self/exe"), binaries / "burner.c",
             binaries / "missing"]
    for p in paths:
        assert tprof.elf_function_symbols(str(p)) == \
            jprof.elf_function_symbols(str(p)), p
    addrs, names, is_pie = tprof.elf_function_symbols(
        str(binaries / "burner"))
    assert "burn_cycles" in names and not is_pie
    _, lib_names, lib_pie = tprof.elf_function_symbols(
        str(binaries / "lib.so"))
    assert lib_pie and {"lib_a", "lib_b", "lib_c"} <= set(lib_names)


def test_symbolizers_equal(binaries):
    """Both symbolizers over one running child's mappings, at addresses
    inside and around every executable mapping."""
    p = subprocess.Popen([str(binaries / "burner")], stderr=subprocess.PIPE)
    try:
        p.stderr.readline()
        js, ts = jprof.Symbolizer(p.pid), tprof.Symbolizer(p.pid)
        rng = np.random.default_rng(0x9F)
        addrs, names, _ = tprof.elf_function_symbols(
            str(binaries / "burner"))
        ips = [0x10, 2 ** 63, addrs[names.index("burn_cycles")] + 4]
        for m in ts._modules:
            ips += [m.start, m.end - 1, m.end] + rng.integers(
                m.start, m.end, 40).tolist()
        got = [ts.resolve(int(ip)) for ip in ips]
        assert got == [js.resolve(int(ip)) for ip in ips]
        assert "burn_cycles" in got and "[unknown]" in got
    finally:
        p.kill()
        p.wait()


def _folded(rng, n=30):
    names = ["main", "burn_cycles", "[unknown]", "libc.so.6+0x1a2b", "f;g"]
    return {";".join(names[i] for i in rng.integers(0, len(names),
                                                    int(rng.integers(1, 6)))):
            int(rng.integers(1, 1000)) for _ in range(n)}


def test_folded_to_profile_records_equal():
    rng = np.random.default_rng(0x9E)
    for k in range(4):
        folded = _folded(rng)
        kw = dict(app_service=f"svc-{k}", pid=int(rng.integers(1, 2**22)),
                  vtap_id=k, ts_ns=int(rng.integers(0, 2**62)))
        assert tprof.folded_to_profile_records(folded, **kw) == \
            jprof.folded_to_profile_records(folded, **kw)
    assert tprof.folded_to_profile_records({}, "s", 1, ts_ns=5) == []


def _profile_cycle(trident, prof, folded):
    """One _profile_loop cycle of an Agent of `trident` whose sampler
    returns `folded`; its senders into a loopback sink."""
    sink = chip_smoke.LoopbackSink()
    gone = 2 ** 22 + 12345          # above pid_max: no such process
    agent = trident.Agent(trident.AgentConfig(
        ingester_addr=f"127.0.0.1:{sink.port}", self_telemetry=False,
        host="prof-node", profile_pids=(os.getpid(), 0, gone),
        profile_interval_s=0.01, profile_duration_s=0.0))
    agent.set_vtap_id(7)

    class Sampler:
        def __init__(self, pid, freq_hz=99):
            self.pid = pid

        def run(self, duration_s, symbolizer=None):
            agent._stop.set()          # this cycle is the last
            return dict(folded)

        def close(self):
            pass
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(prof, "OnCpuProfiler", Sampler)
            mp.setattr(time, "time", lambda: 1_700_000_000.25)
            th = threading.Thread(target=agent._profile_loop)
            th.start()
            th.join(timeout=60)
        assert not th.is_alive()
        c = agent.counters()
        streams = sink.drain(agent.senders)
        return streams.get(int(MessageType.PROFILE), b""), \
            (c["profiles_sent"], c["profile_errors"])
    finally:
        agent.close()
        sink.close()


def test_agent_profile_loop_equal(agent_on_cpu):  # noqa: F811
    folded = _folded(np.random.default_rng(0x9D))
    j = _profile_cycle(jtrident, jprof, folded)
    t = _profile_cycle(ttrident, tprof, folded)
    assert t == j
    assert j[1] == (2 * len(folded), 1) and len(j[0]) > 0


# -- the JAX package's profiler tests, on the port: the ELF reader, the
# symbolizer and one live sample (the others sample again: JAX suite) -----
_REF_MOD = cp.adopt_reference_tests(
    globals(), cp.TESTS / "test_profiler.py",
    only=("test_elf_function_symbols", "test_symbolizer_resolves_burner",
          "test_oncpu_sampler_hot_function_dominates"))
