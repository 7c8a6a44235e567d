"""The port's OpenSSL and Go-TLS uprobe suite (`deepflow_tpu_torch/agent/
uprobe_trace.py`) against the JAX package's, on the CPU.

Every program of `UprobeSuite` (the OpenSSL pair and the Go-TLS enter
and exits, whose register- and stack-ABI branches ride each program) is
assembled in both packages against maps with fixed fds, on maps of its
own and on a `SocketTraceSuite`'s shared maps: equal map shapes and
instruction bytes. The ELF readers, Go version detection, the ABI and
goid tables and the attach plans are equal on a compiled stand-in
libssl, on synthetic Go binaries (both ABIs, an undecodable body) and
on this interpreter's own image. The JAX package's `test_uprobe_trace.py`
and its live-attach tests (`test_attach_live.py`,
`test_attach_live_goid.py`) then run against the port under their own
marks (bpf(2), the uprobe PMU, a C toolchain).
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import pytest

import torch_ctl_pair as cp
import torch_ebpf_pair as ep
from test_uprobe_trace import _synthetic_go_elf
from torch_plugin_pair import agent_on_cpu  # noqa: F401

JM, TM = ep.both()
_cc = shutil.which("gcc") or shutil.which("cc")


def _suite_log(m, monkeypatch, shared):
    with ep.recording(m, monkeypatch) as log:
        st = m.socket_trace.SocketTraceSuite() if shared else None
        suite = m.uprobe_trace.UprobeSuite(
            shared=st.maps if shared else None)
        names = {k: p.insns for k, p in suite.programs().items()}
        suite.close()
    return log, names


@pytest.mark.parametrize("shared", [False, True])
def test_suite_programs_equal(monkeypatch, shared):
    jlog, jnames = _suite_log(JM, monkeypatch, shared)
    tlog, tnames = _suite_log(TM, monkeypatch, shared)
    assert tlog == jlog and tnames == jnames
    assert sorted(tnames) == ["go_enter", "go_exit_read", "go_exit_write",
                              "ssl_enter", "ssl_exit_read",
                              "ssl_exit_write"]


def test_builders_equal(monkeypatch):
    out = []
    for m in (JM, TM):
        up = m.uprobe_trace
        with ep.recording(m, monkeypatch) as log:
            maps = up.create_uprobe_maps()
            progs = [up.build_ssl_enter(maps).assemble(),
                     up.build_go_tls_enter(maps).assemble()]
            for d in (0, 1):
                progs.append(up.build_ssl_exit(maps, d).assemble())
                progs.append(up.build_go_tls_exit(maps, d).assemble())
            maps.set_proc_info(4242, True, 8, 16, 16, 152)
            maps.set_proc_info(4343, False, 8, 16, 16, 152, fsbase_off=3000)
        out.append((log, progs))
    assert out[1] == out[0]


VERSIONS = (None, "", "go1", "go1.5.0", "go1.8.7", "go1.9.0", "go1.16.9",
            "go1.16rc1", "go1.17", "go1.17rc2", "go1.20.4", "go1.22.0",
            "go1.23rc1", "go1.23.1", "go1.24beta2", "go1.24.0", "go2.0",
            "devel +abc123", "go1.x", "gox")


def test_version_tables_equal():
    for v in VERSIONS:
        for fn in ("_go_release", "go_register_abi", "go_goid_offset"):
            assert getattr(TM.uprobe_trace, fn)(v) == \
                getattr(JM.uprobe_trace, fn)(v), (fn, v)
    for n in ("SSL_SYMBOLS", "GO_TLS_SYMBOLS"):
        assert getattr(TM.uprobe_trace, n) == getattr(JM.uprobe_trace, n)


def _plan(m, path):
    up = m.uprobe_trace
    ssl = [dataclasses.asdict(s) for s in up.plan_ssl(path)]
    go = up.plan_go(path)
    funcs = up.elf_func_table(path)
    offs = {s: up.vaddr_to_offset(path, a)
            for s, (a, _) in sorted(funcs.items())[:200]}
    return (up.elf_sections(path), funcs, offs, up.go_version(path), ssl,
            None if go is None else dataclasses.asdict(go))


def _images(tmp_path):
    out = [os.path.realpath(sys.executable)]
    for i, (version, code) in enumerate((
            (b"go1.20.4", None), (b"go1.16.9", None),
            (b"go1.23.1", bytes.fromhex("4883ec08c3904883c408c3")),
            (b"go1.21.0", bytes.fromhex("67488b04c3c3c3c3")))):
        d = tmp_path / f"go{i}"
        d.mkdir()
        out.append(_synthetic_go_elf(d, version=version,
                                     func_code=code)[0])
    if _cc is not None:
        src = tmp_path / "fakessl.c"
        src.write_text(
            "int SSL_read(void*s, void*b, int n){ return n > 0 ? n : -1; }\n"
            "int SSL_write(void*s, const void*b, int n){ return n; }\n")
        so = tmp_path / "libssl.so.3"
        subprocess.run([_cc, "-O2", "-shared", "-fPIC", str(src), "-o",
                        str(so)], check=True)
        out.append(str(so))
    return out


def test_elf_readers_and_plans_equal(tmp_path):
    images = _images(tmp_path)
    for path in images:
        assert _plan(TM, path) == _plan(JM, path), path
    plans = [TM.uprobe_trace.plan_go(p) for p in images[1:5]]
    assert [p.reg_abi for p in plans] == [True, False, True, True]
    assert plans[3].undecodable and not plans[0].undecodable
    if _cc is not None:
        assert len(TM.uprobe_trace.plan_ssl(images[-1])) == 4
    for pid in (os.getpid(), 1, 2 ** 22 + 7):
        assert TM.uprobe_trace.find_libssl(pid) == \
            JM.uprobe_trace.find_libssl(pid)
    assert TM.uprobe_trace.attach_available() == \
        JM.uprobe_trace.attach_available()


# -- the JAX package's uprobe tests, live ones included, on the port --------
@pytest.fixture(autouse=True)
def _ref_on_cpu(agent_on_cpu):  # noqa: F811
    """The live test that ships rows through an Agent builds the port's
    on the CPU."""


cp.adopt_reference_tests(globals(), cp.TESTS / "test_uprobe_trace.py")
cp.adopt_reference_tests(globals(), cp.TESTS / "test_attach_live.py")
cp.adopt_reference_tests(globals(), cp.TESTS / "test_attach_live_goid.py")
