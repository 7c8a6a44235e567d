"""The port's Go HTTP/2 header suite (`deepflow_tpu_torch/agent/
http2_trace.py`) against the JAX package's, on the CPU.

Every program of `Http2Suite`, both Go ABIs (the register flavor and
the `_stack` one), is assembled in both packages against maps with
fixed fds, on maps of its own and on a `SocketTraceSuite`'s: equal map
shapes and instruction bytes. The event image (`pack_event`,
`parse_event`), `synthesize_block` and `Http2Assembler` (groups per
pid, fd, stream and side; the group and header caps; expiry) agree on
seeded events, and `plan_go_http2` gives equal plans on synthetic Go
binaries across versions and symbol spellings. The JAX package's
`test_http2_trace.py` and `test_attach_live_h2_stack.py` then run
against the port under their own marks.
"""

import dataclasses

import numpy as np
import pytest

import torch_ctl_pair as cp
import torch_ebpf_pair as ep
from test_uprobe_trace import _synthetic_go_elf

JM, TM = ep.both()


def _suite_log(m, monkeypatch, shared):
    with ep.recording(m, monkeypatch) as log:
        st = m.socket_trace.SocketTraceSuite() if shared else None
        suite = m.http2_trace.Http2Suite(shared=st.maps if shared else None)
        names = {k: p.insns for k, p in suite.programs().items()}
        suite.close()
    return log, names


@pytest.mark.parametrize("shared", [False, True])
def test_suite_programs_equal(monkeypatch, shared):
    jlog, jnames = _suite_log(JM, monkeypatch, shared)
    tlog, tnames = _suite_log(TM, monkeypatch, shared)
    assert tlog == jlog and tnames == jnames
    roles = ("header_write", "header_read", "end_write", "end_read",
             "process_headers")
    assert sorted(tnames) == sorted(r + s for r in roles
                                    for s in ("", "_stack"))


def test_builders_equal(monkeypatch):
    out = []
    for m in (JM, TM):
        h2 = m.http2_trace
        with ep.recording(m, monkeypatch) as log:
            maps = h2.create_http2_maps()
            progs = []
            for reg in (True, False):
                for d in (0, 1):
                    progs.append(h2.build_header_event(maps, d,
                                                       reg).assemble())
                    progs.append(h2.build_headers_end(maps, d,
                                                      reg).assemble())
                progs.append(h2.build_process_headers(maps, reg).assemble())
            maps.set_info(77, True, 8, 16, 16, 40)
            maps.set_info(78, False, 0, 8, 16, 48)
        out.append((log, progs))
    assert out[1] == out[0]


def _events(rng, n=400):
    """Seeded (pid, fd, stream, direction, flags, name, value) events
    over a few connections, names and values past the caps among them."""
    out = []
    for i in range(n):
        flags = int(rng.choice([0, 0, 0, 1, 2, 3]))
        name = bytes(rng.integers(97, 123, int(rng.integers(0, 70)),
                                  dtype=np.uint8))
        if rng.integers(0, 3) == 0:
            name = [b":method", b":path", b":authority", b":status"][i % 4]
        value = bytes(rng.integers(32, 127, int(rng.integers(0, 150)),
                                   dtype=np.uint8))
        out.append((int(rng.integers(1, 4)), int(rng.integers(3, 6)),
                    1 + 2 * int(rng.integers(0, 4)),
                    int(rng.integers(0, 2)), flags, name, value))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_event_image_and_assembler_equal(seed):
    events = _events(np.random.default_rng((19, 60, seed)))
    out = []
    for m in (JM, TM):
        h2, st = m.http2_trace, m.socket_trace
        asm = h2.Http2Assembler(max_groups=6, max_headers=5,
                                timeout_ns=50_000)
        got = []
        for i, (pid, fd, stream, d, flags, name, value) in \
                enumerate(events):
            ev = h2.pack_event(stream, flags, name, value)
            raw = st.pack_record(pid, pid + 1, d, 1000 * i, ev, fd=fd,
                                 source=st.SOURCE_GO_HTTP2_UPROBE)
            got.append((ev, h2.parse_event(ev),
                        asm.feed(st.parse_record(raw))))
            if i % 97 == 96:
                got.append(asm.expire(1000 * i))
        got.append(h2.parse_event(b"short"))
        got.append(asm.counters())
        out.append(got)
    assert out[1] == out[0]
    assert out[1][-1]["blocks_out"] > 0 and out[1][-1]["dropped"] > 0


@pytest.mark.parametrize("side", [0, 1])
def test_synthesize_block_equal(side):
    rng = np.random.default_rng((19, 61, side))
    for _ in range(50):
        headers = [(n, bytes(rng.integers(32, 127, 8, dtype=np.uint8)))
                   for n in rng.choice(
                       [b":method", b":path", b":authority", b":status",
                        b"host", b"x-a", b"content-type"],
                       int(rng.integers(0, 7))).tolist()]
        assert TM.http2_trace.synthesize_block(headers, side) == \
            JM.http2_trace.synthesize_block(headers, side)


@pytest.mark.parametrize("version", [b"go1.15.2", b"go1.16.9", b"go1.17",
                                     b"go1.21.3", b"go1.23.1"])
def test_plan_equal(tmp_path, version):
    syms = tuple(s.encode() for s in sorted(JM.http2_trace.HTTP2_SYMBOLS))
    plans = []
    for sel in (syms[:2], syms[2:]):
        d = tmp_path / str(len(plans))
        d.mkdir()
        path, _, _ = _synthetic_go_elf(d, version=version, symbols=sel)
        j = [dataclasses.asdict(s) for s in JM.http2_trace.plan_go_http2(
            path)]
        t = [dataclasses.asdict(s) for s in TM.http2_trace.plan_go_http2(
            path)]
        assert t == j
        plans.append(t)
    assert TM.http2_trace.HTTP2_SYMBOLS == JM.http2_trace.HTTP2_SYMBOLS
    if version == b"go1.15.2":
        assert plans == [[], []]
    else:
        assert all(plans)


# -- the JAX package's HTTP/2 tests, live ones included, on the port --------
cp.adopt_reference_tests(globals(), cp.TESTS / "test_http2_trace.py")
cp.adopt_reference_tests(globals(), cp.TESTS / "test_attach_live_h2_stack.py")
