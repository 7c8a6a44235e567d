"""The port's syscall kprobe suite, record image and perf rings
(`deepflow_tpu_torch/agent/{socket_trace,perf_ring}.py`) against the
JAX package's, on the CPU.

Every program of `SocketTraceSuite` is assembled in both packages
against maps with fixed fds (`torch_ebpf_pair.recording`: no bpf(2)):
the map shapes, the initial map cells and the instruction bytes are
equal, and so are the shared emitters over their options. The 192-byte
SOCK_DATA image: `pack_record` bytes are equal over seeded fields
(payloads past the cap, latencies past u32, every source), and
`parse_record` in each package reads either package's image into equal
records, with and without a resolver. `BpfOutputReader.drain` reads
equal records and loss counts from a seeded ring image (samples that
wrap the ring's end, coalesced loss records, foreign records). The JAX
package's `test_socket_trace.py` and `test_attach_live_cross_source.py`
then run against the port under their own marks.
"""

import dataclasses
import mmap
import struct

import numpy as np
import pytest

import torch_ctl_pair as cp
import torch_ebpf_pair as ep

JM, TM = ep.both()


def _suite_log(m, monkeypatch):
    with ep.recording(m, monkeypatch) as log:
        suite = m.socket_trace.SocketTraceSuite()
        names = {k: (v[0].insns, v[1].insns)
                 for k, v in suite.programs().items()}
        suite.close()
    return log, names


def test_suite_programs_equal(monkeypatch):
    jlog, jnames = _suite_log(JM, monkeypatch)
    tlog, tnames = _suite_log(TM, monkeypatch)
    assert tlog == jlog
    assert tnames == jnames
    assert sorted(tnames) == ["read", "recvmsg", "sendmsg", "write"]
    progs = [e for e in tlog if e[0] == "prog"]
    assert len(progs) == 4 and all(len(p[2]) % 8 == 0 for p in progs)


@pytest.mark.parametrize("direction", [0, 1])
@pytest.mark.parametrize("source", [0, 1, 2, 3])
def test_record_tail_emitter_equal(monkeypatch, direction, source):
    """emit_record_tail over its options, and build_enter/build_exit."""
    out = []
    for m in (JM, TM):
        st = m.socket_trace
        with ep.recording(m, monkeypatch) as log:
            maps = st.create_maps()
            progs = [st.build_enter(maps, is_msg).assemble()
                     for is_msg in (False, True)]
            progs.append(st.build_exit(maps, direction).assemble())
            for check in (False, True):
                for slot in (None, -200):
                    a = m.bpf.Asm()
                    a.mov_reg(m.bpf.R6, m.bpf.R1)
                    st.emit_record_tail(a, maps, direction, source=source,
                                        msghdr_check=check,
                                        latency_slot=slot)
                    a.exit_imm(0)
                    progs.append(a.assemble())
        out.append((log, progs))
    assert out[1] == out[0]


def _fields(rng, i):
    n = int(rng.integers(0, 300))
    return dict(pid=int(rng.integers(1, 1 << 22)),
                tid=int(rng.integers(1, 1 << 22)),
                direction=int(rng.integers(0, 2)),
                ts_ns=int(rng.integers(0, 1 << 62)),
                payload=bytes(rng.integers(0, 256, n, dtype=np.uint8)),
                fd=int(rng.integers(0, 1 << 32)),
                trace_id=int(rng.integers(0, 1 << 63)),
                cap_seq=int(rng.integers(0, 1 << 63)),
                comm="".join(chr(int(c)) for c in
                             rng.integers(32, 127, int(rng.integers(0, 20)))),
                source=i % 5,
                latency_ns=int(rng.integers(0, 1 << 34)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_record_image_equal(seed):
    rng = np.random.default_rng((19, 40, seed))
    for i in range(200):
        f = _fields(rng, i)
        raw = TM.socket_trace.pack_record(**f)
        assert raw == JM.socket_trace.pack_record(**f)
        assert len(raw) == TM.socket_trace.RECORD_SIZE == 192
        tup = tuple(int(x) for x in rng.integers(0, 1 << 16, 4))
        for resolver in (None, lambda p, fd: tup, lambda p, fd: None):
            t = TM.socket_trace.parse_record(raw, resolver=resolver)
            j = JM.socket_trace.parse_record(raw, resolver=resolver)
            assert type(t).__module__ == "deepflow_tpu_torch.agent." \
                "ebpf_source"
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.payload == f["payload"][:TM.socket_trace.PAYLOAD_CAP]
        assert t.latency_ns == min(f["latency_ns"], 0xFFFFFFFF)
        assert (t.source, t.kernel_trace_id, t.from_kernel) == \
            (f["source"], f["trace_id"], True)


def test_record_constants_equal():
    names = ("RECORD_SIZE", "PAYLOAD_CAP", "T_INGRESS", "T_EGRESS",
             "SOURCE_SYSCALL", "SOURCE_OPENSSL_UPROBE",
             "SOURCE_GO_TLS_UPROBE", "SOURCE_GO_HTTP2_UPROBE",
             "TLS_SOURCES", "SYSCALLS", "_RECORD_FMT")
    for n in names:
        assert getattr(TM.socket_trace, n) == getattr(JM.socket_trace, n), n
    assert TM.socket_trace.attach_available() == \
        JM.socket_trace.attach_available()


def _ring_image(rng, data_size):
    """A perf ring (control page + data) holding samples, loss records
    and a foreign record, the last ones wrapping the data area's end;
    returns (ring, tail, head, the sample bodies written)."""
    page = mmap.PAGESIZE
    ring = mmap.mmap(-1, page + data_size)
    tail = data_size - 100          # the writes wrap
    off, bodies = tail, []

    def put(rec):
        nonlocal off
        for i, b in enumerate(rec):
            ring[page + (off + i) % data_size] = b
        off += len(rec)
    for i in range(12):
        kind = int(rng.integers(0, 6))
        if kind == 0:
            put(struct.pack("<IHHQQ", 2, 0, 24, 7, int(rng.integers(1, 99))))
        elif kind == 1:
            put(struct.pack("<IHH", 3, 0, 16) + bytes(8))   # foreign
        else:
            body = bytes(rng.integers(0, 256, 192, dtype=np.uint8))
            size = (8 + 4 + len(body) + 7) & ~7
            put(struct.pack("<IHHI", 9, 0, size, len(body)) + body
                + bytes(size - 12 - len(body)))
            bodies.append(body)
    return ring, tail, off, bodies


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_output_reader_drain_equal(seed):
    out = []
    for m in (JM, TM):
        rng = np.random.default_rng((19, 50, seed))
        pr = m.perf_ring
        data_size = 4 * mmap.PAGESIZE
        ring, tail, head, bodies = _ring_image(rng, data_size)
        struct.pack_into("<Q", ring, pr._HEAD_OFF, head)
        struct.pack_into("<Q", ring, pr._TAIL_OFF, tail)
        reader = object.__new__(pr.BpfOutputReader)
        reader._rings, reader._fds = [ring], []
        reader.data_size, reader.lost = data_size, 0
        got = list(reader.drain())
        left = struct.unpack_from("<Q", ring, pr._TAIL_OFF)[0]
        assert got == bodies
        out.append((got, reader.lost, left))
        reader.close()
    assert out[1] == out[0]
    assert out[1][2] > data_size          # the tail wrapped


# -- the JAX package's socket_trace tests, the cross-source live one too ----
cp.adopt_reference_tests(globals(), cp.TESTS / "test_socket_trace.py")
cp.adopt_reference_tests(globals(),
                         cp.TESTS / "test_attach_live_cross_source.py")
