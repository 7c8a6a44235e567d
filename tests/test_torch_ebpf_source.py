"""The port's syscall-record tracer (`deepflow_tpu_torch/agent/
ebpf_source.py`) against the JAX package's, on the CPU.

A seeded stream of syscall records (`torch_ebpf_pair.record_stream`:
two-hop calls whose ingress parks a trace id that the egress consumes,
client-only exchanges with their zero marker, continued ingress
segments, goroutine ids, TLS uprobe sources and Go HTTP/2 header events
through the assembler) goes through both packages' `EbpfTracer`, as
`SyscallRecord`s (`feed`, the replay path) and as SOCK_DATA images with
in-kernel trace ids and a /proc-style resolver (`feed_raw`, the live
path). Both emit the same wire records byte for byte, the same counters,
the same observed processes, and stamp the same controller gpids once a
map is pushed mid-stream. The IO gate emits equal `io_events` for slow
file IO on fds this test holds open, over the collect modes and
minimum durations. The JAX package's `test_ebpf_source.py` and
`test_io_event.py` then run against the port
(`torch_ctl_pair.adopt_reference_tests`).
"""

import os

import numpy as np
import pytest

import torch_ctl_pair as cp
import torch_ebpf_pair as ep
from torch_plugin_pair import agent_on_cpu  # noqa: F401

JM, TM = ep.both()


def _feed_all(m, records, gpids, raw=None, resolver=None):
    """The stream through one package's tracer: (wires, counters,
    processes). `gpids` is pushed into the tracer half way."""
    es = m.ebpf_source
    tr = es.EbpfTracer(vtap_id=7)
    wires = []
    for i, r in enumerate(records):
        if i == len(records) // 2:
            tr.gpid_map = dict(gpids)
        if raw is None:
            w = tr.feed(es.SyscallRecord(**r))
        else:
            w = tr.feed_raw(raw[i], resolver=resolver)
        if w is not None:
            wires.append(w)
    return wires, tr.counters(), tr.seen_processes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_feed_wires_equal(seed):
    records, _ = ep.record_stream(np.random.default_rng((19, seed)))
    pids = sorted({r["pid"] for r in records})
    gpids = {p: 500 + i for i, p in enumerate(pids)}
    j = _feed_all(JM, records, gpids)
    t = _feed_all(TM, records, gpids)
    assert t == j
    wires, counters, procs = t
    # the stream exercises what it claims: merged sessions, trace ids
    # parked and consumed, zero markers, h2 groups, gpids after the push
    assert len(wires) > len(records) // 4
    assert counters["next_trace_id"] > 0
    assert counters["http2"]["blocks_out"] > 0
    assert sorted(p["pid"] for p in procs) == pids
    from deepflow_tpu_torch.decode.columnar import decode_l7_records
    cols = decode_l7_records(wires)
    assert (cols["syscall_trace_id_request"] != 0).any()
    assert (cols["syscall_trace_id_request"] == 0).any()
    assert (cols["is_tls"] != 0).any() and (cols["is_tls"] == 0).any()
    assert (cols["gprocess_id_0"] != 0).any()
    assert (cols["syscall_coroutine_0"] != 0).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_feed_raw_wires_equal(seed):
    rng = np.random.default_rng((19, 10 + seed))
    records, sockets = ep.record_stream(rng)
    ids = ep.kernel_trace_ids(rng, len(records))
    gpids = {r["pid"]: 900 + r["pid"] for r in records}

    def resolver(pid, fd):
        return sockets.get((pid, fd))
    out = []
    for m in (JM, TM):
        raw = ep.kernel_images(m, records, ids)
        out.append((raw, _feed_all(m, records, gpids, raw, resolver)))
    (jraw, j), (traw, t) = out
    assert traw == jraw
    assert t == j
    assert len(t[0]) > len(records) // 4


def test_kernel_feed_raw_without_resolver_equal():
    """No resolver (zero tuples): both tracers give the same wires and
    counters, and the IO gate stays unarmed in both."""
    rng = np.random.default_rng((19, 20))
    records, _ = ep.record_stream(rng, n_conv=48)
    ids = ep.kernel_trace_ids(rng, len(records))
    j = _feed_all(JM, records, {}, ep.kernel_images(JM, records, ids))
    t = _feed_all(TM, records, {}, ep.kernel_images(TM, records, ids))
    assert t == j and t[1]["io_events_pending"] == 0


# -- the IO gate ------------------------------------------------------------
@pytest.fixture
def held_files(tmp_path):
    """Four regular files held open by this process: (pid, [fds])."""
    files = []
    for i in range(4):
        p = tmp_path / f"f{i}.log"
        p.write_bytes(b"x" * 64)
        files.append(open(p, "rb"))
    try:
        yield os.getpid(), [f.fileno() for f in files]
    finally:
        for f in files:
            f.close()


@pytest.mark.parametrize("mode,min_ns", [(0, 1_000_000), (1, 1_000_000),
                                         (2, 1_000_000), (1, 0),
                                         (2, 5_000_000)])
def test_io_gate_events_equal(held_files, mode, min_ns):
    pid, fds = held_files
    rng = np.random.default_rng((19, 30, mode))
    rows = []
    for i in range(200):
        fd = fds[i % len(fds)] if i % 5 else 999_999   # some closed fds
        rows.append(dict(
            pid=pid, tid=pid + 1 + i % 3,
            direction=int(rng.integers(0, 2)),
            ts_ns=ep.T0 + i * ep.MS,
            payload=b"line %d\n" % i * int(rng.integers(1, 30)), fd=fd,
            trace_id=int(rng.integers(0, 3)) * (i + 1),
            latency_ns=int(rng.integers(0, 10 * ep.MS)),
            comm="logger"))
    out = []
    for m in (JM, TM):
        tr = m.ebpf_source.EbpfTracer(
            vtap_id=3, io_event_collect_mode=mode,
            io_event_minimal_duration_ns=min_ns)
        wires = [tr.feed_raw(m.socket_trace.pack_record(**r),
                             resolver=lambda p, f: None) for r in rows]
        out.append((wires, tr.io_events, tr.counters()))
    assert out[1] == out[0]
    if mode:
        assert out[1][1], "the gate emitted no events"


def test_io_gate_cap_equal(held_files):
    pid, fds = held_files
    out = []
    for m in (JM, TM):
        tr = m.ebpf_source.EbpfTracer(io_event_collect_mode=2)
        tr._IO_EVENTS_CAP = 8
        for i in range(20):
            tr.feed_raw(m.socket_trace.pack_record(
                pid, pid, 1, ep.T0 + i, b"w" * 10, fd=fds[0],
                latency_ns=2 * ep.MS), resolver=lambda p, f: None)
        out.append((tr.io_events, tr.counters()))
    assert out[1] == out[0] and out[1][1]["io_events_dropped"] == 12


# -- the JAX package's tracer tests, on the port ----------------------------
@pytest.fixture(autouse=True)
def _ref_on_cpu(agent_on_cpu):  # noqa: F811
    """The reference test that builds an Agent builds the port's on the
    CPU."""


cp.adopt_reference_tests(globals(), cp.TESTS / "test_ebpf_source.py")
cp.adopt_reference_tests(globals(), cp.TESTS / "test_io_event.py")
