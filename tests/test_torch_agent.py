"""The port's agent flow path (`deepflow_tpu_torch/agent/`) against the
JAX package's, on the CPU.

The same frames (built with `deepflow_tpu.replay.frames` from a numpy
seed) go through both packages: `decode_packets` on every frame kind
the decoder handles, `TcpPerf` over multi-flow conversations split into
batches in several ways (and the randomized chain differential of
tests/test_tcp_perf.py), `FlowMap` with `device="cpu"` (every `c_*`
column, every `TcpPerf` array, the counters, `inject`'s packet context
and `tick_columns` over several batches and ticks, with FIN/RST closes,
timeouts and addresses at and above 128.0.0.0, so the u64 key words
wrap when the host path casts them to int64), `flows_to_documents`, and
the three serializers byte for byte. Every value is an integer, so every
comparison is exact, dtype for dtype. The flow table and `TcpPerf`'s
state are host numpy arrays in both packages (only the per-batch
reduction runs on the device), so they compare directly.

The last case runs the slice as a whole: the port's agent leg builds
TAGGEDFLOW and METRICS frames, which go into both packages' ingesters
(tests/torch_pair.py), and every store table is equal.
"""

import inspect

import numpy as np
import pytest
import torch

from deepflow_tpu.agent import flow_map as jfm
from deepflow_tpu.agent import packet as jpacket
from deepflow_tpu.agent import quadruple as jquad
from deepflow_tpu.agent import tcp_perf as jperf
from deepflow_tpu.agent import trident as jtrident
from deepflow_tpu.replay.frames import (ACK, FIN, PSH, RST, SYN, eth_ipv4_tcp,
                                        eth_ipv4_udp, eth_ipv6_tcp, erspan_i,
                                        erspan_ii, gre_teb, ip4, vxlan)
from deepflow_tpu_torch import agent as tagent
from deepflow_tpu_torch.agent import flow_map as tfm
from deepflow_tpu_torch.agent import packet as tpacket
from deepflow_tpu_torch.agent import quadruple as tquad
from deepflow_tpu_torch.agent import tcp_perf as tperf
from deepflow_tpu_torch.agent import trident as ttrident
from deepflow_tpu_torch.store import rollup as trollup

import torch_pair as tp

NS = 1_000_000_000
MS = 1_000_000
T0 = 1_700_000_000 * NS
CLI, SRV = ip4(10, 0, 0, 1), ip4(10, 0, 0, 2)


def _same(a: dict, b: dict, ctx=""):
    """Two column dicts: the same keys, dtypes, shapes and values."""
    assert sorted(a) == sorted(b), ctx
    for k in b:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (ctx, k, x.dtype,
                                                           y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{ctx} {k}")


def _same_map(t, j, ctx=""):
    """Every c_* column, every TcpPerf array, the slot map, the free list
    and the counters."""
    cols = sorted(k for k in vars(j) if k.startswith("c_"))
    assert cols == sorted(k for k in vars(t) if k.startswith("c_"))
    _same({k: getattr(t, k) for k in cols}, {k: getattr(j, k) for k in cols},
          ctx)
    assert tperf.TcpPerf._FIELDS == jperf.TcpPerf._FIELDS
    _same({k: getattr(t.perf, k) for k in jperf.TcpPerf._FIELDS},
          {k: getattr(j.perf, k) for k in jperf.TcpPerf._FIELDS}, ctx)
    assert t.perf.cap == j.perf.cap and t._cap == j._cap, ctx
    assert t._slot == j._slot and t._free == j._free, ctx
    assert t._next_flow_id == j._next_flow_id, ctx
    assert t.counters() == j.counters(), ctx


# -- decode_packets ------------------------------------------------------------
def _v6_ext(nh):
    import struct
    frame = eth_ipv6_tcp(bytes(range(16)), bytes(range(16, 32)), 443, 55000,
                         ACK, b"hello6", seq=7)
    tcp = frame[54:]
    ip6 = struct.pack(">IHBB", 0x60000000, len(tcp), nh, 64) \
        + bytes(range(16)) + bytes(range(16, 32))
    return b"\x02" * 6 + b"\x04" * 6 + b"\x86\xdd" + ip6 + tcp


def _routed_gre():
    import struct
    inner = eth_ipv4_tcp(CLI, SRV, 1234, 443, SYN, b"tls?", seq=9)
    bare = struct.pack(">HH", 0, 0x0800) + inner[14:]
    ip = struct.pack(">BBHHHBBHII", 0x45, 0, 20 + len(bare), 0, 0, 64, 47,
                     0, ip4(1, 1, 1, 1), ip4(2, 2, 2, 2))
    return b"\x02" * 6 + b"\x04" * 6 + b"\x08\x00" + ip + bare


def _mixed(rng, n=64):
    """Seeded frames of every kind, addresses on both sides of 2^31."""
    out = []
    for i in range(n):
        a = int(rng.integers(0, 1 << 32))
        b = int(rng.integers(0, 1 << 32))
        sp, dp = (int(x) for x in rng.integers(1, 1 << 16, 2))
        pl = bytes(int(rng.integers(0, 300)))
        fl = int(rng.integers(0, 64))
        inner = eth_ipv4_tcp(a, b, sp, dp, fl, pl, seq=int(rng.integers(
            0, 1 << 32)), ack=int(rng.integers(0, 1 << 32)),
            win=int(rng.integers(0, 1 << 16)), vlan=bool(i % 5 == 0))
        kind = i % 8
        if kind == 0:
            out.append(eth_ipv4_udp(a, b, sp, dp, pl))
        elif kind == 1:
            out.append(vxlan(b, a, inner))
        elif kind == 2:
            out.append(gre_teb(a, b, inner, key=i))
        elif kind == 3:
            out.append(erspan_ii(a, b, inner))
        elif kind == 4:
            out.append(eth_ipv6_tcp(rng.bytes(16), rng.bytes(16), sp, dp,
                                    fl, pl, seq=i))
        elif kind == 5:
            out.append(bytes(rng.integers(0, 256, int(rng.integers(
                0, 60))).astype(np.uint8)))
        else:
            out.append(inner)
    return out


_INNER = eth_ipv4_tcp(CLI, SRV, 1234, 443, SYN, b"tls?", seq=9)
DECODE_CASES = {
    "tcp_vlan_garbage": [eth_ipv4_tcp(CLI, SRV, 40000, 80, SYN, seq=100),
                         eth_ipv4_tcp(CLI, SRV, 40000, 80, ACK, b"hello",
                                      seq=101, vlan=True),
                         b"\x00" * 20],
    "udp": [eth_ipv4_udp(ip4(200, 1, 2, 3), ip4(10, 9, 8, 7), 53, 33333,
                         b"q" * 40)],
    "vxlan": [vxlan(ip4(1, 1, 1, 1), ip4(2, 2, 2, 2),
                    eth_ipv4_tcp(CLI, SRV, 1234, 443, SYN))],
    "ipv6": [eth_ipv6_tcp(bytes(range(16)), bytes(range(16, 32)), 443,
                          55000, ACK, b"hello6", seq=7)],
    "ipv6_hop_by_hop": [_v6_ext(0)],
    "ipv6_routing": [_v6_ext(43)],
    "gre_teb": [gre_teb(ip4(1, 1, 1, 1), ip4(2, 2, 2, 2), _INNER)],
    "gre_teb_key": [gre_teb(ip4(1, 1, 1, 1), ip4(2, 2, 2, 2), _INNER,
                            key=0xBEEF)],
    "erspan_i": [erspan_i(ip4(1, 1, 1, 1), ip4(2, 2, 2, 2), _INNER)],
    "erspan_ii": [erspan_ii(ip4(1, 1, 1, 1), ip4(2, 2, 2, 2), _INNER)],
    "routed_gre": [_routed_gre()],
    "gre_teb_arp": [gre_teb(ip4(9, 9, 9, 1), ip4(9, 9, 9, 2),
                            b"\x02" * 6 + b"\x04" * 6 + b"\x08\x06"
                            + b"\x00" * 28)],
    "empty": [],
    "mixed_seeded": _mixed(np.random.default_rng(5)),
}


@pytest.mark.parametrize("decap", [True, False], ids=["decap", "no_decap"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_packets_matches_jax(case, decap):
    frames = DECODE_CASES[case]
    ts = T0 + np.arange(len(frames), dtype=np.uint64) * np.uint64(MS)
    _same(tpacket.decode_packets(frames, ts, decap_vxlan=decap),
          jpacket.decode_packets(frames, ts, decap_vxlan=decap), case)
    # the default timestamps too
    _same(tpacket.decode_packets(frames), jpacket.decode_packets(frames),
          case)


def test_flag_constants_and_classify_match_jax():
    for name in ("SYN", "ACK", "FIN", "RST", "PSH", "PROTO_TCP", "PROTO_UDP",
                 "HDR_BYTES", "VXLAN_PORT"):
        assert getattr(tpacket, name) == getattr(jpacket, name), name
    flags = np.repeat(np.arange(256), 3)
    payload = np.tile(np.array([0, 1, 5]), 256)
    for a, b in zip(tperf.classify(flags, payload),
                    jperf.classify(flags, payload)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -- seeded conversations ------------------------------------------------------
def conversations(rng, n_flows, seconds=3, t0=T0):
    """(frames, timestamps) of `n_flows` seeded flows, sorted by time:
    full TCP sessions (SYN and SYN/ACK sometimes retransmitted, PSH/ACK
    request-response rounds, zero-window ACKs, retransmitted segments),
    mid-stream TCP captures and UDP exchanges; closed by FIN both ways,
    by RST or not at all (timeouts). Addresses lie on both sides of
    128.0.0.0."""
    servers = [ip4(10, 0, 0, 2), ip4(172, 16, 0, 5), ip4(192, 168, 1, 1),
               ip4(200, 0, 0, 9), ip4(255, 255, 0, 1)]
    pkts = []
    for f in range(n_flows):
        cli = int(rng.choice([0x0A000000 + int(rng.integers(0, 1 << 24)),
                              0xC8000000 + int(rng.integers(0, 1 << 24))]))
        srv = servers[int(rng.integers(0, len(servers)))]
        cp = int(rng.integers(1024, 1 << 16))
        sp = int(rng.choice([80, 443, 3306, 53]))
        t = t0 + int(rng.integers(0, seconds * NS))
        kind = rng.choice(["full", "full", "full", "mid", "udp"])

        def add(up, flags, payload=0, seq=0, ack=0, win=8192):
            nonlocal t
            t += int(rng.integers(1, 40)) * MS
            a, b, x, y = (cli, srv, cp, sp) if up else (srv, cli, sp, cp)
            pkts.append((t, eth_ipv4_tcp(a, b, x, y, flags, b"p" * payload,
                                         seq=seq & 0xFFFFFFFF,
                                         ack=ack & 0xFFFFFFFF, win=win)))

        if kind == "udp":
            for _ in range(int(rng.integers(1, 6))):
                t += int(rng.integers(1, 40)) * MS
                up = bool(rng.integers(0, 2))
                a, b, x, y = (cli, srv, cp, 53) if up else (srv, cli, 53, cp)
                pkts.append((t, eth_ipv4_udp(a, b, x, y,
                                             b"u" * int(rng.integers(8, 90)))))
            continue
        cs, ss = int(rng.integers(0, 1 << 32)), int(rng.integers(0, 1 << 32))
        if kind == "full":
            add(True, SYN, seq=cs)
            if rng.random() < 0.3:
                add(True, SYN, seq=cs)                       # SYN retrans
            add(False, SYN | ACK, seq=ss, ack=cs + 1)
            if rng.random() < 0.3:
                add(False, SYN | ACK, seq=ss, ack=cs + 1)    # SYN/ACK retrans
            cs, ss = cs + 1, ss + 1
            add(True, ACK, seq=cs, ack=ss)
        for _ in range(int(rng.integers(1, 6))):
            q = int(rng.integers(2, 300))
            add(True, PSH | ACK, q, seq=cs, ack=ss)
            if rng.random() < 0.2:
                add(True, PSH | ACK, q, seq=cs, ack=ss)      # retransmitted
            cs += q
            add(False, ACK, seq=ss, ack=cs,
                win=0 if rng.random() < 0.2 else 8192)
            r = int(rng.integers(1, 1400))
            add(False, PSH | ACK, r, seq=ss, ack=cs)
            ss += r
            add(True, ACK, seq=cs, ack=ss,
                win=0 if rng.random() < 0.1 else 8192)
        end = rng.choice(["fin", "fin", "rst", "open"])
        if end == "fin":
            add(True, FIN | ACK, seq=cs, ack=ss)
            add(False, FIN | ACK, seq=ss, ack=cs + 1)
            add(True, ACK, seq=cs + 1, ack=ss + 1)
        elif end == "rst":
            add(bool(rng.integers(0, 2)), RST, seq=cs)
    pkts.sort(key=lambda p: p[0])
    return [f for _, f in pkts], np.asarray([t for t, _ in pkts], np.uint64)


def batches(rng, n, how):
    """[lo, hi) batch bounds over n packets."""
    if how == "one":
        return [(0, n)]
    if how == "single":
        return [(i, i + 1) for i in range(n)]
    if how == "fixed":
        return [(i, min(n, i + 7)) for i in range(0, n, 7)]
    cuts = np.sort(rng.choice(np.arange(1, n), size=min(n - 1, n // 9),
                              replace=False))
    edges = [0] + cuts.tolist() + [n]
    return list(zip(edges[:-1], edges[1:]))


def drive_maps(frames, ts, bounds, capacity=16, context=True):
    """Both packages' FlowMaps over the same batches, ticking at each
    second boundary and once more 200 s later (the open flows time out).
    Every inject's context and every tick's columns are compared, and the
    maps' state after each. Returns [(tick columns)] of the port."""
    t = tfm.FlowMap(vtap_id=3, capacity=capacity, device="cpu")
    j = jfm.FlowMap(vtap_id=3, capacity=capacity)
    t.want_packet_context = j.want_packet_context = context
    ticks = [int(x) for x in range(T0 + NS, int(ts[-1]) + NS + 1, NS)] \
        if len(ts) else []
    ticks.append((ticks[-1] if ticks else T0) + 200 * NS)
    out = []

    def tick(now):
        tc, jc = t.tick_columns(now_ns=now), j.tick_columns(now_ns=now)
        _same(tc, jc, f"tick {now}")
        _same_map(t, j, f"after tick {now}")
        out.append(tc)

    k = 0
    for lo, hi in bounds:
        while k < len(ticks) - 1 and ts[lo] >= ticks[k]:
            tick(ticks[k])
            k += 1
        tp_ = tpacket.decode_packets(frames[lo:hi], ts[lo:hi])
        jp = jpacket.decode_packets(frames[lo:hi], ts[lo:hi])
        a, b = t.inject(tp_), j.inject(jp)
        assert (a is None) == (b is None)
        if b is not None:
            _same(a["cols"], b["cols"], "context cols")
            _same({k_: a[k_] for k_ in ("flow_id", "direction")},
                  {k_: b[k_] for k_ in ("flow_id", "direction")}, "context")
        _same_map(t, j, f"after batch {lo}:{hi}")
    for now in ticks[k:]:
        tick(now)
    assert len(t) == len(j) == 0
    return out


# -- TcpPerf -------------------------------------------------------------------
def _golden():
    """tests/test_tcp_perf.py's two-flow conversation plus a third flow
    with a retransmitted SYN, a zero window and an RST."""
    C2, S2 = ip4(192, 168, 7, 7), ip4(203, 0, 113, 5)
    seq = [
        (0, eth_ipv4_tcp(CLI, SRV, 1234, 80, SYN, seq=100)),
        (2, eth_ipv4_tcp(C2, S2, 2222, 443, SYN, seq=900)),
        (5, eth_ipv4_tcp(C2, S2, 2222, 443, SYN, seq=900)),
        (10, eth_ipv4_tcp(SRV, CLI, 80, 1234, SYN | ACK, seq=500, ack=101)),
        (20, eth_ipv4_tcp(CLI, SRV, 1234, 80, ACK, seq=101, ack=501)),
        (30, eth_ipv4_tcp(CLI, SRV, 1234, 80, PSH | ACK, b"q" * 50,
                          seq=101, ack=501)),
        (32, eth_ipv4_tcp(S2, C2, 443, 2222, SYN | ACK, seq=700, ack=901)),
        (40, eth_ipv4_tcp(SRV, CLI, 80, 1234, ACK, seq=501, ack=151)),
        (47, eth_ipv4_tcp(C2, S2, 2222, 443, ACK, seq=901, ack=701, win=0)),
        (55, eth_ipv4_tcp(SRV, CLI, 80, 1234, PSH | ACK, b"r" * 200,
                          seq=501, ack=151)),
        (60, eth_ipv4_tcp(C2, S2, 2222, 443, PSH | ACK, b"x" * 30, seq=901,
                          ack=701)),
        (70, eth_ipv4_tcp(CLI, SRV, 1234, 80, ACK, seq=151, ack=701)),
        (75, eth_ipv4_tcp(S2, C2, 443, 2222, ACK, seq=701, ack=931)),
        (100, eth_ipv4_tcp(CLI, SRV, 1234, 80, PSH | ACK, b"q" * 60,
                           seq=151, ack=701)),
        (120, eth_ipv4_tcp(S2, C2, 443, 2222, RST, seq=701)),
    ]
    return [f for _, f in seq], T0 + np.asarray([t for t, _ in seq],
                                                np.uint64) * np.uint64(MS)


@pytest.mark.parametrize("how", ["one", "single", "fixed", "random"])
def test_tcp_perf_conversation_matches_jax(how):
    frames, ts = _golden()
    ticks = drive_maps(frames, ts, batches(np.random.default_rng(3),
                                           len(frames), how))
    first = ticks[0]
    assert len(first["flow_id"]) == 2
    for name in ("rtt", "rtt_client", "rtt_server", "srt_count", "art_count",
                 "cit_count", "zero_win_tx", "retrans_syn", "syn_count",
                 "synack_count"):
        assert first[name].any(), name


@pytest.mark.parametrize("seed", [0xF00D, 1, 2, 3])
def test_tcp_perf_randomized_differential_matches_jax(seed):
    """tests/test_tcp_perf.py's randomized chain differential: random
    interleaved conversations over 6 flows in random batch splits, fed to
    both packages' TcpPerf: every array equal after each batch, and the
    window report and reset equal."""
    rng = np.random.default_rng(seed)
    kinds = [(0x10, 0), (0x10, 1), (0x18, 1)]
    n_flows, n_pkts = 6, 400
    seqs = [[1000, 5000] for _ in range(n_flows)]
    pkts = []
    t = T0
    for _ in range(n_pkts):
        f = int(rng.integers(0, n_flows))
        d = int(rng.integers(0, 2))
        flags, has_pl = kinds[int(rng.integers(0, 3))]
        pl = int(rng.integers(1, 200)) if has_pl else 0
        seq = seqs[f][d]
        seqs[f][d] = (seq + pl) & 0xFFFFFFFF
        t += int(rng.integers(1, 5)) * MS
        pkts.append((f, d, t, flags, seq, seqs[f][1 - d], pl))
    perfs = (tperf.TcpPerf(16), jperf.TcpPerf(16))
    i = 0
    while i < len(pkts):
        j = min(len(pkts), i + int(rng.integers(1, 40)))
        chunk = pkts[i:j]
        arr = lambda k: np.asarray([p[k] for p in chunk], np.int64)  # noqa
        for p in perfs:
            p.inject(arr(0), arr(1), arr(2), arr(3), arr(4), arr(5), arr(6),
                     np.full(len(chunk), 8192, np.int64),
                     np.zeros(len(chunk), np.int64),
                     np.zeros(len(chunk), np.int64))
        _same({k: getattr(perfs[0], k) for k in jperf.TcpPerf._FIELDS},
              {k: getattr(perfs[1], k) for k in jperf.TcpPerf._FIELDS},
              f"batch {i}:{j}")
        i = j
    assert perfs[1].srt[:, :, 1].any() and perfs[1].art[:, :, 1].any()
    idx = np.arange(n_flows)
    cli = rng.integers(0, 2, n_flows)
    _same(perfs[0].report(idx, cli), perfs[1].report(idx, cli), "report")
    for p in perfs:
        p.window_reset(idx[::2])
        p.grow(40)
        p.reset_slot(1)
    _same({k: getattr(perfs[0], k) for k in jperf.TcpPerf._FIELDS},
          {k: getattr(perfs[1], k) for k in jperf.TcpPerf._FIELDS}, "reset")


# -- FlowMap -------------------------------------------------------------------
@pytest.mark.parametrize("how", ["one", "fixed", "random"])
@pytest.mark.parametrize("seed", [11, 12])
def test_flow_map_matches_jax(seed, how):
    rng = np.random.default_rng(seed)
    frames, ts = conversations(rng, 80)
    ticks = drive_maps(frames, ts, batches(rng, len(frames), how))
    allc = {k: np.concatenate([c[k] for c in ticks]) for k in ticks[0]}
    # the run covers what it claims: every close type, addresses past
    # 2^31 on both sides, the perf engine's signals
    assert set(allc["close_type"].tolist()) == {
        tfm.CLOSE_FORCED_REPORT, tfm.CLOSE_FIN, tfm.CLOSE_RST,
        tfm.CLOSE_TIMEOUT}
    assert (allc["ip_src"] >= 1 << 31).any() and (allc["ip_dst"] >= 1 << 31
                                                  ).any()
    for name in ("rtt", "srt_count", "art_count", "cit_count", "zero_win_rx",
                 "retrans_syn", "retrans_synack", "rtt_client",
                 "rtt_server"):
        assert allc[name].any(), name
    # the retransmission estimate is batch-local: a segment that does not
    # move its direction's max seq past the previous batches'
    assert allc["retrans"].any() == (how != "one")
    assert (allc["proto"] == 17).any()


def test_flow_map_without_context_and_idle_batches_match_jax():
    """The default path (no packet context), a batch with no valid
    packet, and `emit_active=False` ticks."""
    rng = np.random.default_rng(21)
    frames, ts = conversations(rng, 30)
    t = tfm.FlowMap(capacity=4, device="cpu")
    j = jfm.FlowMap(capacity=4)
    garbage = [b"\x00" * 20, b"\x01" * 70]
    for m, dec in ((t, tpacket), (j, jpacket)):
        assert m.inject(dec.decode_packets(garbage)) is None
    for lo in range(0, len(frames), 50):
        out = [m.inject(dec.decode_packets(frames[lo:lo + 50],
                                           ts[lo:lo + 50]))
               for m, dec in ((t, tpacket), (j, jpacket))]
        assert out == [None, None]
        now = int(ts[min(lo + 49, len(ts) - 1)])
        _same(t.tick_columns(now, emit_active=False),
              j.tick_columns(now, emit_active=False))
        _same_map(t, j)
    _same(t.tick_columns(now_ns=int(ts[-1]) + 200 * NS),
          j.tick_columns(now_ns=int(ts[-1]) + 200 * NS))
    _same_map(t, j)


def test_flow_map_tick_rows_match_jax():
    """The row-view tick: FlowAcc fields and flows_to_columns."""
    rng = np.random.default_rng(31)
    frames, ts = conversations(rng, 40, seconds=1)
    t = tfm.FlowMap(vtap_id=7, device="cpu")
    j = jfm.FlowMap(vtap_id=7)
    half = len(frames) // 2
    for lo, hi, now in ((0, half, T0 + NS // 2), (half, len(frames),
                                                  T0 + 3 * NS),
                        (0, 0, T0 + 300 * NS)):
        if hi > lo:
            t.inject(tpacket.decode_packets(frames[lo:hi], ts[lo:hi]))
            j.inject(jpacket.decode_packets(frames[lo:hi], ts[lo:hi]))
        tr, jr = t.tick(now_ns=now), j.tick(now_ns=now)
        assert [vars(f) for f in tr] == [vars(f) for f in jr]
        assert [f.rtt_us for f in tr] == [f.rtt_us for f in jr]
        assert [f.close_type(now) for f in tr] == \
            [f.close_type(now) for f in jr]
        _same(tfm.flows_to_columns(tr, 7, now),
              jfm.flows_to_columns(jr, 7, now))
        _same_map(t, j)
    for name in ("CLOSE_FORCED_REPORT", "CLOSE_FIN", "CLOSE_RST",
                 "CLOSE_TIMEOUT", "FLOW_TIMEOUT_NS"):
        assert getattr(tfm, name) == getattr(jfm, name)


def test_flow_key_words_group_as_uint64_past_2_31():
    """The reduction FlowMap.inject runs: two u64 key words whose high
    bits are set (ip0 >= 2^31), int64-cast on the host path, back as
    uint64 in the same lexicographic group order with the same inverse."""
    rng = np.random.default_rng(41)
    n = 3000
    ips = rng.integers(0, 1 << 32, (40, 2), dtype=np.uint64)
    pick = rng.integers(0, 40, n)
    cols = {"k_ips": (ips[pick, 0] << np.uint64(32)) | ips[pick, 1],
            "k_rest": rng.integers(0, 4, n).astype(np.uint64)
            << np.uint64(60),
            "v": rng.integers(0, 1 << 40, n), "w": rng.integers(-9, 9, n)}
    assert (cols["k_ips"] >= np.uint64(1 << 63)).any()
    from deepflow_tpu.store import rollup as jrollup
    aggs = {"v": "sum", "w": "min"}
    tr, tinv = trollup.group_reduce(cols, ["k_ips", "k_rest"], aggs,
                                    return_inverse=True, device="cpu")
    jr, jinv = jrollup.group_reduce(cols, ["k_ips", "k_rest"], aggs,
                                    return_inverse=True)
    assert tr["k_ips"].dtype == np.uint64
    _same(tr, {k: np.asarray(v) for k, v in jr.items()})
    assert tinv.dtype == np.asarray(jinv).dtype
    np.testing.assert_array_equal(tinv, jinv)


def test_entry_points_default_to_cuda_without_fallback():
    """FlowMap and flows_to_documents take `device` as a keyword after
    the reference's arguments, "cuda" by default; without a card the
    default raises instead of falling back to the CPU."""
    for fn in (tfm.FlowMap, tquad.flows_to_documents):
        p = inspect.signature(fn).parameters["device"]
        assert p.default == "cuda" and p.kind is p.KEYWORD_ONLY
    assert tagent.FlowMap is tfm.FlowMap
    assert tagent.decode_packets is tpacket.decode_packets
    assert tfm.FlowMap(device="cpu").device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tfm.FlowMap()
        cols = {"ip_dst": np.ones(1, np.uint32)}
        with pytest.raises(RuntimeError, match="CUDA"):
            tquad.flows_to_documents(cols, 1)


# -- Documents and the serializers ---------------------------------------------
@pytest.fixture(scope="module")
def ticked():
    rng = np.random.default_rng(51)
    frames, ts = conversations(rng, 120)
    return drive_maps(frames, ts, batches(rng, len(frames), "random"),
                      context=False)


def test_documents_and_records_match_jax(ticked):
    for i, cols in enumerate(ticked):
        second = T0 // NS + i
        td = tquad.flows_to_documents(cols, second, device="cpu")
        jd = jquad.flows_to_documents(cols, second)
        _same(td, jd, f"documents {i}")
        assert tquad.documents_to_records(td) == \
            jquad.documents_to_records(jd)
        assert ttrident.columns_to_l4_records(cols) == \
            jtrident.columns_to_l4_records(cols)
        _same(ttrident.columns_to_l4_schema(cols),
              jtrident.columns_to_l4_schema(cols), f"l4 schema {i}")
    assert tquad.flows_to_documents({"ip_dst": np.zeros(0, np.uint32)}, 1,
                                    device="cpu") == {}
    assert tquad.documents_to_records({}) == []


def test_records_without_perf_columns_match_jax(ticked):
    """Tick columns without the perf engine's columns (flows_to_columns'
    shape): the Documents fall back to `retrans`, the records to rtt and
    retrans alone."""
    cols = ticked[0]
    base = {k: cols[k] for k in (
        "ip_src", "ip_dst", "port_src", "port_dst", "proto", "vtap_id",
        "byte_tx", "byte_rx", "packet_tx", "packet_rx", "retrans", "rtt",
        "close_type", "flow_id", "start_time", "duration", "tap_side",
        "l3_epc_id", "is_new_flow")}
    td = tquad.flows_to_documents(base, 5, device="cpu")
    _same(td, jquad.flows_to_documents(base, 5))
    assert tquad.documents_to_records(td) == jquad.documents_to_records(td)
    assert ttrident.columns_to_l4_records(base) == \
        jtrident.columns_to_l4_records(base)


# -- the slice as a whole ------------------------------------------------------
def agent_frames(ticked):
    """The port's agent leg on the wire: each tick's TaggedFlow records
    and its Documents (stamped an hour boundary ahead of the wall clock,
    so no rollup minute builds before they land) as sequenced frames,
    with the record counts."""
    import time

    from deepflow_tpu_torch.wire import (FlowHeader, MessageType,
                                         encode_frame, pack_pb_records)
    doc_t0 = (int(time.time()) // 3600 + 2) * 3600
    frames, l4, docs = [], 0, 0
    for i, cols in enumerate(ticked):
        recs = ttrident.columns_to_l4_records(cols)
        drecs = tquad.documents_to_records(
            tquad.flows_to_documents(cols, doc_t0 + i, device="cpu"))
        for mt, r in ((MessageType.TAGGEDFLOW, recs),
                      (MessageType.METRICS, drecs)):
            if r:
                frames.append((mt, encode_frame(mt, pack_pb_records(r),
                                                FlowHeader(sequence=i + 1,
                                                           vtap_id=3)),
                               len(r)))
        l4 += len(recs)
        docs += len(drecs)
    return frames, l4, docs, doc_t0


def test_agent_leg_into_both_ingesters_matches_jax(tmp_path, ticked):
    """The port's agent leg builds TAGGEDFLOW and METRICS frames; both
    packages' ingesters take them over loopback TCP, one frame landed
    before the next; every store table equal after close, and the
    records conserved."""
    from deepflow_tpu_torch.wire import MessageType
    frames, n_l4, n_docs, doc_t0 = agent_frames(ticked)
    assert n_l4 > 100 and n_docs > 10
    res = {}
    for package in ("jax", "port"):
        root = str(tmp_path / package)
        ing = tp.build(package, root, tpu_sketch_window_s=3600)
        ing.start()
        stages, l4, docs = [], 0, 0
        for mt, f, n in frames:
            if mt == MessageType.TAGGEDFLOW:
                l4 += n
                stages.append(([f], lambda i, k=l4: tp.decoder(
                    i, "l4_flow_log").records == k
                    and i.tpu_sketch.rows_in == k))
            else:
                docs += n
                stages.append(([f], lambda i, k=docs:
                               i.flow_metrics.records == k))
        try:
            tp.drive(ing, stages)
            ing.tpu_sketch.flush_window(now=T0 / NS + 10.0)
            ing.flush()
            ing.flow_metrics.rollups.advance(doc_t0 + 600)
            counts = (tp.decoder(ing, "l4_flow_log").records,
                      ing.tpu_sketch.rows_in, ing.flow_metrics.records)
        finally:
            ing.close()
        assert counts == (n_l4, n_l4, n_docs), package
        res[package] = tp.tables(root)
    t, j = res["port"], res["jax"]
    # the exporter's close() writes one more window at the wall clock
    for r in (t, j):
        for key, cols in r.items():
            if key[0] == "tpu_sketch" and cols:
                keep = cols["timestamp"] < T0 // NS + 1000
                r[key] = {k: v[keep] for k, v in cols.items()}
    assert len(j[("flow_log", "l4_flow_log")]["ip_src"]) == n_l4
    tp.assert_tables_equal(t, j, loose={("tpu_sketch", "window_signals")})
