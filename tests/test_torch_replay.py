"""The port's replay generator (deepflow_tpu_torch/replay/) against the JAX
package's, on the CPU: every frame builder over seeded arguments gives
the same bytes; `SyntheticAgent` gives the same columns (values and
dtypes), records and frames and leaves its RNG in the same state; the
DDoS ramp and the bursty-diurnal profile give the same windows, phases,
golden signals, Documents and frames."""

from dataclasses import astuple

import numpy as np
import pytest

from deepflow_tpu import replay as jreplay
from deepflow_tpu.replay import frames as jframes
from deepflow_tpu.replay import generator as jgen
from deepflow_tpu.wire import MessageType as JMessageType
from deepflow_tpu_torch import replay as treplay
from deepflow_tpu_torch.replay import frames as tframes
from deepflow_tpu_torch.replay import generator as tgen
from deepflow_tpu_torch.wire import MessageType as TMessageType


def assert_cols_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_exports_and_constants_equal():
    assert treplay.__all__ == jreplay.__all__
    for name in ("SYN", "ACK", "FIN", "RST", "PSH"):
        assert getattr(tframes, name) == getattr(jframes, name)
    assert [astuple(p) for p in tgen.DDOS_RAMP_PHASES] == \
        [astuple(p) for p in jgen.DDOS_RAMP_PHASES]
    assert [astuple(p) for p in tgen.DIURNAL_PHASES] == \
        [astuple(p) for p in jgen.DIURNAL_PHASES]


def _frame_args(rng):
    ip = lambda: int(rng.integers(0, 1 << 32))      # noqa: E731
    port = lambda: int(rng.integers(0, 1 << 16))    # noqa: E731
    payload = rng.integers(0, 256, int(rng.integers(0, 64)),
                           dtype=np.uint8).tobytes()
    return ip, port, payload


@pytest.mark.parametrize("seed", range(8))
def test_frame_builders_bytes_equal(seed):
    rng = np.random.default_rng((0xF4, seed))
    ip, port, payload = _frame_args(rng)
    quad = [int(x) for x in rng.integers(0, 256, 4)]
    assert tframes.ip4(*quad) == jframes.ip4(*quad)
    src, dst, sp, dp = ip(), ip(), port(), port()
    flags = int(rng.integers(0, 256))
    seq, ack = ip(), ip()
    win = port()
    for vlan in (False, True):
        kw = dict(flags=flags, payload=payload, seq=seq, ack=ack, win=win,
                  vlan=vlan)
        assert tframes.eth_ipv4_tcp(src, dst, sp, dp, **kw) == \
            jframes.eth_ipv4_tcp(src, dst, sp, dp, **kw)
    assert tframes.eth_ipv4_tcp(src, dst, sp, dp) == \
        jframes.eth_ipv4_tcp(src, dst, sp, dp)
    assert tframes.eth_ipv4_udp(src, dst, sp, dp, payload) == \
        jframes.eth_ipv4_udp(src, dst, sp, dp, payload)
    s16, d16 = rng.bytes(16), rng.bytes(16)
    assert tframes.eth_ipv6_tcp(s16, d16, sp, dp, flags, payload, seq) == \
        jframes.eth_ipv6_tcp(s16, d16, sp, dp, flags, payload, seq)
    inner = jframes.eth_ipv4_tcp(src, dst, sp, dp, payload=payload)
    vni, key, span = int(rng.integers(0, 1 << 24)), ip(), port()
    o_src, o_dst = ip(), ip()
    assert tframes.vxlan(o_src, o_dst, inner, vni) == \
        jframes.vxlan(o_src, o_dst, inner, vni)
    for k in (None, key):
        assert tframes.gre_teb(o_src, o_dst, inner, k) == \
            jframes.gre_teb(o_src, o_dst, inner, k)
    assert tframes.erspan_i(o_src, o_dst, inner) == \
        jframes.erspan_i(o_src, o_dst, inner)
    assert tframes.erspan_ii(o_src, o_dst, inner, span) == \
        jframes.erspan_ii(o_src, o_dst, inner, span)


@pytest.mark.parametrize("seed", [0xA9E27, 7, 0xDD05])
def test_synthetic_agent_equal(seed):
    ta, ja = tgen.SyntheticAgent(seed=seed), jgen.SyntheticAgent(seed=seed)
    for attr in ("client_ips", "server_ips", "server_ports"):
        np.testing.assert_array_equal(getattr(ta, attr), getattr(ja, attr))
        assert getattr(ta, attr).dtype == getattr(ja, attr).dtype
    assert_cols_equal(ta.l4_columns(1000), ja.l4_columns(1000))
    assert_cols_equal(ta.l4_columns_pooled(3000, pool=257),
                      ja.l4_columns_pooled(3000, pool=257))
    tc, tr = ta.l4_batch(700)
    jc, jr = ja.l4_batch(700)
    assert_cols_equal(tc, jc)
    assert tr == jr
    # rows without perf stats and without the wide-schema columns
    narrow = {k: v.copy() for k, v in tc.items()
              if k not in ("mac_src", "syn_seq", "vlan", "rtt_client")}
    narrow["rtt"][:50] = 0
    narrow["retrans"][:50] = 0
    assert [tgen.SyntheticAgent.l4_record(narrow, i) for i in range(100)] \
        == [jgen.SyntheticAgent.l4_record(narrow, i) for i in range(100)]
    traffic = {"packet_tx": 12, "byte_rx": 1 << 40, "new_flow": 3}
    for svc in (0, 5, 200):
        assert ta.metric_record(1_700_000_123, svc, traffic) == \
            ja.metric_record(1_700_000_123, svc, traffic)
    for per_frame in (64, 7):
        assert list(ta.frames(tr, TMessageType.TAGGEDFLOW, per_frame)) == \
            list(ja.frames(jr, JMessageType.TAGGEDFLOW, per_frame))
    assert list(ta.frames(tr[:5], TMessageType.METRICS)) == \
        list(ja.frames(jr[:5], JMessageType.METRICS))
    assert ta._seq == ja._seq
    assert ta.rng.bit_generator.state == ja.rng.bit_generator.state


def _profile_equal(t, j):
    assert (t.n_windows, t.onset_window, t.rows_per_window) == \
        (j.n_windows, j.onset_window, j.rows_per_window)
    assert (t.victim_ip, t.victim_port) == (j.victim_ip, j.victim_port)
    assert_cols_equal(t._pool, j._pool)
    for w in range(t.n_windows + 2):
        tp, ti = t.phase_of(w)
        jp, ji = j.phase_of(w)
        assert (astuple(tp), ti) == (astuple(jp), ji)
    tw, jw = list(t.windows()), list(j.windows())
    assert len(tw) == len(jw) == t.n_windows
    for (w, tn, tc), (w2, jn, jc) in zip(tw, jw):
        assert (w, tn) == (w2, jn)
        assert_cols_equal(tc, jc)
        assert tgen.DDoSRamp.golden_traffic(tc) == \
            jgen.DDoSRamp.golden_traffic(jc)
        assert t.metric_documents(w) == j.metric_documents(w)
    assert t.metric_documents(3, ts=42) == j.metric_documents(3, ts=42)


@pytest.mark.parametrize("seed", [0xDD05, 11])
def test_ddos_ramp_equal(seed):
    t = tgen.ddos_ramp(seed=seed, rows_per_window=256)
    j = jgen.ddos_ramp(seed=seed, rows_per_window=256)
    _profile_equal(t, j)
    assert t.onset_window == 12 and t.n_windows == 28
    phases = (tgen.RampPhase("quiet", 2, 0.0),
              tgen.RampPhase("ramp", 4, 0.5, rate_mult=1.5))
    _profile_equal(tgen.ddos_ramp(seed=seed, phases=phases,
                                  rows_per_window=100),
                   jgen.ddos_ramp(seed=seed, phases=tuple(
                       jgen.RampPhase(*astuple(p)) for p in phases),
                       rows_per_window=100))


def test_bursty_diurnal_equal():
    t = tgen.bursty_diurnal(rows_per_window=64)
    j = jgen.bursty_diurnal(rows_per_window=64)
    _profile_equal(t, j)
    for w in range(t.n_windows):
        assert t.l4_frames(w) == j.l4_frames(w)
    assert t.l4_frames(15, per_frame=5) == j.l4_frames(15, per_frame=5)
