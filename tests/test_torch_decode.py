"""The port's host-side ingest stages against the JAX package's, on the
CPU: the protobuf decoders (decode/columnar.py), KnowledgeGraph and geo
stamping (enrich/), the tag dictionaries (store/dict_store.py), the
circuit breaker, the reservoir throttlers and the exporter registry.
Every input is drawn from a numpy seed; integer columns and counters
compare exactly, dtypes included."""

import numpy as np
import pytest

from deepflow_tpu.decode import columnar as jdec
from deepflow_tpu.enrich import geo as jgeo
from deepflow_tpu.enrich import platform_data as jpd
from deepflow_tpu.replay.generator import SyntheticAgent
from deepflow_tpu.runtime import breaker as jbr
from deepflow_tpu.runtime import exporters as jexp
from deepflow_tpu.runtime import faults as jfaults
from deepflow_tpu.runtime import throttler as jthr
from deepflow_tpu.store import dict_store as jds
from deepflow_tpu.wire.gen import flow_log_pb2, metric_pb2
from deepflow_tpu_torch.decode import columnar as tdec
from deepflow_tpu_torch.enrich import geo as tgeo
from deepflow_tpu_torch.enrich import platform_data as tpd
from deepflow_tpu_torch.runtime import breaker as tbr
from deepflow_tpu_torch.runtime import exporters as texp
from deepflow_tpu_torch.runtime import faults as tfaults
from deepflow_tpu_torch.runtime import throttler as tthr
from deepflow_tpu_torch.store import dict_store as tds


@pytest.fixture(autouse=True)
def _disarm():
    yield
    jfaults.default_faults().disarm()
    tfaults.default_faults().disarm()


def assert_cols_equal(t, j):
    assert list(t) == list(j)
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def _mangle(rng, records):
    """Truncated, corrupt and empty records among good ones."""
    out = list(records)
    for i in rng.choice(len(out), 6, replace=False):
        r = out[i]
        out[i] = r[:int(rng.integers(1, max(2, len(r))))]
    out += [rng.integers(0, 256, 40, dtype=np.uint8).tobytes(),
            b"\xff\xff\xff", b""]
    return out


def l4_records(rng, n):
    agent = SyntheticAgent(seed=int(rng.integers(1 << 30)))
    cols, recs = agent.l4_batch(n)
    # IPv6 and perf/tunnel/acl fields the synthetic agent leaves unset
    extra = []
    for i in range(8):
        m = flow_log_pb2.TaggedFlow()
        f = m.flow
        f.flow_key.ip6_src = rng.integers(0, 256, 16,
                                          dtype=np.uint8).tobytes()
        f.flow_key.ip6_dst = rng.integers(0, 256, 16,
                                          dtype=np.uint8).tobytes()
        f.flow_key.port_dst = 443
        f.flow_key.proto = 6
        f.flow_key.tap_port = int(rng.integers(0, 1 << 40))
        f.start_time = 1_700_000_000_000_000_000 + i
        f.close_type = i % 5
        f.perf_stats.tcp.syn_count = i
        f.perf_stats.l7.err_client_count = 2 * i
        f.tunnel.tx_mac0, f.tunnel.tx_mac1 = 7, 9
        f.acl_gids.extend([5 + i, 1])
        f.metrics_peer_src.l3_epc_id = -2
        extra.append(m.SerializeToString())
    return recs + extra


def l7_records(rng, n):
    """AppProtoLogsData records with strings, eBPF identities, IPv6 and
    the int32 length fields' signs."""
    out = []
    for i in range(n):
        m = flow_log_pb2.AppProtoLogsData()
        b = m.base
        b.start_time = 1_700_000_000_000_000_000 + i * 1000
        b.end_time = b.start_time + 5000
        b.ip_src = int(rng.integers(0, 1 << 32))
        if i % 17 == 0:
            b.ip6_dst = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
            b.is_ipv6 = 1
        else:
            b.ip_dst = int(0xAC100000 + rng.integers(0, 64))
        b.port_dst = int(rng.choice([80, 443, 8080]))
        b.protocol = 6
        b.head.proto = 20
        b.head.rrt = int(rng.integers(0, 10_000_000))
        b.l3_epc_id_src = int(rng.integers(-3, 50))
        b.l3_epc_id_dst = int(rng.integers(-3, 50))
        b.tap_port = int(rng.integers(0, 1 << 40))
        b.pod_id_0 = int(rng.integers(0, 3))
        if i % 3 == 0:
            b.syscall_trace_id_request = int(rng.integers(1, 1 << 60))
        m.req_len = int(rng.integers(-5, 5000))
        m.resp_len = int(rng.integers(-5, 5000))
        m.req.endpoint = f"/api/v{i % 7}"
        m.req.domain = "svc.local" if i % 2 else ""
        m.resp.status = int(rng.integers(0, 5))
        m.resp.code = int(rng.integers(-1, 600))
        m.trace_info.trace_id = f"t{i % 11}"
        m.ext_info.service_name = f"s{i % 5}"
        m.ext_info.attribute_names.extend(["a", "b"][:i % 3])
        m.ext_info.metrics_values.extend([1.5, 2.0][:i % 3])
        m.flags = i & 1
        out.append(m.SerializeToString())
    return out


def metric_records(rng, n):
    agent = SyntheticAgent(seed=int(rng.integers(1 << 30)))
    out = [agent.metric_record(
        1_700_000_000 + i, i, {"packet_tx": int(rng.integers(1, 1 << 20)),
                               "byte_rx": int(rng.integers(0, 1 << 32))})
        for i in range(n)]
    d = metric_pb2.Document()
    d.timestamp = 1_700_000_005
    d.tag.field.ip = bytes(range(16))
    d.tag.field.l3_epc_id = -2
    d.tag.field.app_service = "svc"
    d.tag.field.endpoint = "/x"
    d.meter.app.traffic.request = 3
    d.meter.flow.latency.rtt_sum = 1 << 33
    out.append(d.SerializeToString())
    return out


def test_decode_l4_matches_jax():
    rng = np.random.default_rng(21)
    recs = _mangle(rng, l4_records(rng, 300))
    t, j = tdec.decode_l4_records(recs), jdec.decode_l4_records(recs)
    assert_cols_equal(t, j)
    assert 290 <= len(t["ip_src"]) < len(recs)
    assert t["is_ipv6"].sum() == 8


@pytest.mark.parametrize("with_dict", [False, True])
def test_decode_l7_matches_jax(with_dict, tmp_path):
    rng = np.random.default_rng(22)
    recs = _mangle(rng, l7_records(rng, 200))
    td = tds.TagDict(str(tmp_path / "t.jsonl")) if with_dict else None
    jd = jds.TagDict(str(tmp_path / "j.jsonl")) if with_dict else None
    t = tdec.decode_l7_records(recs, endpoint_dict=td)
    j = jdec.decode_l7_records(recs, endpoint_dict=jd)
    assert_cols_equal(t, j)
    assert len(t["ip_src"]) >= 190
    if with_dict:
        assert td.values() == jd.values() and len(td) > 10
        td.close()
        jd.close()
        assert (tmp_path / "t.jsonl").read_bytes() == \
            (tmp_path / "j.jsonl").read_bytes()


def test_decode_metrics_matches_jax():
    rng = np.random.default_rng(23)
    recs = _mangle(rng, metric_records(rng, 150))
    t, j = tdec.decode_metric_records(recs), jdec.decode_metric_records(recs)
    assert_cols_equal(t, j)
    assert len(t["timestamp"]) >= 140
    assert set(tdec.hash_cache_counters()) == set(jdec.hash_cache_counters())


def test_dict_store_matches_jax(tmp_path):
    rng = np.random.default_rng(24)
    words = [f"w{int(x)}" for x in rng.integers(0, 500, 400)]
    regs = (tds.TagDictRegistry(str(tmp_path / "t")),
            jds.TagDictRegistry(str(tmp_path / "j")))
    codes = [r.get("x").encode(words) for r in regs]
    np.testing.assert_array_equal(*codes)
    assert codes[0].dtype == np.uint32
    for r in regs:
        r.close()
    again = tds.TagDictRegistry(str(tmp_path / "j")).get("x")
    assert again.decode_many(codes[1]) == words
    v6 = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    assert tds.fold_ipv6(v6) == jds.fold_ipv6(v6) >= 0xF0000000
    assert tds.fnv1a32(b"abc") == jds.fnv1a32(b"abc")


def _platform(mod, geo_mod, dicts):
    rng = np.random.default_rng(25)
    ifs = [mod.InterfaceInfo(epc_id=int(e), ip=int(0xAC100000 + i),
                             region_id=1 + i % 3, pod_id=i % 4,
                             pod_node_id=i % 5, l3_device_id=i % 7)
           for i, e in zip(range(40), rng.integers(-2, 5, 40))]
    cidrs = [mod.CidrInfo(epc_id=1, prefix=0x0A000000, mask_len=8,
                          region_id=9, subnet_id=4),
             mod.CidrInfo(epc_id=1, prefix=0x0A010000, mask_len=16, az_id=3)]
    svcs = [mod.ServiceEntry(epc_id=1, ip=0xAC100003, port=80, protocol=6,
                             service_id=11),
            mod.ServiceEntry(epc_id=2, ip=0, port=443, protocol=6,
                             service_id=12)]
    p = mod.PlatformDataManager()
    p.update(ifs, cidrs, svcs, version=1)
    p.geo = geo_mod.load_geo_table(None, dicts)
    return p


def test_stamp_l4_l7_match_jax(tmp_path):
    rng = np.random.default_rng(26)
    tdicts = tds.TagDictRegistry(str(tmp_path / "t"))
    jdicts = jds.TagDictRegistry(str(tmp_path / "j"))
    tp, jp = _platform(tpd, tgeo, tdicts), _platform(jpd, jgeo, jdicts)
    l4 = jdec.decode_l4_records(l4_records(rng, 200))
    n = len(l4["ip_src"])
    # hit interfaces, CIDRs and the geo sample ranges
    l4["ip_dst"][:40] = 0xAC100000 + np.arange(40, dtype=np.uint32)
    l4["ip_src"][:20] = 0x0A010000 + np.arange(20, dtype=np.uint32)
    l4["ip_src"][20:30] = 0xC0000200 + np.arange(10, dtype=np.uint32)
    l4["l3_epc_id"][:60] = 1
    l4["l3_epc_id_1"][: n // 2] = 2
    got = tp.stamp_l4(dict(l4))
    assert_cols_equal(got, jp.stamp_l4(dict(l4)))
    assert got["province_0"][20:30].all()
    l7 = jdec.decode_l7_records(l7_records(rng, 150))
    l7["ip_dst"][:30] = 0xAC100000 + np.arange(30, dtype=np.uint32)
    l7["l3_epc_id_0"][:50] = 1
    assert_cols_equal(tp.stamp_l7(dict(l7)), jp.stamp_l7(dict(l7)))
    assert tp.info.counters() == jp.info.counters()
    assert tdicts.get("province").values() == jdicts.get("province").values()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_breaker_state_sequence_matches_jax():
    """A scripted outcome list under one fake clock: every allow()
    verdict, state and counter equal, step by step."""
    rng = np.random.default_rng(27)
    script = [("ok", 0.001)] * 3 + [("fail", 0)] * 4 \
        + [(rng.choice(["ok", "fail", "slow"]), float(rng.random()))
           for _ in range(200)]
    clocks, brs = [], []
    for mod in (tbr, jbr):
        c = _Clock()
        clocks.append(c)
        brs.append(mod.CircuitBreaker(
            "x", mod.BreakerConfig(min_calls=3, window=8, open_s=1.0,
                                   latency_budget_s=0.5), clock=c))
    states = set()
    for step, (kind, dt) in enumerate(script):
        got = []
        for c, b in zip(clocks, brs):
            c.t += dt
            ok = b.allow()
            if ok:
                if kind == "fail":
                    b.record_failure()
                else:
                    b.record_success(0.9 if kind == "slow" else 0.01)
            got.append((ok, b.state, b.counters()))
        assert got[0] == got[1], step
        states.add(got[0][1])
    assert states == {"closed", "open", "half_open"}
    assert brs[0].counters()["trips"] > 2 and brs[0].counters()["closes"]


@pytest.mark.parametrize("cap", [50, 4000])
def test_columnar_throttler_matches_jax(cap):
    """Same seed, one fake clock: the emitted rows and counters equal,
    across bucket rolls, ticks and flushes."""
    rng = np.random.default_rng(28)
    chunks = [{"a": rng.integers(0, 1 << 32, int(n), dtype=np.uint32),
               "b": rng.integers(0, 1 << 62, int(n), dtype=np.uint64)}
              for n in rng.integers(1, 400, 40)]
    outs, ths, clocks = ([], []), [], []
    for i, mod in enumerate((tthr, jthr)):
        c = _Clock()
        c.t = 1000.0
        clocks.append(c)
        ths.append(mod.ColumnarThrottler(outs[i].append, cap // 8 or 1,
                                         bucket_s=8, seed=5, clock=c))
    for k, ch in enumerate(chunks):
        for c, th in zip(clocks, ths):
            c.t += 0.7
            th.offer(ch)
            if k % 13 == 12:
                th.tick(c.t + 8)
        assert ths[0].counters() == ths[1].counters()
    for th in ths:
        th.flush()
    assert len(outs[0]) == len(outs[1]) > 2
    for a, b in zip(*outs):
        assert_cols_equal(a, b)
    c = ths[0].counters()
    assert c["in"] == sum(len(x["a"]) for x in chunks) == \
        c["emitted"] + c["sampled_out"]


def test_throttling_queue_matches_jax():
    rng = np.random.default_rng(29)
    outs, qs, clocks = ([], []), [], []
    for i, mod in enumerate((tthr, jthr)):
        c = _Clock()
        clocks.append(c)
        qs.append(mod.ThrottlingQueue(outs[i].append, throttle_per_s=3,
                                      bucket_s=2, seed=9, clock=c))
    for v in rng.integers(0, 1000, 300).tolist():
        kept = []
        for c, q in zip(clocks, qs):
            c.t += 0.05
            kept.append(q.send(v))
        assert kept[0] == kept[1]
    for q in qs:
        q.tick(1e6)
    assert outs[0] == outs[1] and qs[0].counters() == qs[1].counters()


class _Exp:
    def __init__(self, name, streams=("l4_flow_log",), raises=False,
                 filter_raises=False):
        self.name = name
        self.streams = streams
        self.raises = raises
        self.filter_raises = filter_raises
        self.got = 0

    def start(self):
        pass

    def close(self):
        pass

    def is_export_data(self, stream, cols):
        if self.filter_raises:
            raise ValueError("bad filter")
        return stream in self.streams

    def put(self, stream, idx, cols):
        if self.raises:
            raise RuntimeError("down")
        self.got += 1


def _registry(mod, bmod):
    reg = mod.Exporters(breaker_cfg=bmod.BreakerConfig(
        min_calls=2, open_s=3600.0))
    exps = [_Exp("ok"), _Exp("l7", streams=("l7_flow_log",)),
            _Exp("raising", raises=True),
            _Exp("filter_bug", filter_raises=True)]
    for e in exps:
        reg.register(e)
    reg.start()
    return reg, exps


def test_registry_counters_match_jax():
    """A filtering exporter, a raising one (its breaker opens, then its
    puts are shed) and a raising filter: registry and breaker counters
    equal; with `exporter.raise` armed the healthy exporter sheds too."""
    regs = [_registry(texp, tbr), _registry(jexp, jbr)]
    streams = ["l4_flow_log", "l7_flow_log", "flow_metrics"] * 5
    for s in streams:
        for reg, _ in regs:
            reg.put(s, 0, {"x": np.zeros(3)})
    (tr, te), (jr, je) = regs
    assert tr.counters() == jr.counters()
    assert tr.breakers() == jr.breakers()
    assert tr.breakers()["raising"]["state"] == "open"
    assert tr.counters()["shed"] > 0 and tr.counters()["put_errors"] > 0
    assert [e.got for e in te] == [e.got for e in je]
    for mod in (tfaults, jfaults):
        mod.default_faults().arm("exporter.raise", count=6, match="ok")
    for _ in range(8):
        for reg, _ in regs:
            reg.put("l4_flow_log", 0, {"x": np.zeros(3)})
    assert tr.counters() == jr.counters()
    assert tr.breakers() == jr.breakers()
    assert tr.breakers()["ok"]["state"] == "open"
    for reg, _ in regs:
        reg.close()
    with pytest.raises(RuntimeError):
        tr.start() or tr.register(_Exp("late"))


def test_registry_pending_counts_queue_and_feed():
    class Q:
        queue = [1, 2, 3]
        name = "q"

        def pending_extra(self):
            return 4

    class Bad(Q):
        name = "bad"

        def pending_extra(self):
            raise RuntimeError("gone")

    reg = texp.Exporters(breaker_cfg=None)
    reg.register(Q())
    reg.register(Bad())
    assert reg.pending() == 10 and reg.breakers() == {}
