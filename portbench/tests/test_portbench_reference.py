"""The plain references against brute force at a tiny size, and against
the port on the CPU."""

import math

import numpy as np
import pytest

from reference import app_red, hashing as H, l4_sketch
from traffic.generator import make_bank


def _l4_sizes(**kw):
    suite = dict(cms_depth=4, cms_log2_width=8, ring_size=64, top_k=10,
                 hll_groups=16, hll_precision=6, entropy_log2_buckets=5,
                 seed=0xDEC0DE)
    suite.update(kw)
    return l4_sketch.Sizes(suite)


def _u32(x):
    return int(x) & 0xFFFFFFFF


def _mix(x):
    x = _u32(x)
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    return x ^ (x >> 16)


def _fold(vals):
    h = 0x9E3779B9
    for c in vals:
        h = _mix(h ^ ((_u32(c) + 0x9E3779B9 + ((h << 6) & 0xFFFFFFFF)
                       + (h >> 2)) & 0xFFFFFFFF))
    return h


def _bucket(key, mult, salt, lw):
    return ((_mix(_u32(key) ^ int(salt)) * int(mult)) & 0xFFFFFFFF) \
        >> (32 - lw)


def test_l4_window_state_is_brute_force(small_mix):
    rec = make_bank("zipf_steady", 4, small_mix("zipf_steady", 1 << 12)) \
        .records(0, 3000)
    sz = _l4_sizes()
    got = l4_sketch.window_state(rec, sz)
    cms = np.zeros((4, 256), np.int64)
    ent = np.zeros((4, 32), np.int64)
    hll = np.zeros((16, 64), np.int64)
    for i in range(3000):
        t = [rec[k][i] for k in ("ip_src", "ip_dst", "port_src",
                                 "port_dst", "proto")]
        key = _fold(t)
        for d in range(4):
            cms[d, _bucket(key, *sz.cms_seeds[d], 8)] += 1
        w = min(int(rec["packet_tx"][i]) + int(rec["packet_rx"][i]), 0xFFFF)
        for f, name in enumerate(l4_sketch.ENTROPY_FEATURES):
            ent[f, _bucket(rec[name][i], *sz.ent_seeds[f], 5)] += w
        g = _fold([rec["ip_dst"][i], rec["port_dst"][i], rec["proto"][i]]) % 16
        h = _mix(rec["ip_src"][i])
        rest = (h << 6) & 0xFFFFFFFF
        clz = 32 - rest.bit_length()
        hll[g, h >> 26] = max(hll[g, h >> 26], min(clz, 26) + 1)
    np.testing.assert_array_equal(got["cms"], cms)
    np.testing.assert_array_equal(got["ent"], ent)
    np.testing.assert_array_equal(got["hll"], hll)


def test_l4_reference_equals_the_port_on_cpu(small_mix):
    torch = pytest.importorskip("torch")
    from deepflow_tpu_torch.models import flow_suite
    rec = make_bank("syn_flood", 5, small_mix("syn_flood", 1 << 14)) \
        .records(0, 1 << 14)
    suite = dict(cms_depth=4, cms_log2_width=17, ring_size=2048, top_k=100,
                 hll_groups=1024, hll_precision=10, entropy_log2_buckets=12,
                 seed=0xDEC0DE)
    cfg = flow_suite.FlowSuiteConfig(**suite)
    st = flow_suite.init(cfg, "cpu")
    cols = {k: torch.from_numpy(v.astype(np.int64)) for k, v in rec.items()}
    st = flow_suite.update(st, cols, torch.ones(1 << 14, dtype=torch.bool),
                           cfg)
    ref = l4_sketch.window_state(rec, l4_sketch.Sizes(suite))
    np.testing.assert_array_equal(st.sketch.counts.numpy(), ref["cms"])
    np.testing.assert_array_equal(st.ent.hist.numpy(), ref["ent"])
    np.testing.assert_array_equal(st.services.registers.numpy(), ref["hll"])
    _, out = flow_suite.flush(st, cfg)
    np.testing.assert_allclose(out.entropies.numpy(),
                               l4_sketch.entropies(ref["ent"]), atol=1e-5)
    np.testing.assert_allclose(out.service_cardinality.numpy(),
                               l4_sketch.hll_estimates(ref["hll"], 10),
                               rtol=1e-4, atol=1e-4)


def test_ertl_estimator_counts_distincts():
    p = 10
    m = 1 << p
    for n in (0, 10, 1000, 100_000):
        keys = np.arange(n, dtype=np.uint32) * np.uint32(2654435761)
        h = H.mix32(keys)
        reg = np.zeros(m, np.int64)
        if n:
            rho = np.minimum(H.clz32(h << np.uint32(p)), 32 - p) + 1
            np.maximum.at(reg, (h >> np.uint32(32 - p)).astype(np.int64), rho)
        est = l4_sketch.hll_estimates(reg[None, :], p)[0]
        assert est == pytest.approx(n, rel=0.1, abs=0.5)


def _red_sizes():
    return app_red.Sizes({"groups": 64, "dd_buckets": 512, "dd_alpha": 0.02,
                          "quantiles": [0.5, 0.95, 0.99]})


class _Bank:
    def __init__(self, cols):
        self.columns = cols
        self.n_records = len(cols["rrt_us"])
        self.unique = []


def test_red_counts_are_brute_force(small_mix):
    bank = make_bank("red_services", 6, small_mix("red_services", 1 << 13))
    sz = _red_sizes()
    got = app_red.window_counts(app_red.Derived(bank, sz).take(100, 5100), sz)
    rec = bank.records(100, 5100)
    g = math.log((1.02) / (0.98))
    req = np.zeros(64, np.int64)
    err = np.zeros(64, np.int64)
    hist = np.zeros((64, 512), np.int64)
    for i in range(5000):
        grp = _fold([rec["ip_dst"][i], rec["port_dst"][i],
                     rec["protocol"][i]]) % 64
        req[grp] += 1
        s = int(rec["status"][i])
        err[grp] += s >= 400 or 0 < s < 100
        v = float(np.float32(rec["rrt_us"][i]))
        b = max(0, math.ceil(math.log(v) / g - 1e-12))
        hist[grp, min(b, 511)] += 1
    np.testing.assert_array_equal(got["requests"], req)
    np.testing.assert_array_equal(got["errors"], err)
    # the float64 log may land one bucket off next to a boundary
    assert (got["hist"] != hist).sum() <= 4
    assert got["hist"].sum() == hist.sum()


def test_red_quantile_gap_reads_the_order_statistic():
    sz = _red_sizes()
    v = np.array([1, 2, 3, 4, 100], np.uint32)
    cols = {"ip_dst": np.zeros(5, np.uint32), "port_dst": np.zeros(5, np.uint32),
            "protocol": np.zeros(5, np.uint32), "status": np.zeros(5, np.uint32),
            "rrt_us": v}
    ref = app_red.window_counts(app_red.Derived(_Bank(cols), sz).take(0, 5), sz)
    grp = int(np.nonzero(ref["requests"])[0][0])
    qs = np.zeros((3, 64), np.float32)
    qs[:, grp] = [3.0, 100.0, 100.0]            # exact order statistics
    assert app_red.quantile_gap(ref, qs, sz) == 0.0
    qs[0, grp] = 3.09                           # 3% off the median
    assert app_red.quantile_gap(ref, qs, sz) == pytest.approx(0.03, rel=1e-5)
