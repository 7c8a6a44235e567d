"""The port's ShadowAuditor against the JAX package's, on the CPU.

The same seeded streams go through both auditors (standalone, and inside
each package's exporter): every window's snapshot dict has the same keys
and values, integers and flags exactly, floats within rtol 1e-6 (the
device entropies they are compared against differ in the last float32
ulp between XLA and ATen). Then the reference's audit cases that need no
tracer: sampler determinism, rate scaling, agreement with the sketch,
bit-invisibility, conservation through degraded mode, lossy windows, the
alarm ladder, the key cap, and the detection audit's precision and
recall."""

import numpy as np
import pytest
import torch

from deepflow_tpu.batch.schema import L4_SCHEMA
from deepflow_tpu.models import flow_suite as jfs
from deepflow_tpu.replay.generator import SyntheticAgent, ddos_ramp
from deepflow_tpu.runtime import tpu_sketch as jts
from deepflow_tpu.runtime.audit import ShadowAuditor as JAuditor
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.models import flow_suite
from deepflow_tpu_torch.runtime.audit import ShadowAuditor
from deepflow_tpu_torch.runtime.faults import default_faults
from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter

FLOAT_RTOL = 1e-6
CFG = flow_suite.FlowSuiteConfig()


@pytest.fixture(autouse=True)
def _clean_faults():
    default_faults().disarm()
    yield
    default_faults().disarm()


def _stream(n=40000, pool=512, seed=0xC0FFEE):
    return SyntheticAgent(seed=seed).l4_columns_pooled(n, pool=pool)


def _chunks(cols, rows=8000):
    n = len(next(iter(cols.values())))
    return [{k: v[i:i + rows] for k, v in cols.items()}
            for i in range(0, n, rows)]


def _exporter(audit_rate, **kw):
    kw.setdefault("wire", "lanes")
    return TpuSketchExporter(cfg=CFG, window_seconds=3600, batch_rows=4096,
                             audit_rate=audit_rate, device="cpu", **kw)


def _assert_snap_equal(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, b in want.items():
        a = got[k]
        if isinstance(b, float):
            np.testing.assert_allclose(a, b, rtol=FLOAT_RTOL, err_msg=k)
        else:
            assert a == b, (k, a, b)


def _window_out(keys, counts, card, ent, rows, k=CFG.top_k):
    """A host window output in both packages' shapes."""
    kk = np.full(k, 0xFFFFFFFF, np.uint32)
    cc = np.full(k, -1, np.int32)
    kk[:len(keys)] = keys
    cc[:len(counts)] = counts
    j = jfs.FlowWindowOutput(
        topk_keys=kk, topk_counts=cc,
        service_cardinality=np.asarray([card], np.float32),
        entropies=np.asarray(ent, np.float32),
        rows=np.asarray(rows, np.int32))
    t = flow_suite.FlowWindowOutput(
        topk_keys=torch.from_numpy(kk.view(np.int32)),
        topk_counts=torch.from_numpy(cc),
        service_cardinality=torch.tensor([card], dtype=torch.float32),
        entropies=torch.tensor(np.asarray(ent, np.float32)),
        rows=torch.tensor(rows, dtype=torch.int32))
    return t, j


@pytest.mark.parametrize("rate", [1.0, 0.25, 1.0 / 64])
def test_auditor_snapshot_matches_jax(rate):
    """Standalone auditors over the same chunks and window outputs (a
    head read from the shadow, skewed by a window-dependent offset so
    the comparisons vary), with detection verdicts: the same snapshot
    dict every window and the same counters."""
    a, b = ShadowAuditor(CFG, rate=rate), JAuditor(jfs.FlowSuiteConfig(),
                                                   rate=rate)
    rng = np.random.default_rng(6)
    for w in range(8):
        cols = _stream(12000, pool=256, seed=w)
        for c in _chunks(cols, rows=3000):
            assert a.absorb(c) == b.absorb(c)
        keys = sorted(b._counts, key=b._counts.get, reverse=True)[:50]
        counts = [b._counts[k] + int(rng.integers(0, 3 * w + 1))
                  for k in keys]
        ent = rng.uniform(0.2, 0.9, 4)
        t, j = _window_out(np.asarray(keys, np.uint32), counts,
                           float(rng.uniform(100, 400)), ent, 12000)
        det = {"eligible": w >= 2, "alerted": w in (5, 6), "score": 0.0,
               "threshold": 4.0, "warmup_windows": 2, "ewma_alpha": 0.05}
        out = None if w == 3 else t
        _assert_snap_equal(a.close_window(out, lossy=w == 4, detection=det),
                           b.close_window(None if w == 3 else j,
                                          lossy=w == 4, detection=det))
    _assert_snap_equal(a.counters(), b.counters())


@pytest.mark.parametrize("wire", ["lanes", "dict"])
def test_exporter_audit_matches_jax_exporter(wire):
    """Each package's exporter with the audit at 1/64 on ddos_ramp: the
    same audit snapshot at every window close."""
    ramp = ddos_ramp(seed=5, rows_per_window=4096)
    jexp = jts.TpuSketchExporter(store=None, cfg=jfs.FlowSuiteConfig(),
                                 batch_rows=4096, window_seconds=3600,
                                 wire=wire, prefetch_depth=2, zero_copy=True,
                                 audit_rate=1 / 64)
    texp = _exporter(1 / 64, wire=wire, prefetch_depth=2)
    try:
        for w in range(10, 18):
            _, cols = ramp.window_cols(w)
            for e in (jexp, texp):
                e.process([("l4_flow_log", 0, cols, -1)])
                e.flush_window(now=1000.0 + w)
            _assert_snap_equal(texp._audit.last_window,
                               jexp._audit.last_window)
        _assert_snap_equal(texp._audit.counters(), jexp._audit.counters())
        assert texp.counters()["audit_windows"] == 8
    finally:
        jexp.close()
        texp.close()


def test_sampler_deterministic_across_restarts():
    cols = _stream(20000)
    a, b = ShadowAuditor(CFG, rate=0.25), ShadowAuditor(CFG, rate=0.25)
    ref = JAuditor(jfs.FlowSuiteConfig(), rate=0.25)
    for c in _chunks(cols, rows=5000):
        a.absorb(c)
        ref.absorb(c)
    for c in _chunks(cols, rows=1777):
        b.absorb(c)
    assert a._counts and a._counts == b._counts == ref._counts
    assert a._clients == b._clients == ref._clients
    np.testing.assert_array_equal(a._ent, b._ent)
    np.testing.assert_array_equal(a._ent, ref._ent)
    assert 0 < a.sampled_rows_total < a.rows_seen_total


def test_sample_rate_scales_admission():
    cols = _stream(20000, pool=2048)
    lo, hi = ShadowAuditor(CFG, rate=1.0 / 16), ShadowAuditor(CFG, rate=1.0)
    for c in _chunks(cols):
        lo.absorb(c)
        hi.absorb(c)
    assert hi.sampled_rows_total == hi.rows_seen_total == 20000
    assert 0.02 < len(lo._counts) / len(hi._counts) < 0.2


def test_shadow_agrees_with_sketch_on_seeded_stream():
    exp = _exporter(audit_rate=1.0)
    try:
        for c in _chunks(_stream()):
            exp.process([("l4_flow_log", 0, c)])
        exp.flush_window()
        snap = exp._audit.last_window
        assert snap is not None and snap["rows_match"]
        assert snap["cms_rel_error"] <= exp._audit.cms_eps_theory
        assert snap["hll_rel_error"] <= snap["hll_eps_bound"]
        assert snap["entropy_abs_error"] <= snap["entropy_bound"]
        assert snap["topk_recall"] >= 0.9
        assert not snap["violation"] and not exp.audit_alarm
    finally:
        exp.close()


@pytest.mark.parametrize("wire,depth", [("lanes", 0), ("lanes", 2),
                                        ("dict", 0), ("dict", 2)])
def test_audit_is_bit_invisible_to_sketch_state(wire, depth):
    on = _exporter(1.0, wire=wire, prefetch_depth=depth)
    off = _exporter(0.0, wire=wire, prefetch_depth=depth)
    try:
        for c in _chunks(_stream(16000)):
            on.process([("l4_flow_log", 0, c)])
            off.process([("l4_flow_log", 0, c)])
        for e in (on, off):
            if e._feed is not None:
                assert e._feed.drain(30)
        for a, b in zip(convert.state_to_numpy(on.state),
                        convert.state_to_numpy(off.state)):
            np.testing.assert_array_equal(a, b)
        assert on._audit.rows_seen_total == on.rows_in == off.rows_in
    finally:
        on.close()
        off.close()


def test_audit_conservation_through_degraded_mode():
    """Every processed row is observed once, those that died on the
    device and those the host fallback absorbed too; the degraded window
    is audited, tagged, and kept out of the alarm ladder."""
    default_faults().arm_spec("tpu.device_error:count=2;seed=3")
    exp = _exporter(1.0)
    exp.degrade_after = 1
    try:
        sent = 0
        for c in _chunks(_stream(24000)):
            exp.process([("l4_flow_log", 0, c)])
            sent += len(next(iter(c.values())))
        assert exp.device_errors >= 1 and exp.degraded
        exp.flush_window()
        a = exp._audit
        assert a.rows_seen_total == exp.rows_in == sent
        assert a.degraded_windows >= 1 and a.last_window["degraded"]
        assert not a.alarm and a._violations == 0
    finally:
        exp.close()


def test_lossy_window_tagged_not_alarmed():
    default_faults().arm_spec("tpu.device_error:count=1;seed=5")
    exp = _exporter(1.0)
    try:
        for c in _chunks(_stream(24000)):
            exp.process([("l4_flow_log", 0, c)])
        assert exp.device_errors == 1 and not exp.degraded
        exp.flush_window()
        snap = exp._audit.last_window
        assert snap["lossy"] and exp._audit.lossy_windows == 1
        assert exp._audit._violations == 0
    finally:
        exp.close()


def test_alarm_trips_on_consecutive_violations_and_clears():
    a = ShadowAuditor(CFG, rate=1.0, trip_windows=3, clear_windows=2,
                      min_sampled_rows=10)
    cols = _stream(4000, pool=64)

    def one_window(honest: bool):
        for c in _chunks(cols, rows=4000):
            a.absorb(c)
        keys = np.array(sorted(a._counts, key=a._counts.get,
                               reverse=True)[:CFG.top_k], np.uint64)
        exact = np.array([a._counts[int(k)] for k in keys], np.int64)
        dev = exact if honest else exact + 4000
        card = len(a._clients) / a.rate
        h = a._ent.astype(np.float64)
        p = h / np.maximum(h.sum(axis=1, keepdims=True), 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            xlogx = np.where(p > 0, p * np.log(p), 0.0)
        ent = -xlogx.sum(axis=1) / np.log(a._buckets)
        t, _ = _window_out(keys.astype(np.uint32),
                           np.minimum(dev, 2 ** 31 - 1).astype(np.int32),
                           card, ent, 4000)
        return a.close_window(t)

    assert not one_window(honest=True)["violation"]
    assert one_window(honest=False)["violation"] and not a.alarm
    one_window(honest=False)
    assert not a.alarm
    one_window(honest=False)
    assert a.alarm and a.alarm_trips == 1
    one_window(honest=True)
    assert a.alarm
    one_window(honest=True)
    assert not a.alarm


def test_shadow_key_cap_clips_and_tags():
    a = ShadowAuditor(CFG, rate=1.0, max_keys=64)
    rng = np.random.default_rng(9)
    cols = {name: rng.integers(0, 1 << 20, 4000).astype(dt)
            for name, dt in L4_SCHEMA.columns}
    a.absorb(cols)
    assert a.evicted_keys > 0 and a._clipped
    assert len(a._counts) <= 64
    snap = a.close_window(None)
    assert snap["clipped"] and a.clipped_windows == 1


def test_shadow_audits_detection_precision_recall():
    """Calm windows the device also calls calm are true negatives;
    attack windows it alerts on are true positives."""
    aud = ShadowAuditor(CFG, rate=1.0)
    ramp = ddos_ramp(seed=7, rows_per_window=2048)

    def verdict(alerted):
        return {"eligible": True, "alerted": alerted, "score": 0.0,
                "threshold": 4.0, "warmup_windows": 4, "ewma_alpha": 0.05}

    out, _ = _window_out([], [], 100.0, [0.8, 0.5, 0.9, 0.3], 2048)
    names = ("ip_src", "ip_dst", "port_src", "port_dst", "proto",
             "packet_tx", "packet_rx")
    for w in range(12):
        _, cols = ramp.window_cols(w)
        aud.absorb({k: cols[k] for k in names})
        aud.close_window(out, detection=verdict(False))
    assert aud.det_tn >= 6 and aud.det_fp == 0
    for w in range(15, 19):
        _, cols = ramp.window_cols(w)
        aud.absorb({k: cols[k] for k in names})
        aud.close_window(out, detection=verdict(True))
    c = aud.counters()
    assert c["detection_tp"] >= 1, c
    assert c["detection_precision"] == 1.0 and c["detection_recall"] == 1.0
