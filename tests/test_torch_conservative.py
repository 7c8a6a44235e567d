"""The conservative Count-Min and the staged update against the JAX
package, on the CPU.

- `cms.update_conservative` on batches with duplicate keys, masked-out
  padding lanes, zero and large weights and keys of 2^31 and above (held
  as negative int32 bits), on a state that already holds counts; then
  `cms.decay`. Every count equal.
- `flow_suite.update` with `conservative=True` over several batches:
  every state leaf equal.
- `flow_suite.update_plane` (the full-row plane) and
  `flow_suite.make_staged_update`: every state leaf equal to the JAX
  functions of the same names.
- The exporter with `staged=True` against the JAX exporter with
  `staged=True`, window by window on `ddos_ramp`, the anomaly plane on:
  every sketch state leaf and every integer leaf of the plane's state
  equal at every window close, the window outputs equal; and the
  warnings when `wire="dict"` or a feed is asked for.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflow_tpu.models import flow_suite as jfs
from deepflow_tpu.ops import cms as jcms
from deepflow_tpu.replay.generator import ddos_ramp
from deepflow_tpu.runtime import tpu_sketch as jts
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.batch.batcher import SKETCH_L4_SCHEMA
from deepflow_tpu_torch.models import flow_suite
from deepflow_tpu_torch.ops import cms
from deepflow_tpu_torch.runtime.faults import default_faults
from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter

_SMALL = dict(cms_log2_width=12, ring_size=256, hll_groups=64,
              hll_precision=8, entropy_log2_buckets=10)


@pytest.fixture(autouse=True)
def _clean_faults():
    default_faults().disarm()
    yield
    default_faults().disarm()


def _bits(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _jleaves(js):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.device_get(js))]


def _assert_state_equal(ts, js):
    got, want = convert.state_to_numpy(ts), _jleaves(js)
    for (name, _), a, b in zip(convert.SUITE_LEAVES, got, want):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _cms_pair(rng, log2_width=8):
    """A JAX CMS state already holding counts, and the port's copy."""
    js = jcms.init(4, log2_width, seed=0xC0FFEE)
    counts = rng.integers(0, 50, js.counts.shape).astype(np.int32)
    js = js._replace(counts=jnp.asarray(counts))
    ts = cms.CMSState(counts=torch.from_numpy(counts.copy()),
                      seeds=_bits(np.asarray(js.seeds)))
    return js, ts


def _keys(rng, n, distinct):
    """n u32 keys from a pool of `distinct`, half of them >= 2^31."""
    pool = np.concatenate([
        rng.integers(0, 1 << 31, distinct // 2),
        rng.integers(1 << 31, 1 << 32, distinct - distinct // 2,
                     dtype=np.uint64)]).astype(np.uint32)
    return pool[rng.integers(0, distinct, n)]


@pytest.mark.parametrize("n,distinct,weighted,masked", [
    (64, 8, False, False),
    (500, 40, True, True),
    (3000, 3000, True, False),
    (9000, 700, False, True),
    (9000, 50, True, True),
])
def test_update_conservative_matches_jax(n, distinct, weighted, masked):
    rng = np.random.default_rng(n + distinct)
    js, ts = _cms_pair(rng)
    for _ in range(3):
        keys = _keys(rng, n, distinct)
        w = rng.choice([0, 1, 7, 300, 1 << 20], n).astype(np.int32) \
            if weighted else None
        mask = (np.arange(n) < n - n // 5) if masked else None
        js = jcms.update_conservative(
            js, jnp.asarray(keys), None if w is None else jnp.asarray(w),
            None if mask is None else jnp.asarray(mask))
        out = cms.update_conservative(
            ts, _bits(keys), None if w is None else torch.from_numpy(w),
            None if mask is None else torch.from_numpy(mask))
        assert out.counts is ts.counts            # in place
        np.testing.assert_array_equal(ts.counts.numpy(),
                                      np.asarray(js.counts))


def test_update_conservative_never_under_counts():
    """Every key's estimate reaches its exact count, and no bucket grows
    past what the max rule allows (the plain update's sum)."""
    rng = np.random.default_rng(5)
    keys = _keys(rng, 4000, 300)
    state = cms.init(4, 8, device="cpu")
    plain = cms.init(4, 8, device="cpu")
    cms.update_conservative(state, _bits(keys))
    cms.update(plain, _bits(keys))
    uniq, exact = np.unique(keys, return_counts=True)
    est = cms.query(state, _bits(uniq)).numpy()
    assert (est >= exact).all()
    assert (state.counts <= plain.counts).all()
    assert (est <= cms.query(plain, _bits(uniq)).numpy()).all()


@pytest.mark.parametrize("shift", [1, 3])
def test_decay_matches_jax(shift):
    rng = np.random.default_rng(shift)
    counts = rng.integers(-(1 << 31), 1 << 31, (4, 64),
                          dtype=np.int64).astype(np.int32)
    js = jcms.CMSState(counts=jnp.asarray(counts),
                       seeds=jcms.init(4, 6).seeds)
    ts = cms.CMSState(counts=torch.from_numpy(counts.copy()),
                      seeds=_bits(np.asarray(js.seeds)))
    got = cms.decay(ts, shift)
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(jcms.decay(js, shift).counts))
    np.testing.assert_array_equal(ts.counts.numpy(), counts)   # not in place


def _records(rng, n, pool=400):
    base = {
        "ip_src": rng.integers(0, 1 << 32, pool, dtype=np.uint64),
        "ip_dst": rng.integers(0, 1 << 32, pool, dtype=np.uint64),
        "port_src": rng.integers(1024, 1 << 16, pool),
        "port_dst": rng.choice([53, 80, 443, 8080], pool),
        "proto": rng.choice([6, 17], pool),
    }
    pick = (rng.zipf(1.1, n) - 1).clip(max=pool - 1)
    cols = {k: v[pick].astype(np.uint32) for k, v in base.items()}
    # per-batch cell sums stay below 2^24, where the reference's float32
    # histogram is exact (8192 rows x 2000 packets at most)
    cols["packet_tx"] = rng.integers(0, 1000, n).astype(np.uint32)
    cols["packet_rx"] = rng.integers(0, 1000, n).astype(np.uint32)
    return cols


def _start(**kw):
    jcfg = jfs.FlowSuiteConfig(**_SMALL, **kw)
    tcfg = flow_suite.FlowSuiteConfig(**_SMALL, **kw)
    js = jfs.init(jcfg)
    ts, _ = convert.state_from_numpy(jax.device_get(js), device="cpu")
    return jcfg, tcfg, js, ts


@pytest.mark.parametrize("n", [2048, 8192])
def test_conservative_flow_suite_update_matches_jax(n):
    rng = np.random.default_rng(n)
    jcfg, tcfg, js, ts = _start(conservative=True)
    assert not flow_suite.use_fused_hists(tcfg, "cpu")
    jupdate = jax.jit(lambda s, c, m: jfs.update(s, c, m, jcfg))
    for b in range(3):
        cols = _records(rng, n)
        mask = np.arange(n) < n - 100 * b
        js = jupdate(js, {k: jnp.asarray(v) for k, v in cols.items()},
                     jnp.asarray(mask))
        ts = flow_suite.update(ts, {k: _bits(v) for k, v in cols.items()},
                               torch.from_numpy(mask), tcfg)
        _assert_state_equal(ts, js)
    js, jout = jfs.flush(js, jcfg)
    ts, tout = flow_suite.flush(ts, tcfg)
    np.testing.assert_array_equal(tout.topk_counts.numpy(),
                                  np.asarray(jout.topk_counts))
    np.testing.assert_array_equal(tout.topk_keys.numpy().view(np.uint32),
                                  np.asarray(jout.topk_keys))


def _full_row(rng, n):
    cols = _records(rng, n)
    full = {}
    for name, dt in SKETCH_L4_SCHEMA.columns:
        full[name] = cols[name].astype(dt) if name in cols else \
            rng.integers(-5, 5, n).astype(dt)
    return full


def test_update_plane_matches_jax_update_plane():
    from deepflow_tpu.batch.schema import SKETCH_L4_SCHEMA as JSCHEMA
    assert JSCHEMA.columns == SKETCH_L4_SCHEMA.columns
    rng = np.random.default_rng(11)
    jcfg, tcfg, js, ts = _start()
    n = 4096
    jupdate = jax.jit(lambda s, p, m: jfs.update_plane(s, p, m, jcfg))
    for b in range(2):
        full = _full_row(rng, n)
        plane = np.stack([full[k].view(np.uint32) if full[k].dtype == np.int32
                          else full[k] for k, _ in SKETCH_L4_SCHEMA.columns])
        mask = np.arange(n) < n - 33 * b
        js = jupdate(js, jnp.asarray(plane), jnp.asarray(mask))
        ts = flow_suite.update_plane(ts, _bits(plane),
                                     torch.from_numpy(mask), tcfg)
        _assert_state_equal(ts, js)
    assert set(flow_suite.unpack_plane(_bits(plane))) == \
        set(SKETCH_L4_SCHEMA.names)
    with pytest.raises(ValueError):
        flow_suite.unpack_plane(_bits(plane[:4]))


def test_staged_update_matches_jax_staged_update():
    rng = np.random.default_rng(12)
    jcfg, tcfg, js, ts = _start()
    jstep = jfs.make_staged_update(jcfg)
    tstep = flow_suite.make_staged_update(tcfg)
    n = 2048
    for b in range(3):
        cols = _records(rng, n)
        mask = np.arange(n) < n - 7 * b
        js = jstep(js, {k: jnp.asarray(v) for k, v in cols.items()},
                   jnp.asarray(mask))
        ts = tstep(ts, {k: _bits(v) for k, v in cols.items()},
                   torch.from_numpy(mask))
        _assert_state_equal(ts, js)


RAMP_ROWS = 3000


def _plane_ints(leaves):
    return [a for (_, dt), a in zip(convert.ANOMALY_LEAVES, leaves)
            if np.dtype(dt).kind in "iu"]


def _run_staged(exp, jax_side):
    """Feed ddos_ramp window by window; per window close the sketch
    state leaves, the plane's integer leaves and the window output."""
    ramp = ddos_ramp(seed=7, rows_per_window=RAMP_ROWS)
    out = []
    for w, _phase, cols in ramp.windows():
        if w >= 14:
            break
        exp.process([("l4_flow_log", 0, cols, -1)])
        if jax_side:
            state = _jleaves(exp.state)
        else:
            state = convert.state_to_numpy(exp.state)
        o = exp.flush_window(now=1000.0 + w)
        if jax_side:
            plane = _jleaves(exp.anomaly.state)
            o = [np.asarray(x) for x in o]
        else:
            plane = convert.anomaly_to_numpy(exp.anomaly.state)
            o = [x.numpy() for x in o]
        out.append((state, _plane_ints(plane), o, list(exp.anomaly.alerts_total)))
    return out


def test_staged_exporter_matches_jax_staged_exporter(caplog):
    kw = dict(batch_rows=1024, window_seconds=3600, staged=True,
              anomaly=True)
    with caplog.at_level(logging.WARNING):
        exp = TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(**_SMALL),
                                wire="dict", prefetch_depth=2, device="cpu",
                                **kw)
    msgs = [r.getMessage() for r in caplog.records
            if r.name == "deepflow_tpu_torch.runtime.tpu_sketch"]
    assert any("forces the packed lane" in m for m in msgs)
    assert any("no coalesced feed" in m for m in msgs)
    jexp = jts.TpuSketchExporter(store=None,
                                 cfg=jfs.FlowSuiteConfig(**_SMALL),
                                 wire="dict", prefetch_depth=2, **kw)
    try:
        assert (exp.wire, exp.prefetch_depth, exp.zero_copy) == \
            (jexp.wire, jexp.prefetch_depth, jexp.zero_copy) == \
            ("lanes", 0, False)
        got, want = _run_staged(exp, False), _run_staged(jexp, True)
        assert exp.rows_in == jexp.rows_in
    finally:
        exp.close()
        jexp.close()
    assert len(got) == len(want) == 14
    for w, ((gs, gp, go, ga), (ws, wp, wo, wa)) in enumerate(zip(got, want)):
        for (name, _), a, b in zip(convert.SUITE_LEAVES, gs, ws):
            np.testing.assert_array_equal(a, b, err_msg=f"{w} {name}")
        for a, b in zip(gp, wp):
            np.testing.assert_array_equal(a, b, err_msg=f"window {w}")
        np.testing.assert_array_equal(go[0].view(np.uint32), wo[0])
        np.testing.assert_array_equal(go[1], wo[1])
        np.testing.assert_array_equal(go[4], wo[4])
        for i in (2, 3):
            np.testing.assert_allclose(go[i], wo[i], rtol=1e-5, atol=1e-6)
        assert ga == wa, w
