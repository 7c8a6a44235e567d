"""The port's DDSketch (deepflow_tpu_torch/ops/ddsketch.py) against the
JAX package's, on the CPU (the hist kernel's plain version).

Bucket boundaries are a ruling, not a fault: the reference takes
`ceil(log(v)/log(g))` in float32, whose rounding depends on the `log`
implementation; the port reads the exact float64 boundaries from a
table. So the port is held to the exact float64 ceil everywhere, and to
the reference everywhere except on values within 1e-4 of a boundary in
log_g units, which sit one bucket apart. Counts and `zeros` are exact;
the quantile estimate is within rtol 2e-6 of the reference's (its table
is built from the reference's float32 arithmetic, within one ulp).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepflow_tpu.ops import ddsketch as jdd
from deepflow_tpu_torch.ops import ddsketch as tdd

U32_EDGES = np.array([0, 1, 2, 2**24 - 1, 2**24, 2**24 + 1, 2**31 - 1,
                      2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1], np.uint32)
Q_RTOL = 2e-6


def _cfgs(cfg):
    """The same config in both packages."""
    return jdd.DDSketchConfig(*cfg), tdd.DDSketchConfig(*cfg)


def _exact_bucket(values_u32: np.ndarray, cfg) -> np.ndarray:
    """ceil(log_g(max(f32(v), min)/min)) in float64, clipped."""
    v = np.maximum(values_u32.astype(np.float32),
                   np.float32(cfg.min_value)).astype(np.float64)
    i = np.ceil(np.log(v / cfg.min_value) / np.log(tdd.gamma(cfg)))
    return np.clip(i, 0, cfg.buckets - 1).astype(np.int32)


def _bits(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> the port's int32-bits tensor."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _jax_buckets(values, cfg):
    return np.asarray(jax.jit(lambda v: jdd.bucket_index(v, cfg))(
        jnp.asarray(values)))


def _boundary_integers(cfg) -> np.ndarray:
    """Integers in [0, 2^24) where XLA's float32 log puts the value in
    another bucket than the exact float64 ceil."""
    v = np.arange(1 << 24, dtype=np.uint32)
    return v[_jax_buckets(v, cfg) != _exact_bucket(v, cfg)]


def test_bucket_index_sweep_every_integer_below_2_24():
    """One call per package over [0, 2^24) and the u32 edges: the port
    equals the exact float64 ceil everywhere; the reference differs on
    at most 400 values, each by one bucket, each within 1e-4 of a
    boundary in log_g units."""
    jcfg, tcfg = _cfgs(tdd.DDSketchConfig())
    v = np.concatenate([np.arange(1 << 24, dtype=np.uint32), U32_EDGES])
    exact = _exact_bucket(v, tcfg)
    port = tdd.bucket_index(_bits(v), tcfg).numpy()
    assert port.dtype == np.int32
    np.testing.assert_array_equal(port, exact)
    ref = _jax_buckets(v, jcfg)
    diff = np.nonzero(ref != port)[0]
    assert 0 < len(diff) <= 400
    assert np.all(np.abs(ref[diff] - port[diff]) == 1)
    logg = np.log(v[diff].astype(np.float64)) / np.log(tdd.gamma(tcfg))
    assert np.max(np.abs(logg - np.round(logg))) < 1e-4
    # the u32 edges: 2^31 and above are large values, never zeros
    edge = port[-len(U32_EDGES):]
    assert edge[U32_EDGES >= 2**31].tolist() == [tcfg.buckets - 1] * 4
    np.testing.assert_array_equal(edge, ref[-len(U32_EDGES):])


def test_bucket_index_float_values_match_exact():
    """Float inputs (the reference tests' form) read as float32."""
    _, tcfg = _cfgs((4, 1024, 0.01, 1.0))
    rng = np.random.default_rng(1)
    v = np.concatenate([rng.lognormal(8.0, 1.0, 20000),
                        rng.uniform(0, 10, 1000), [0.0, 0.5, 1.0, 1.5]])
    v32 = v.astype(np.float32)
    got = tdd.bucket_index(torch.from_numpy(v32), tcfg).numpy()
    w = np.maximum(v32, np.float32(1.0)).astype(np.float64)
    want = np.clip(np.ceil(np.log(w) / np.log(tdd.gamma(tcfg))), 0, 1023)
    np.testing.assert_array_equal(got, want.astype(np.int32))


def _streams(rng, cfg, boundary):
    """(name, group, u32 values, mask): log-normal latencies, uniform,
    zeros, masked rows, u32 edges and values on bucket boundaries."""
    n = 4096
    group = rng.integers(0, cfg.groups, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    lognormal = np.round(rng.lognormal(np.log(2000), 1.2, n))
    uniform = rng.integers(1, 10**6, n)
    edges = np.resize(np.concatenate([U32_EDGES, boundary]), n)
    mixed = lognormal.copy()
    mixed[rng.random(n) < 0.05] = 0
    return [("lognormal", group, lognormal, None),
            ("uniform", group, uniform, None),
            ("zeros_masked", group, mixed, mask),
            ("edges_boundaries", group, edges, mask)]


def _port_state_of(js) -> tdd.DDSketchState:
    return tdd.DDSketchState(
        hist=torch.from_numpy(np.asarray(js.hist).astype(np.int32)),
        zeros=torch.from_numpy(np.asarray(js.zeros).astype(np.int32)))


def _assert_quantiles(ts, js, jcfg, tcfg):
    """Quantiles of the same state: same bucket, value within Q_RTOL."""
    mids = tdd.midpoints(tcfg)
    for q in (0.01, 0.5, 0.95, 0.99, 1.0):
        got = tdd.quantile(ts, q, tcfg).numpy()
        want = np.asarray(jdd.quantile(js, q, jcfg))
        np.testing.assert_allclose(got, want, rtol=Q_RTOL, atol=0)
        nz = want > 0
        np.testing.assert_array_equal(
            np.abs(mids[None, :] - got[nz, None]).argmin(1),
            np.abs(mids[None, :] - want[nz, None]).argmin(1))


def _moves(group, v, mask, jcfg, tcfg):
    """(group, reference bucket, port bucket) of every counted row whose
    value the two packages bucket apart (a boundary value)."""
    m = np.ones(len(v), bool) if mask is None else mask
    jb, tb = _jax_buckets(v, jcfg), _exact_bucket(v, tcfg)
    live = m & (v.astype(np.float32) >= 1.0) & (jb != tb)
    return list(zip(group[live], jb[live], tb[live]))


def _moved(jhist, moves) -> np.ndarray:
    """The reference's hist with the boundary rows moved to the port's
    bucket, as int32."""
    h = np.asarray(jhist).copy()
    for g, a, b in moves:
        h[g, a] -= 1
        h[g, b] += 1
    return h.astype(np.int32)


def test_update_merge_quantile_counts_match_jax():
    jcfg, tcfg = _cfgs((64, 512, 0.02, 1.0))
    rng = np.random.default_rng(2)
    boundary = _boundary_integers(tcfg)
    assert len(boundary) > 0
    jstate = jdd.init(jcfg)
    tstate = tdd.init(tcfg, "cpu")
    upd = jax.jit(lambda s, g, v, m: jdd.update(s, g, v, m, jcfg))
    moves = []
    for name, group, values, mask in _streams(rng, tcfg, boundary):
        v = values.astype(np.uint32)
        m = np.ones(len(v), bool) if mask is None else mask
        jstate = upd(jstate, jnp.asarray(group), jnp.asarray(v),
                     jnp.asarray(m))
        tstate = tdd.update(tstate, torch.from_numpy(group), _bits(v),
                            None if mask is None else torch.from_numpy(mask),
                            tcfg)
        moves += _moves(group, v, mask, jcfg, tcfg)
    assert moves, "the edge stream holds no boundary value"
    # zeros and counts exact
    np.testing.assert_array_equal(tstate.zeros.numpy(),
                                  np.asarray(jstate.zeros))
    np.testing.assert_array_equal(tdd.counts(tstate).numpy(),
                                  np.asarray(jdd.counts(jstate)))
    # hist exact once the boundary rows move to the exact bucket
    np.testing.assert_array_equal(tstate.hist.numpy(),
                                  _moved(jstate.hist, moves))
    _assert_quantiles(_port_state_of(jstate), jstate, jcfg, tcfg)
    # merge: the exact union, in both packages
    other_j = upd(jdd.init(jcfg), jnp.asarray(np.zeros(3, np.int32)),
                  jnp.asarray(np.array([5, 0, 900], np.uint32)),
                  jnp.asarray(np.ones(3, bool)))
    mj = jdd.merge(jstate, other_j)
    mt = tdd.merge(_port_state_of(jstate), _port_state_of(other_j))
    np.testing.assert_array_equal(mt.hist.numpy(), np.asarray(mj.hist))
    np.testing.assert_array_equal(mt.zeros.numpy(), np.asarray(mj.zeros))


def test_quantile_of_lognormal_stream_equals_jax_end_to_end():
    """Latencies as the RED lane sees them (u32 us, 1% zeros) at the
    defaults: the port's own state against the reference's (boundary
    rows moved), and its quantiles on every group no boundary row
    touched."""
    jcfg, tcfg = _cfgs(tdd.DDSketchConfig())
    rng = np.random.default_rng(3)
    n = 1 << 14
    group = rng.integers(0, 1024, n).astype(np.int32)
    v = np.round(rng.lognormal(np.log(2000), 1.2, n)).astype(np.uint32)
    v[rng.random(n) < 0.01] = 0
    js = jdd.update(jdd.init(jcfg), jnp.asarray(group), jnp.asarray(v),
                    cfg=jcfg)
    ts = tdd.update(tdd.init(tcfg, "cpu"), torch.from_numpy(group), _bits(v),
                    cfg=tcfg)
    moves = _moves(group, v, None, jcfg, tcfg)
    np.testing.assert_array_equal(ts.zeros.numpy(), np.asarray(js.zeros))
    np.testing.assert_array_equal(ts.hist.numpy(), _moved(js.hist, moves))
    clean = np.ones(tcfg.groups, bool)
    clean[[g for g, _, _ in moves]] = False
    for q in (0.5, 0.95, 0.99):
        np.testing.assert_allclose(
            tdd.quantile(ts, q, tcfg).numpy()[clean],
            np.asarray(jdd.quantile(js, q, jcfg))[clean], rtol=Q_RTOL,
            atol=0)


# -- the reference file's own cases (tests/test_ddsketch.py), on the port --

def test_quantile_relative_error():
    cfg = tdd.DDSketchConfig(groups=4, buckets=1024, alpha=0.01)
    rng = np.random.default_rng(5)
    vals0 = rng.lognormal(mean=8.0, sigma=1.0, size=20000)
    vals2 = rng.uniform(10, 10_000, size=20000)
    group = np.concatenate([np.zeros(20000, np.int32),
                            np.full(20000, 2, np.int32)])
    values = np.concatenate([vals0, vals2]).astype(np.float32)
    state = tdd.update(tdd.init(cfg, "cpu"), torch.from_numpy(group),
                       torch.from_numpy(values), cfg=cfg)
    for q in (0.5, 0.95, 0.99):
        est = tdd.quantile(state, q, cfg).numpy()
        for g, vals in ((0, vals0), (2, vals2)):
            exact = np.quantile(vals, q)
            assert abs(est[g] - exact) / exact < 3 * cfg.alpha, (q, g)
    est = tdd.quantile(state, 0.5, cfg).numpy()
    assert est[1] == 0.0 and est[3] == 0.0
    cnt = tdd.counts(state).numpy()
    assert cnt[0] == 20000 and cnt[2] == 20000 and cnt.dtype == np.float32


def test_merge_is_exact_union():
    cfg = tdd.DDSketchConfig(groups=2, buckets=512, alpha=0.02)
    rng = np.random.default_rng(6)
    a_vals = torch.from_numpy(rng.uniform(1, 5000, 5000).astype(np.float32))
    b_vals = torch.from_numpy(rng.uniform(1, 5000, 5000).astype(np.float32))
    g = torch.zeros(5000, dtype=torch.int32)
    a = tdd.update(tdd.init(cfg, "cpu"), g, a_vals, cfg=cfg)
    b = tdd.update(tdd.init(cfg, "cpu"), g, b_vals, cfg=cfg)
    merged = tdd.merge(a, b)
    both = tdd.update(tdd.init(cfg, "cpu"), g, a_vals, cfg=cfg)
    both = tdd.update(both, g, b_vals, cfg=cfg)
    assert torch.equal(merged.hist, both.hist)
    assert torch.equal(tdd.quantile(merged, 0.95, cfg),
                       tdd.quantile(both, 0.95, cfg))


def test_zero_and_masked_values():
    cfg = tdd.DDSketchConfig(groups=1, buckets=64, alpha=0.05)
    vals = torch.tensor([0, 0, 100, 200], dtype=torch.float32)
    g = torch.zeros(4, dtype=torch.int32)
    mask = torch.tensor([True, True, True, False])
    s = tdd.update(tdd.init(cfg, "cpu"), g, vals, mask=mask, cfg=cfg)
    assert float(tdd.counts(s)[0]) == 3          # masked row dropped
    assert int(s.zeros[0]) == 2                  # sub-min values
    est = float(tdd.quantile(s, 0.9, cfg)[0])
    assert abs(est - 100) / 100 < 3 * cfg.alpha


def test_update_is_in_place_and_state_is_int32():
    cfg = tdd.DDSketchConfig(groups=2, buckets=16, alpha=0.1)
    s = tdd.init(cfg, "cpu")
    hist, zeros = s.hist, s.zeros
    out = tdd.update(s, torch.tensor([1, 1, 0], dtype=torch.int32),
                     torch.tensor([3, 0, 7], dtype=torch.int32), cfg=cfg)
    assert out.hist is hist and out.zeros is zeros
    assert hist.dtype == zeros.dtype == torch.int32
    assert int(hist.sum()) == 2 and zeros.tolist() == [0, 1]


@pytest.mark.parametrize("cfg", [(1024, 512, 0.02, 1.0), (4, 64, 0.05, 1.0),
                                 (8, 1024, 0.01, 1.0)])
def test_tables_follow_the_config(cfg):
    jcfg, tcfg = _cfgs(cfg)
    b = tdd.boundaries(tcfg)
    assert b.dtype == np.float64 and len(b) == tcfg.buckets - 1
    assert b[0] == tcfg.min_value and np.all(np.diff(b) > 0)
    g = jdd.gamma(jcfg)
    ref = np.asarray(jax.jit(
        lambda i: jcfg.min_value * (2.0 * g ** i.astype(jnp.float32))
        / (g + 1.0))(jnp.arange(tcfg.buckets)))
    np.testing.assert_allclose(tdd.midpoints(tcfg), ref, rtol=Q_RTOL, atol=0)
