"""The port's AppSuite (deepflow_tpu_torch/models/app_suite.py) and its
`convert` leaves against the JAX package's, on the CPU (the hist
kernel's plain version).

Inputs are numpy from a seed, uint32 columns handed to the port as int32
bits, as its exporter copies them. Request, error and sketch counts are
exact; quantiles within rtol 2e-6 (the estimate table, see
test_torch_ddsketch.py). Latencies are log-normal (median 2 ms) with u32
edges and zeros; the batches here hold no value on a bucket boundary of
the configs used (checked), where the two packages' buckets may differ.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepflow_tpu.models import app_suite as jas
from deepflow_tpu.ops import ddsketch as jdd
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.models import app_suite as tas
from deepflow_tpu_torch.ops import ddsketch as tdd

Q_RTOL = 2e-6
STATUS = np.array([0, 1, 2, 10, 99, 100, 101, 199, 200, 204, 301, 399, 400,
                   404, 499, 500, 503, 599, 600, 1000, 2**31 - 1, 2**31,
                   2**31 + 7, 2**32 - 1], np.uint32)
RRT_EDGES = np.array([0, 1, 2, 2**31, 2**32 - 1], np.uint32)


def _cols(rng, n, proto_key="protocol"):
    cols = {
        "ip_dst": rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32),
        "port_dst": rng.integers(0, 1 << 16, n).astype(np.uint32),
        proto_key: rng.integers(0, 256, n).astype(np.uint32),
        "status": rng.choice(STATUS, n),
        "rrt_us": np.round(rng.lognormal(np.log(2000), 1.2, n)).astype(
            np.uint32),
    }
    cols["rrt_us"][:len(RRT_EDGES)] = RRT_EDGES
    return cols


def _no_boundary_values(v: np.ndarray, cfg) -> bool:
    """True when no value of `v` sits where the two packages' buckets
    may differ (the reference's float32 log against the exact ceil)."""
    jb = np.asarray(jdd.bucket_index(jnp.asarray(v), cfg))
    w = np.maximum(v.astype(np.float32), np.float32(1)).astype(np.float64)
    exact = np.clip(np.ceil(np.log(w) / np.log(jdd.gamma(cfg))), 0,
                    cfg.buckets - 1)
    return bool(np.all(jb == exact))


def _t(cols):
    """numpy uint32 columns -> the port's int32-bits tensors."""
    return {k: torch.from_numpy(v.view(np.int32)) for k, v in cols.items()}


def _j(cols):
    return {k: jnp.asarray(v) for k, v in cols.items()}


def _assert_state_equal(ts, js):
    for (path, _), a, b in zip(convert.APP_LEAVES, convert.app_to_numpy(ts),
                               jax.tree_util.tree_leaves(js)):
        b = np.asarray(b)
        assert a.dtype == b.dtype == np.float32, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def _assert_output_equal(to, jo):
    for name in jas.AppWindowOutput._fields:
        a, b = getattr(to, name).numpy(), np.asarray(getattr(jo, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name == "rrt_quantiles":
            np.testing.assert_allclose(a, b, rtol=Q_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("proto_key", ["protocol", "proto"])
def test_service_group_exact(proto_key):
    rng = np.random.default_rng(11)
    cols = _cols(rng, 5000, proto_key)
    for groups in (64, 1000, 1024):
        got = tas.service_group(_t(cols), groups)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jas.service_group(_j(cols), groups)))


def test_error_rule_on_u32_edges():
    """Every status of STATUS once, each in its own service: errors are
    4xx/5xx and above, and non-zero codes below 100, read as u32."""
    cfg = tas.AppSuiteConfig(groups=64)
    n = len(STATUS)
    cols = {"ip_dst": np.arange(n, dtype=np.uint32),
            "port_dst": np.full(n, 80, np.uint32),
            "protocol": np.full(n, 6, np.uint32),
            "status": STATUS.copy(),
            "rrt_us": np.full(n, 100, np.uint32)}
    mask = np.ones(n, bool)
    ts = tas.update(tas.init(cfg, "cpu"), _t(cols), torch.from_numpy(mask),
                    cfg)
    js = jas.update(jas.init(jas.AppSuiteConfig(groups=64)), _j(cols),
                    jnp.asarray(mask), jas.AppSuiteConfig(groups=64))
    _assert_state_equal(ts, js)
    want = int(((STATUS >= 400) | ((STATUS > 0) & (STATUS < 100))).sum())
    assert int(ts.errors.sum()) == want == 16
    assert int(ts.requests.sum()) == n


@pytest.mark.parametrize("groups", [64, 1024])
def test_update_flush_over_batches_match_jax(groups):
    """Several batches with padding masks, a flush, and a batch into the
    fresh state: every leaf and every output field equal."""
    jcfg, tcfg = jas.AppSuiteConfig(groups=groups), \
        tas.AppSuiteConfig(groups=groups)
    rng = np.random.default_rng(12 + groups)
    n = 4096
    js, ts = jas.init(jcfg), tas.init(tcfg, "cpu")
    upd = jax.jit(lambda s, c, m: jas.update(s, c, m, jcfg))
    for b in range(4):
        cols = _cols(rng, n)
        assert _no_boundary_values(cols["rrt_us"], jcfg.dd)
        mask = np.arange(n) < n - 97 * b
        js = upd(js, _j(cols), jnp.asarray(mask))
        ts = tas.update(ts, _t(cols), torch.from_numpy(mask), tcfg)
        _assert_state_equal(ts, js)
    js, jo = jax.jit(lambda s: jas.flush(s, jcfg))(js)
    ts, to = tas.flush(ts, tcfg)
    _assert_output_equal(to, jo)
    assert float(to.requests.sum()) == 4 * n - 97 * 6
    assert int(ts.requests.sum()) == 0 and ts.requests.dtype == torch.int32
    cols = _cols(rng, n)
    mask = np.ones(n, bool)
    _assert_state_equal(tas.update(ts, _t(cols), torch.from_numpy(mask), tcfg),
                        upd(js, _j(cols), jnp.asarray(mask)))


def test_merge_is_the_single_update():
    """Splitting a batch and merging equals the single update, and the
    port's merge equals the reference's."""
    jcfg, tcfg = jas.AppSuiteConfig(groups=16), tas.AppSuiteConfig(groups=16)
    rng = np.random.default_rng(13)
    n = 4096
    cols = _cols(rng, n)
    mask = np.ones(n, bool)
    h = n // 2
    half = [({k: v[s] for k, v in cols.items()}, mask[s])
            for s in (slice(None, h), slice(h, None))]
    single = tas.update(tas.init(tcfg, "cpu"), _t(cols),
                        torch.from_numpy(mask), tcfg)
    lo, hi = (tas.update(tas.init(tcfg, "cpu"), _t(c), torch.from_numpy(m),
                         tcfg) for c, m in half)
    merged = tas.merge(lo, hi)
    for a, b in zip(convert.app_to_numpy(single),
                    convert.app_to_numpy(merged)):
        np.testing.assert_array_equal(a, b)
    jlo, jhi = (jas.update(jas.init(jcfg), _j(c), jnp.asarray(m), jcfg)
                for c, m in half)
    _assert_state_equal(merged, jas.merge(jlo, jhi))


def test_convert_round_trip():
    """Reference state -> port -> reference leaves, bit-equal, both ways;
    a leaf that is not whole counts is refused."""
    jcfg, tcfg = jas.AppSuiteConfig(groups=32), tas.AppSuiteConfig(groups=32)
    rng = np.random.default_rng(14)
    cols = _cols(rng, 2048)
    mask = jnp.ones(2048, jnp.bool_)
    js = jax.device_get(jas.update(jas.init(jcfg), _j(cols), mask, jcfg))
    ts = convert.app_from_numpy(js, device="cpu")
    assert all(t.dtype == torch.int32 for t in
               (ts.requests, ts.errors, ts.rrt.hist, ts.rrt.zeros))
    back = convert.app_to_numpy(ts)
    _assert_state_equal(ts, js)
    again = convert.app_from_numpy(back, device="cpu")
    for a, b in zip(convert.app_to_numpy(again), back):
        np.testing.assert_array_equal(a, b)
    # the flat leaf list in the reference's order works too, and a state
    # built from it keeps accumulating in place
    flat = [np.asarray(x) for x in jax.tree_util.tree_leaves(js)]
    ts2 = convert.app_from_numpy(flat, device="cpu")
    req = ts2.requests
    tas.update(ts2, _t(cols), torch.ones(2048, dtype=torch.bool), tcfg)
    assert ts2.requests is req and int(req.sum()) == 2 * 2048
    bad = list(back)
    bad[0] = bad[0] + np.float32(0.5)
    with pytest.raises(ValueError):
        convert.app_from_numpy(bad, device="cpu")
    with pytest.raises(ValueError):
        convert.app_from_numpy([b.astype(np.float64) for b in back],
                               device="cpu")


def test_init_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        tas.init(tas.AppSuiteConfig(groups=8))
    assert tdd.init(tdd.DDSketchConfig(groups=2), "cpu").hist.shape == (2, 512)
