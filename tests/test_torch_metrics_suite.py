"""The port's metrics suite against the JAX package's, on the CPU.

Every function of `metrics_suite` on the same numpy batches, with u32
columns of 2^31 and above, packet sums that wrap past 2^32 (and read as
negative int32) and sums past 65535 (saturated at 2 weight planes), on
the scatter path (n < 8192) and the histogram path (n >= 8192):

- `init`: every leaf equal, the PCA basis by its projector;
- `raw_signals` exact, `signal_matrix` and `window_sum` within rtol 1e-6;
- `entropy_update`: the histograms exact;
- `update` and `flush` over 18 windows with a destination concentration
  step at window 12, at an EWMA rate that warms up inside 10 windows, so
  the `windows > 10` branch runs and the alarm fires at the step and
  not before: `ddos_alarm` exact and entropies within one float32 ulp
  (rtol 2.4e-7: the two packages sum p log p in different orders; the
  histograms behind them are exact) at every window; z-scores and
  anomaly scores within rtol 1e-5; the state's integer leaves exact and
  its float leaves within rtol 1e-5, the PCA basis by its projector;
- the matrix-profile scores (8-window subsequences, warm from window
  15) within rtol 1e-4, the reference's own tolerance between its
  8-device and 1-device suites. On bit-identical rings the two packages'
  float32 scores differ by up to ~2e-5 (a difference of near-equal
  products, summed in different orders), so 1e-5 does not hold;
- `convert`'s metrics leaves both ways.

Per-batch histogram cell sums stay below 2^24, inside which the
reference's float32 histogram is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflow_tpu.models import metrics_suite as jms
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.models import metrics_suite as tms

F32 = dict(rtol=1e-5, atol=1e-6)
ULP = 2.4e-7      # one float32 ulp, relative (2^-22 covers the worst case)
MP_TOL = dict(rtol=1e-4, atol=1e-5)
CFG_KW = dict(entropy_log2_buckets=8, ewma_alpha=0.3, mp_length=32, mp_m=8)
CFG, JCFG = tms.MetricsSuiteConfig(**CFG_KW), jms.MetricsSuiteConfig(**CFG_KW)


def _bits(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _batch(rng, n, victim=False, edges=True, level=10_000):
    """One METRIC_SCHEMA batch of u32 columns, signals below `level`.
    With `edges` some rows hold values >= 2^31, packet sums wrapping past
    2^32 and sums past 65535; with `victim` every row targets one
    (ip, port)."""
    cols = {
        "ip": rng.integers(0, 3000, n).astype(np.uint32),
        "server_port": rng.choice([53, 80, 443, 3306, 8080], n).astype(
            np.uint32),
    }
    if np.isscalar(level):
        level = {s: level for s in tms.GOLDEN_SIGNALS}
    for s in tms.GOLDEN_SIGNALS:
        cols[s] = rng.integers(0, level[s], n).astype(np.uint32)
    # cell sums stay below 2^24
    for s in ("packet_tx", "packet_rx"):
        cols[s] = rng.integers(0, min(level[s], 800), n).astype(np.uint32)
    if victim:
        cols["ip"][:] = 0xAC10BEEF
        cols["server_port"][:] = 80
        cols["packet_tx"] = rng.integers(90, 100, n).astype(np.uint32)
        cols["packet_rx"][:] = 0
    elif edges:
        k = max(n // 64, 4)
        rows = rng.choice(n, 3 * k, replace=False)
        wrap, big, high = rows[:k], rows[k:2 * k], rows[2 * k:]
        # u32 sums that wrap past 2^32, some to >= 2^31 as int32 bits
        cols["packet_tx"][wrap] = rng.integers(0xF0000000, 0xFFFFFFFF, k,
                                               dtype=np.uint64)
        cols["packet_rx"][wrap] = rng.integers(0x10000000, 0x20000000, k)
        # past 65535, and past 2^31 without wrapping
        cols["packet_tx"][big[:k // 2]] = rng.integers(70_000, 1 << 20,
                                                       k // 2)
        cols["packet_tx"][big[k // 2:]] = 0x80000005
        cols["packet_rx"][big[k // 2:]] = 3
        for s in ("byte_tx", "rtt_sum"):
            cols[s][high] = rng.integers(1 << 31, 1 << 32, k,
                                         dtype=np.uint64)
    return cols


def _jcols(cols):
    return {k: jnp.asarray(v) for k, v in cols.items()}


def _tcols(cols):
    return {k: _bits(v) for k, v in cols.items()}


def _jleaves(js):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.device_get(js))]


def _assert_state_close(ts, js):
    got, want = convert.metrics_to_numpy(ts), _jleaves(js)
    assert len(got) == len(want) == len(convert.METRICS_LEAVES)
    for (path, dt), a, b in zip(convert.METRICS_LEAVES, got, want):
        assert a.dtype == b.dtype == np.dtype(dt), path
        assert a.shape == b.shape, path
        if path == "pca.w":
            np.testing.assert_allclose(a.astype(np.float64) @ a.T,
                                       b.astype(np.float64) @ b.T,
                                       atol=1e-5, err_msg=path)
        elif np.dtype(dt).kind == "f":
            np.testing.assert_allclose(a, b, err_msg=path, **F32)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)


def _seeded():
    """The JAX suite's fresh state and the port's copy of it."""
    js = jms.init(JCFG)
    return js, convert.metrics_from_numpy(jax.device_get(js), device="cpu")


def test_init_matches_jax():
    js = jms.init(JCFG)
    _assert_state_close(tms.init(CFG, device="cpu"), js)


def test_convert_round_trip():
    js, ts = _seeded()
    leaves = convert.metrics_to_numpy(ts)
    back = convert.metrics_from_numpy(leaves, device="cpu")
    for a, b in zip(convert.metrics_to_numpy(back), _jleaves(js)):
        np.testing.assert_array_equal(a, b)
    assert leaves[0] is not convert.metrics_to_numpy(ts)[0]


@pytest.mark.parametrize("n", [2048, 8192])
def test_signals_and_entropy_update_match_jax(n):
    rng = np.random.default_rng(n)
    cols = _batch(rng, n)
    mask = np.arange(n) < n - 37
    jc, tc = _jcols(cols), _tcols(cols)
    np.testing.assert_array_equal(tms.raw_signals(tc).numpy(),
                                  np.asarray(jms.raw_signals(jc)))
    assert tms.raw_signals(tc).max() >= 2 ** 31
    np.testing.assert_allclose(tms.signal_matrix(tc).numpy(),
                               np.asarray(jms.signal_matrix(jc)), rtol=1e-6)
    np.testing.assert_allclose(
        tms.window_sum(tc, torch.from_numpy(mask)).numpy(),
        np.asarray(jms.window_sum(jc, jnp.asarray(mask))), rtol=1e-6)
    js, ts = _seeded()
    jent = jms.entropy_update(js.ent, jc, jnp.asarray(mask))
    tent = tms.entropy_update(ts.ent, tc, torch.from_numpy(mask))
    assert tent.hist is ts.ent.hist                # in place
    np.testing.assert_array_equal(tent.hist.numpy(), np.asarray(jent.hist))
    # the wrapped sums came out negative as int32 and added their low
    # 16 bits, like every other sum past 65535
    pk = cols["packet_tx"].astype(np.uint64) + cols["packet_rx"]
    assert ((pk % (1 << 32)) >= 1 << 31).any() and (pk >= 1 << 32).any()
    assert (pk > 0xFFFF).sum() >= 3


def test_update_flush_18_windows_match_jax_and_alarm_fires():
    rng = np.random.default_rng(7)
    js, ts = _seeded()
    jup = jax.jit(lambda s, c, m: jms.update(s, c, m, JCFG))
    jfl = jax.jit(lambda s, c, m: jms.flush(s, c, m, JCFG))
    alarms = []
    for w in range(18):
        # window sums that vary at random by orders of magnitude: the
        # matrix-profile distance of a near-constant (or repeating) series
        # is a difference of near-equal float32 products, ill-conditioned
        # in either package (so the u32 edges, which would dominate every
        # sum, ride the scored batch only)
        level = {s: int(10 ** rng.uniform(0.5, 4.5))
                 for s in tms.GOLDEN_SIGNALS}
        for b, n in enumerate((2048, 8192)):
            cols = _batch(rng, n, victim=w >= 12, edges=False, level=level)
            mask = np.arange(n) < n - 11 * b
            js = jup(js, _jcols(cols), jnp.asarray(mask))
            ts = tms.update(ts, _tcols(cols), torch.from_numpy(mask), CFG)
        last = _batch(rng, 1024, victim=w >= 12, level=level)
        mask = np.arange(1024) < 1000
        _assert_state_close(ts, js)
        js, jout = jfl(js, _jcols(last), jnp.asarray(mask))
        ts, tout = tms.flush(ts, _tcols(last), torch.from_numpy(mask), CFG)
        _assert_state_close(ts, js)
        # the histograms behind them are exact (the state check above);
        # XLA and ATen sum p log p in float32 in different orders, one
        # ulp apart at the concentration step
        np.testing.assert_allclose(tout.entropies.numpy(),
                                   np.asarray(jout.entropies), rtol=ULP)
        assert bool(tout.ddos_alarm) == bool(jout.ddos_alarm), w
        np.testing.assert_allclose(tout.z_scores.numpy(),
                                   np.asarray(jout.z_scores), **F32)
        np.testing.assert_allclose(tout.anomaly_scores.numpy(),
                                   np.asarray(jout.anomaly_scores), **F32)
        np.testing.assert_allclose(tout.mp_scores.numpy(),
                                   np.asarray(jout.mp_scores), **MP_TOL)
        assert (tout.anomaly_scores.numpy()[1000:] == 0).all()
        alarms.append(bool(tout.ddos_alarm))
    assert alarms[:12] == [False] * 12 and alarms[12], alarms
    assert (tout.mp_scores.numpy() > 0).all()
    assert int(ts.windows) == 18
