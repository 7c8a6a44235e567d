"""The sharded metrics suite at entropy cells that wrap mod 2^32.

Each suite merges its shards' int32 entropy histograms by an int32 sum
(the port's `sharded._sum`, the reference's `psum`), which wraps. Two
windows of 2^17 Documents, every one at one victim (ip, server_port)
with packet_tx + packet_rx fixed, put the merged victim cell at 24,576 x
2^17 = 3,221,225,472 (in [2^31, 2^32): negative as int32) and at 40,000
x 2^17 = 5,242,880,000 (past 2^32).

- On the scatter path (per-shard lanes below `mxu_hist.MIN_LANES`) both
  packages add exactly in int32 at any cell size: the port's 4-shard
  suite against the JAX 4-shard suite on the forced CPU devices, every
  METRICS_LEAVES leaf after every update and flush, the entropies, z
  scores and alarm.
- On the histogram path (8192 lanes a shard) the port alone: 4 shards
  against 1 shard fed 32768 lanes a batch against the plain suite, the
  int32 bits of the histograms and the entropies equal. Not held
  against JAX: the reference's `mxu_hist.hist` accumulates a batch in
  float32, exact only below 2^24 a batch cell.

In both, the merged victim cell equals rows x weight mod 2^32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflow_tpu.models import metrics_suite as jms
from deepflow_tpu.parallel import sharded as jsh
from deepflow_tpu.parallel.mesh import make_mesh as jmake_mesh
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.models import metrics_suite
from deepflow_tpu_torch.ops import cuda_hist, mxu_hist
from deepflow_tpu_torch.parallel import ShardedMetricsSuite, make_mesh
from deepflow_tpu_torch.parallel import sharded

F32 = dict(rtol=1e-5, atol=1e-6)
CFG_KW = dict(entropy_log2_buckets=8, mp_length=16, mp_m=4)
SHARDS = 4
ROWS = 1 << 17                      # Documents per window
WEIGHTS = (24_576, 40_000)          # packet_tx + packet_rx per window
VICTIM_IP, VICTIM_PORT = 0xAC10BEEF, 80


def _wrap_windows(rng):
    """Per weight, ROWS Documents at the victim whose packet_tx +
    packet_rx is that weight (split at random); the other signals
    uniform below a per-window level."""
    out = []
    for weight in WEIGHTS:
        cols = {"ip": np.full(ROWS, VICTIM_IP, np.uint32),
                "server_port": np.full(ROWS, VICTIM_PORT, np.uint32)}
        for s in metrics_suite.GOLDEN_SIGNALS:
            level = int(10 ** rng.uniform(0.5, 4.5))
            cols[s] = rng.integers(0, level, ROWS).astype(np.uint32)
        tx = rng.integers(0, weight + 1, ROWS).astype(np.uint32)
        cols["packet_tx"], cols["packet_rx"] = tx, np.uint32(weight) - tx
        out.append(cols)
    return out


def _batches(cols, n):
    return [{k: v[s:s + n] for k, v in cols.items()}
            for s in range(0, ROWS, n)]


def _victim_cells(hist, weight):
    """Both features' only non-zero cell of a merged int32 [2, buckets]
    histogram, against rows x weight mod 2^32."""
    want = ROWS * weight % (1 << 32)
    assert want >= 1 << 31 or ROWS * weight >= 1 << 32
    u = np.asarray(hist, np.int32).view(np.uint32)
    for f, row in enumerate(u):
        nz = np.flatnonzero(row)
        assert len(nz) == 1 and int(row[nz[0]]) == want, (f, weight, nz,
                                                          row[nz])


def _merged(states):
    """The port's merge of its shards' histograms, as its flush runs it."""
    return sharded._sum([s.ent.hist for s in states]).numpy()


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the histogram path's calls (the kernel's plain version on
    the CPU)."""
    calls = []
    real = cuda_hist.hist_add_plain

    def spy(acc, idx, *a, **k):
        calls.append(tuple(idx.shape))
        return real(acc, idx, *a, **k)

    monkeypatch.setattr(cuda_hist, "hist_add_plain", spy)
    return calls


def _jleaves(js):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.device_get(js))]


def _assert_leaves(got, want, ctx):
    spec = convert.METRICS_LEAVES
    assert len(got) == len(want) == len(spec), ctx
    for (path, dt), a, b in zip(spec, got, want):
        assert a.dtype == b.dtype == np.dtype(dt), (ctx, path)
        assert a.shape == b.shape, (ctx, path)
        if path == "pca.w":
            for d in range(a.shape[0]):
                np.testing.assert_allclose(
                    a[d].astype(np.float64) @ a[d].T,
                    b[d].astype(np.float64) @ b[d].T, atol=1e-5,
                    err_msg=f"{ctx} {path}[{d}]")
        elif np.dtype(dt).kind == "f":
            np.testing.assert_allclose(a, b, err_msg=f"{ctx} {path}", **F32)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{ctx} {path}")


def test_wrap_windows_match_jax_on_the_scatter_path(plain_calls):
    batch = SHARDS * (mxu_hist.MIN_LANES // 2)
    suite = ShardedMetricsSuite(metrics_suite.MetricsSuiteConfig(**CFG_KW),
                                make_mesh(SHARDS, device="cpu"))
    jsuite = jsh.ShardedMetricsSuite(jms.MetricsSuiteConfig(**CFG_KW),
                                     jmake_mesh(SHARDS))
    ts, js = suite.init(), jsuite.init()
    mask = np.ones(batch, bool)
    for w, (cols, weight) in enumerate(zip(_wrap_windows(
            np.random.default_rng(41)), WEIGHTS)):
        parts = _batches(cols, batch)
        for i, part in enumerate(parts):
            ts = suite.update(ts, *suite.put_batch(part, mask))
            js = jsuite.update(js, *jsuite.put_batch(
                {k: jnp.asarray(v) for k, v in part.items()},
                jnp.asarray(mask)))
            _assert_leaves(convert.sharded_to_numpy(ts), _jleaves(js),
                           f"w{w} b{i}")
        stacked = np.asarray(js.ent.hist)
        assert stacked.max() < 1 << 31      # no shard's cell wraps alone
        merged = _merged(ts)
        np.testing.assert_array_equal(           # the psum's int32 sum
            merged, np.sum(stacked, axis=0, dtype=np.int32))
        _victim_cells(merged, weight)
        last = parts[-1]
        ts, tout = suite.flush(ts, *suite.put_batch(last, mask))
        js, jout = jsuite.flush(js, *jsuite.put_batch(
            {k: jnp.asarray(v) for k, v in last.items()}, jnp.asarray(mask)))
        np.testing.assert_allclose(tout.entropies.numpy(),
                                   np.asarray(jout.entropies), rtol=2.4e-7)
        np.testing.assert_allclose(tout.z_scores.numpy(),
                                   np.asarray(jout.z_scores), **F32)
        assert bool(tout.ddos_alarm) == bool(jout.ddos_alarm), w
        _assert_leaves(convert.sharded_to_numpy(ts), _jleaves(js),
                       f"fresh {w}")
    assert plain_calls == []                # every shard took the scatter


def test_wrap_windows_hist_path_shards_equal_one_and_plain(plain_calls):
    cfg = metrics_suite.MetricsSuiteConfig(**CFG_KW)
    batch = SHARDS * mxu_hist.MIN_LANES
    wide = ShardedMetricsSuite(cfg, make_mesh(SHARDS, device="cpu"))
    one = ShardedMetricsSuite(cfg, make_mesh(1, device="cpu"))
    s4, s1 = wide.init(), one.init()
    plain = metrics_suite.init(cfg, "cpu")
    mask = np.ones(batch, bool)
    tmask = torch.from_numpy(mask)
    for w, (cols, weight) in enumerate(zip(_wrap_windows(
            np.random.default_rng(43)), WEIGHTS)):
        parts = _batches(cols, batch)
        for part in parts:
            s4 = wide.update(s4, *wide.put_batch(part, mask))
            s1 = one.update(s1, *one.put_batch(part, mask))
            plain = metrics_suite.update(
                plain, {k: torch.from_numpy(v.view(np.int32))
                        for k, v in part.items()}, tmask, cfg)
        merged = _merged(s4)
        np.testing.assert_array_equal(merged, s1[0].ent.hist.numpy())
        np.testing.assert_array_equal(merged, plain.ent.hist.numpy())
        _victim_cells(merged, weight)
        last = {k: torch.from_numpy(v.view(np.int32))
                for k, v in parts[-1].items()}
        s4, out4 = wide.flush(s4, *wide.put_batch(parts[-1], mask))
        s1, out1 = one.flush(s1, *one.put_batch(parts[-1], mask))
        plain, outp = metrics_suite.flush(plain, last, tmask, cfg)
        for out in (out4, out1):
            np.testing.assert_array_equal(out.entropies.numpy(),
                                          outp.entropies.numpy())
            np.testing.assert_array_equal(out.z_scores.numpy(),
                                          outp.z_scores.numpy())
            assert bool(out.ddos_alarm) == bool(outp.ddos_alarm)
    # 4 shards, 1 shard and the plain suite each took the histogram path
    per_window = len(range(0, ROWS, batch))
    shapes = sorted(set(plain_calls))
    assert shapes == [(2, mxu_hist.MIN_LANES), (2, batch)], shapes
    assert len(plain_calls) == 2 * per_window * (SHARDS + 2)
