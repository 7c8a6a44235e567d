"""The port's multi-device layer on the CPU: `make_mesh`, the three
sharded suites, and the flow_dict overrides they use.

- One test for each of the reference's `tests/test_sharded.py` cases:
  mesh size and multi-axis factoring, 8-shard merge equals one device,
  top-K recall against an exact GROUP BY, metrics 8 shards against 1
  against the plain suite, app equals one device, plane equals cols, and
  the dict lane equals one device.
- The port's 8-shard suites against the JAX suites on the 8-device CPU
  mesh (tests/conftest.py) with the same batches: the stacked states leaf
  by leaf through `convert.sharded_to_numpy` after every update, and
  every flush output, for all four flow forms (cols, full-row plane,
  lanes, dict), the app suite and the metrics suite. Integer leaves and
  outputs exact, float leaves within rtol 1e-5 (atol 1e-6), the PCA
  basis by its projector; the merged ring's composition against the
  reference's `_dedup_keep_max` + `lax.top_k`. The metrics suite also
  over 18 windows at a warm configuration, where the alarm fires at a
  concentration step and the matrix profile scores the merged window
  sums (rtol 1e-4).
- An attached ShadowAuditor against the JAX suite's, snapshot dict
  equal.
- No two shards share storage: after an update of one shard only, every
  other shard is unchanged (after `init`, `init_dict` and `flush`).
- `flow_dict.update_news(count_mask=)` and `update_hits(mask=)` against
  the JAX functions.

The port's shards all live on the CPU here (shard d on devices[d % 1]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflow_tpu.models import app_suite as japp
from deepflow_tpu.models import flow_dict as jfd
from deepflow_tpu.models import flow_suite as jfs
from deepflow_tpu.models import metrics_suite as jms
from deepflow_tpu.ops import topk as jtopk
from deepflow_tpu.parallel import sharded as jsh
from deepflow_tpu.parallel.mesh import make_mesh as jmake_mesh
from deepflow_tpu.runtime.audit import ShadowAuditor as JAuditor
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.batch.batcher import SKETCH_L4_SCHEMA
from deepflow_tpu_torch.models import app_suite, flow_dict, flow_suite
from deepflow_tpu_torch.models import metrics_suite
from deepflow_tpu_torch.ops import topk
from deepflow_tpu_torch.parallel import (ShardedAppSuite, ShardedFlowSuite,
                                         ShardedMetricsSuite, make_mesh)
from deepflow_tpu_torch.parallel import sharded
from deepflow_tpu_torch.runtime.audit import ShadowAuditor
from deepflow_tpu_torch.utils.u32 import fold_columns_np

F32 = dict(rtol=1e-5, atol=1e-6)
_SMALL = dict(cms_log2_width=12, ring_size=256, hll_groups=64,
              hll_precision=8, entropy_log2_buckets=10)
CFG, JCFG = flow_suite.FlowSuiteConfig(**_SMALL), jfs.FlowSuiteConfig(**_SMALL)
KEYS = ("ip_src", "ip_dst", "port_src", "port_dst", "proto", "packet_tx",
        "packet_rx")
B = 4096


def _mesh8():
    return make_mesh(8, device="cpu")


def _records(rng, n, pool=700):
    """n l4 records by Zipf(1.1) over a pool of 5-tuples, some u32 words
    of 2^31 and above; per-batch cell sums stay below 2^24."""
    base = {
        "ip_src": rng.integers(0, 1 << 32, pool, dtype=np.uint64),
        "ip_dst": rng.integers(0, 1 << 32, pool, dtype=np.uint64),
        "port_src": rng.integers(1024, 1 << 16, pool),
        "port_dst": rng.choice([53, 80, 443, 3306, 8080], pool),
        "proto": rng.choice([6, 17], pool),
    }
    pick = (rng.zipf(1.1, n) - 1).clip(max=pool - 1)
    cols = {k: v[pick].astype(np.uint32) for k, v in base.items()}
    cols["packet_tx"] = rng.integers(0, 1000, n).astype(np.uint32)
    cols["packet_rx"] = rng.integers(0, 1000, n).astype(np.uint32)
    return cols


def _jleaves(js):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.device_get(js))]


def _assert_leaves(got, want, spec, ctx=""):
    """Stacked leaves: integers exact, floats within F32, the PCA basis
    of every shard by its projector."""
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


def _assert_flow_out(tout, jout, ctx=""):
    np.testing.assert_array_equal(tout.topk_keys.numpy().view(np.uint32),
                                  np.asarray(jout.topk_keys), err_msg=ctx)
    for name in ("topk_counts", "rows"):
        np.testing.assert_array_equal(getattr(tout, name).numpy(),
                                      np.asarray(getattr(jout, name)),
                                      err_msg=f"{ctx} {name}")
    for name in ("service_cardinality", "entropies"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   err_msg=f"{ctx} {name}", **F32)


def _flow_key(cols):
    return fold_columns_np([cols[k] for k in KEYS[:5]])


# -- the reference's tests/test_sharded.py, on the port ----------------------

def test_mesh_has_8_shards():
    mesh = _mesh8()
    assert mesh.shape["data"] == 8 and mesh.devices.size == 8
    assert mesh.axis_devices("data") == (torch.device("cpu"),) * 8
    assert make_mesh(device="cpu").shape == {"data": 1}


def test_mesh_multi_axis_factoring():
    mesh = make_mesh(8, axes=("replica", "data"), device="cpu")
    assert mesh.shape == {"replica": 2, "data": 4}
    assert len(mesh.axis_devices("data")) == 4
    assert len(mesh.axis_devices("replica")) == 2
    mesh = make_mesh(6, axes=("replica", "data"), device="cpu")
    assert mesh.shape == {"replica": 2, "data": 3}
    for n, axes in ((8, ("replica", "data")), (6, ("replica", "data")),
                    (8, ("a", "b", "c")), (7, ("a", "b"))):
        assert make_mesh(n, axes, device="cpu").shape == \
            dict(jmake_mesh(n, axes).shape)


def test_sharded_merge_equals_single_device():
    """Linear sketches: 8-way sharded update + merge == one device."""
    rng = np.random.default_rng(1)
    suite = ShardedFlowSuite(CFG, _mesh8())
    state = suite.init()
    single = flow_suite.init(CFG, "cpu")
    for _ in range(3):
        cols = _records(rng, B)
        mask = np.ones(B, bool)
        state = suite.update(state, *suite.put_batch(cols, mask))
        single = flow_suite.update(
            single, {k: torch.from_numpy(v.view(np.int32))
                     for k, v in cols.items()}, torch.from_numpy(mask), CFG)
    merged = sharded._merge_axis0(state)
    for a, b in zip(convert.state_to_numpy(merged)[:2],
                    convert.state_to_numpy(single)[:2]):
        np.testing.assert_array_equal(a, b)       # CMS counts and seeds
    np.testing.assert_array_equal(merged.services.registers.numpy(),
                                  single.services.registers.numpy())
    np.testing.assert_array_equal(merged.ent.hist.numpy(),
                                  single.ent.hist.numpy())
    state, out = suite.flush(state)
    single, want = flow_suite.flush(single, CFG)
    assert int(out.rows) == int(want.rows) == 3 * B
    np.testing.assert_allclose(out.service_cardinality.numpy(),
                               want.service_cardinality.numpy(), rtol=1e-5)
    np.testing.assert_allclose(out.entropies.numpy(),
                               want.entropies.numpy(), atol=1e-5)
    got = set(out.topk_keys.numpy()[:50].tolist())
    assert len(got & set(want.topk_keys.numpy()[:50].tolist())) / 50 >= 0.9


def test_sharded_topk_recall_vs_exact():
    cfg = flow_suite.FlowSuiteConfig(cms_log2_width=14, ring_size=1024,
                                     top_k=20, hll_groups=64,
                                     hll_precision=8)
    rng = np.random.default_rng(2)
    suite = ShardedFlowSuite(cfg, _mesh8())
    state = suite.init()
    batches = [_records(rng, 8192) for _ in range(4)]
    for cols in batches:
        state = suite.update(state, *suite.put_batch(cols,
                                                     np.ones(8192, bool)))
    state, out = suite.flush(state)
    keys = np.concatenate([_flow_key(c) for c in batches])
    uniq, counts = np.unique(keys, return_counts=True)
    want = set(uniq[np.argsort(-counts, kind="stable")[:20]].tolist())
    got = set(out.topk_keys.numpy().view(np.uint32).tolist())
    assert len(got & want) / 20 >= 0.95
    _, out2 = suite.flush(state)                  # the flush left it clean
    assert int(out2.rows) == 0


def _metric_batch(rng, n):
    cols = {f: rng.integers(0, 500, n).astype(np.uint32)
            for f in metrics_suite.ENTROPY_FEATURES}
    for s in metrics_suite.GOLDEN_SIGNALS:
        cols[s] = rng.integers(0, 10_000, n).astype(np.uint32)
    return cols


def _tcols(cols):
    return {k: torch.from_numpy(v.view(np.int32)) for k, v in cols.items()}


def test_sharded_metrics_suite_equals_one_device():
    """8 shards (entropy merged at flush, PCA terms summed every update)
    equal one shard and the plain suite, at the reference's tolerances."""
    cfg = metrics_suite.MetricsSuiteConfig(entropy_log2_buckets=8)
    wide = ShardedMetricsSuite(cfg, _mesh8())
    one = ShardedMetricsSuite(cfg, make_mesh(1, device="cpu"))
    s8, s1 = wide.init(), one.init()
    plain = metrics_suite.init(cfg, "cpu")
    rng = np.random.default_rng(3)
    n = 2048
    mask = np.ones(n, bool)
    for _ in range(3):
        cols = _metric_batch(rng, n)
        s8 = wide.update(s8, *wide.put_batch(cols, mask))
        s1 = one.update(s1, *one.put_batch(cols, mask))
        plain = metrics_suite.update(plain, _tcols(cols),
                                     torch.from_numpy(mask), cfg)
    last = _metric_batch(rng, n)
    s8, out8 = wide.flush(s8, *wide.put_batch(last, mask))
    s1, out1 = one.flush(s1, *one.put_batch(last, mask))
    plain, outp = metrics_suite.flush(plain, _tcols(last),
                                      torch.from_numpy(mask), cfg)
    np.testing.assert_array_equal(outp.entropies.numpy(),
                                  out1.entropies.numpy())
    np.testing.assert_allclose(plain.pca.w.numpy(), s1[0].pca.w.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outp.anomaly_scores.numpy(),
                               out1.anomaly_scores.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out8.entropies.numpy(),
                                  out1.entropies.numpy())
    np.testing.assert_allclose(out8.z_scores.numpy(), out1.z_scores.numpy(),
                               rtol=1e-5)
    assert bool(out8.ddos_alarm) == bool(out1.ddos_alarm)
    w8 = [s.pca.w for s in s8]
    for d in range(1, 8):                       # replicated bit for bit
        assert torch.equal(w8[d], w8[0])
    np.testing.assert_allclose(w8[0].numpy(), s1[0].pca.w.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out8.anomaly_scores.numpy(),
                               out1.anomaly_scores.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(outp.mp_scores.numpy(),
                               out1.mp_scores.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out8.mp_scores.numpy(),
                               out1.mp_scores.numpy(), rtol=1e-4, atol=1e-5)
    for d in range(1, 8):
        assert torch.equal(s8[d].mp.ring, s8[0].mp.ring)


def _app_cols(rng, n):
    return {
        "ip_dst": rng.integers(0, 1 << 16, n).astype(np.uint32),
        "port_dst": rng.integers(0, 1024, n).astype(np.uint32),
        "protocol": np.full(n, 6, np.uint32),
        "status": np.where(rng.random(n) < 0.2, 500, 200).astype(np.uint32),
        "rrt_us": rng.integers(1, 100_000, n).astype(np.uint32),
    }


APP_CFG = app_suite.AppSuiteConfig(groups=16, dd_buckets=128, dd_alpha=0.05)
JAPP_CFG = japp.AppSuiteConfig(groups=16, dd_buckets=128, dd_alpha=0.05)


def test_sharded_app_suite_matches_single():
    rng = np.random.default_rng(21)
    n = 512
    cols, mask = _app_cols(rng, n), np.ones(n, bool)
    single = app_suite.update(app_suite.init(APP_CFG, "cpu"), _tcols(cols),
                              torch.from_numpy(mask), APP_CFG)
    _, want = app_suite.flush(single, APP_CFG)
    suite = ShardedAppSuite(APP_CFG, _mesh8())
    state = suite.update(suite.init(), *suite.put_batch(cols, mask))
    state, out = suite.flush(state)
    for a, b in zip(out, want):
        assert torch.equal(a, b)


def _full_plane(cols):
    n = len(cols["ip_src"])
    return np.stack([cols[name].astype(dt).view(np.uint32)
                     if name in cols else np.zeros(n, np.uint32)
                     for name, dt in SKETCH_L4_SCHEMA.columns])


def test_sharded_plane_update_equals_cols_update():
    rng = np.random.default_rng(4)
    suite = ShardedFlowSuite(CFG, _mesh8())
    s_cols, s_plane = suite.init(), suite.init()
    for _ in range(2):
        cols = _records(rng, B)
        mask = np.arange(B) < B - 40
        s_cols = suite.update(s_cols, *suite.put_batch(cols, mask))
        s_plane = suite.update_plane(s_plane,
                                     *suite.put_plane(_full_plane(cols), mask))
    for a, b in zip(convert.sharded_to_numpy(s_cols),
                    convert.sharded_to_numpy(s_plane)):
        np.testing.assert_array_equal(a, b)


def _wire(rng, batches=3, n=B):
    packer = flow_dict.FlowDictPacker(capacity=8192, hits_batch=4096,
                                      news_batch=512)
    wire = []
    for _ in range(batches):
        wire.extend(packer.pack(_records(rng, n)))
    return wire + packer.flush()


def test_sharded_dict_lane_matches_single_device():
    rng = np.random.default_rng(5)
    suite = ShardedFlowSuite(CFG, _mesh8())
    state, tables = suite.init(), suite.init_dict(capacity=8192)
    single = flow_suite.init(CFG, "cpu")
    sdict = flow_dict.init_dict(8192, "cpu")
    wire = _wire(rng)
    assert {k for k, _, _ in wire} == {"news", "hits"}
    for kind, plane, n in wire:
        p = torch.from_numpy(plane.view(np.int32))
        if kind == "news":
            state, tables = suite.update_news(state, tables, plane, n)
            single, sdict = flow_dict.update_news(single, sdict, p, n, CFG)
        else:
            state = suite.update_hits(state, tables, plane, n)
            single = flow_dict.update_hits(single, sdict, p, n, CFG)
    for t in tables:
        assert torch.equal(t.table, sdict.table)
    merged = sharded._merge_axis0(state)
    for path in ("sketch.counts", "services.registers", "ent.hist",
                 "rows_seen"):
        a, b = merged, single
        for part in path.split("."):
            a, b = getattr(a, part), getattr(b, part)
        assert torch.equal(a, b), path


# -- the port's sharded suites against the JAX sharded suites ----------------

@pytest.fixture(scope="module")
def jflow():
    return jsh.ShardedFlowSuite(JCFG, jmake_mesh(8))


def _jcols(cols):
    return {k: jnp.asarray(v) for k, v in cols.items()}


@pytest.mark.parametrize("form", ["cols", "plane", "lanes", "dict"])
def test_sharded_flow_suite_matches_jax(jflow, form):
    rng = np.random.default_rng({"cols": 10, "plane": 11, "lanes": 12,
                                 "dict": 13}[form])
    suite = ShardedFlowSuite(CFG, _mesh8())
    ts, js = suite.init(), jflow.init()
    _assert_leaves(convert.sharded_to_numpy(ts), _jleaves(js),
                   convert.SUITE_LEAVES, "init")
    tt = jt = None
    if form == "dict":
        tt, jt = suite.init_dict(capacity=8192), jflow.init_dict(8192)
    for w in range(2):
        if form == "dict":
            steps = _wire(rng, batches=2)
        else:
            steps = [_records(rng, B) for _ in range(2)]
        for i, step in enumerate(steps):
            if form == "cols":
                mask = np.arange(B) < B - 50 * i
                ts = suite.update(ts, *suite.put_batch(step, mask))
                js = jflow.update(js, *jflow.put_batch(_jcols(step),
                                                       jnp.asarray(mask)))
            elif form == "plane":
                mask = np.arange(B) < B - 50 * i
                plane = _full_plane(step)
                ts = suite.update_plane(ts, *suite.put_plane(plane, mask))
                js = jflow.update_plane(js, *jflow.put_plane(
                    jnp.asarray(plane), mask))
            elif form == "lanes":
                n = B - 333 * i
                lanes = flow_suite.pack_lanes(step)
                plane = np.stack([lanes[k]
                                  for k in flow_suite.SKETCH_LANE_NAMES])
                ts = suite.update_lanes(ts, suite.put_lanes(plane), n)
                js = jflow.update_lanes(js, jflow.put_lanes(
                    jnp.asarray(plane)), n)
            else:
                kind, plane, n = step
                if kind == "news":
                    ts, tt = suite.update_news(ts, tt, plane, n)
                    js, jt = jflow.update_news(js, jt, jnp.asarray(plane),
                                               np.uint32(n))
                else:
                    ts = suite.update_hits(ts, tt, plane, n)
                    js = jflow.update_hits(js, jt, jnp.asarray(plane),
                                           np.uint32(n))
            _assert_leaves(convert.sharded_to_numpy(ts), _jleaves(js),
                           convert.SUITE_LEAVES, f"{form} w{w} step {i}")
            if form == "dict":
                np.testing.assert_array_equal(
                    convert.sharded_to_numpy(tt)[0], np.asarray(jt))
        ts, tout = suite.flush(ts)
        js, jout = jflow.flush(js)
        _assert_flow_out(tout, jout, f"{form} window {w}")
        _assert_leaves(convert.sharded_to_numpy(ts), _jleaves(js),
                       convert.SUITE_LEAVES, f"{form} fresh {w}")


def test_sharded_app_suite_matches_jax():
    rng = np.random.default_rng(22)
    suite = ShardedAppSuite(APP_CFG, _mesh8())
    jsuite = jsh.ShardedAppSuite(JAPP_CFG, jmake_mesh(8))
    ts, js = suite.init(), jsuite.init()
    for w in range(2):
        for i in range(2):
            n = 1024
            cols, mask = _app_cols(rng, n), np.arange(n) < n - 24 * i
            cols["status"][:5] = [0x80000000, 99, 0, 404, 0xFFFFFFFF]
            cols["rrt_us"][5:8] = [0, 0x80000001, 0xFFFFFFFF]
            ts = suite.update(ts, *suite.put_batch(cols, mask))
            js = jsuite.update(js, *jsuite.put_batch(cols, mask))
            _assert_leaves(convert.sharded_to_numpy(ts), _jleaves(js),
                           convert.APP_LEAVES, f"w{w} b{i}")
        ts, tout = suite.flush(ts)
        js, jout = jsuite.flush(js)
        for name in ("requests", "errors", "rrt_hist", "rrt_zeros"):
            np.testing.assert_array_equal(
                getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                err_msg=name)
        for name in ("error_ratio", "rrt_quantiles"):
            np.testing.assert_allclose(
                getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                err_msg=name, **F32)
        _assert_leaves(convert.sharded_to_numpy(ts), _jleaves(js),
                       convert.APP_LEAVES, f"fresh {w}")


def test_sharded_metrics_suite_matches_jax():
    cfg_kw = dict(entropy_log2_buckets=8, ewma_alpha=0.3, mp_length=32,
                  mp_m=4)
    cfg = metrics_suite.MetricsSuiteConfig(**cfg_kw)
    suite = ShardedMetricsSuite(cfg, _mesh8())
    jsuite = jsh.ShardedMetricsSuite(jms.MetricsSuiteConfig(**cfg_kw),
                                     jmake_mesh(8))
    ts, js = suite.init(), jsuite.init()
    rng = np.random.default_rng(23)
    n = 2048
    for w in range(3):
        for i in range(2):
            cols, mask = _metric_batch(rng, n), np.arange(n) < n - 16 * i
            # u32 edges: wrapped packet sums, sums past 65535, 2^31 values
            cols["packet_tx"][:8] = 0xFFFFFFF0
            cols["packet_rx"][:8] = 0x20
            cols["packet_tx"][8:16] = 0x80000000
            cols["byte_tx"][16:24] = 0xFFFFFFFF
            ts = suite.update(ts, *suite.put_batch(cols, mask))
            js = jsuite.update(js, *jsuite.put_batch(_jcols(cols),
                                                     jnp.asarray(mask)))
            _assert_leaves(convert.sharded_to_numpy(ts), _jleaves(js),
                           convert.METRICS_LEAVES, f"w{w} b{i}")
        last, mask = _metric_batch(rng, n), np.arange(n) < n - 8
        ts, tout = suite.flush(ts, *suite.put_batch(last, mask))
        js, jout = jsuite.flush(js, *jsuite.put_batch(_jcols(last),
                                                      jnp.asarray(mask)))
        np.testing.assert_allclose(tout.entropies.numpy(),
                                   np.asarray(jout.entropies), rtol=2.4e-7)
        assert bool(tout.ddos_alarm) == bool(jout.ddos_alarm)
        for name in ("z_scores", "anomaly_scores", "mp_scores"):
            np.testing.assert_allclose(getattr(tout, name).numpy(),
                                       np.asarray(getattr(jout, name)),
                                       err_msg=name, **F32)
        _assert_leaves(convert.sharded_to_numpy(ts), _jleaves(js),
                       convert.METRICS_LEAVES, f"fresh {w}")
        for d in range(1, 8):
            assert torch.equal(ts[d].pca.w, ts[0].pca.w)


def _level_batch(rng, n, level, victim):
    """Metric Documents whose signals lie below a per-window `level`;
    with `victim` every row targets one (ip, port)."""
    cols = {"ip": rng.integers(0, 3000, n).astype(np.uint32),
            "server_port": rng.choice([53, 80, 443, 3306, 8080], n).astype(
                np.uint32)}
    for s in metrics_suite.GOLDEN_SIGNALS:
        cols[s] = rng.integers(0, level[s], n).astype(np.uint32)
    if victim:
        cols["ip"][:] = 0xAC10BEEF
        cols["server_port"][:] = 80
        cols["packet_tx"] = rng.integers(90, 100, n).astype(np.uint32)
        cols["packet_rx"][:] = 0
    return cols


def test_sharded_metrics_suite_warm_matches_jax():
    """18 windows at an EWMA rate that warms inside the 10 windows before
    the alarm may fire, with a destination concentration step at window
    12 and 8-window subsequences: the merged window sums are scored warm
    from window 15 and the alarm branch runs. Window sums spread over
    orders of magnitude (a near-constant series is ill-conditioned for
    the matrix profile in float32). Entropies within one float32 ulp,
    alarms exact, z and anomaly scores within F32, mp_scores within
    rtol 1e-4 (the reference's 8-against-1 tolerance; the two packages'
    float32 discord scores differ by up to ~2e-5 on identical rings)."""
    cfg_kw = dict(entropy_log2_buckets=8, ewma_alpha=0.3, mp_length=32,
                  mp_m=8)
    cfg = metrics_suite.MetricsSuiteConfig(**cfg_kw)
    suite = ShardedMetricsSuite(cfg, _mesh8())
    jsuite = jsh.ShardedMetricsSuite(jms.MetricsSuiteConfig(**cfg_kw),
                                     jmake_mesh(8))
    ts, js = suite.init(), jsuite.init()
    rng = np.random.default_rng(29)
    n = 2048
    alarms, mp = [], []
    for w in range(18):
        level = {s: int(10 ** rng.uniform(0.5, 4.5))
                 for s in metrics_suite.GOLDEN_SIGNALS}
        for i in range(2):
            cols = _level_batch(rng, n, level, w >= 12)
            mask = np.arange(n) < n - 16 * i
            ts = suite.update(ts, *suite.put_batch(cols, mask))
            js = jsuite.update(js, *jsuite.put_batch(_jcols(cols),
                                                     jnp.asarray(mask)))
        last, mask = _level_batch(rng, n, level, w >= 12), \
            np.arange(n) < n - 8
        ts, tout = suite.flush(ts, *suite.put_batch(last, mask))
        js, jout = jsuite.flush(js, *jsuite.put_batch(_jcols(last),
                                                      jnp.asarray(mask)))
        np.testing.assert_allclose(tout.entropies.numpy(),
                                   np.asarray(jout.entropies), rtol=2.4e-7)
        assert bool(tout.ddos_alarm) == bool(jout.ddos_alarm), w
        for name in ("z_scores", "anomaly_scores"):
            np.testing.assert_allclose(getattr(tout, name).numpy(),
                                       np.asarray(getattr(jout, name)),
                                       err_msg=f"{w} {name}", **F32)
        np.testing.assert_allclose(tout.mp_scores.numpy(),
                                   np.asarray(jout.mp_scores), rtol=1e-4,
                                   atol=1e-5, err_msg=f"{w} mp_scores")
        _assert_leaves(convert.sharded_to_numpy(ts), _jleaves(js),
                       convert.METRICS_LEAVES, f"fresh {w}")
        alarms.append(bool(tout.ddos_alarm))
        mp.append(tout.mp_scores.numpy())
    assert alarms[:12] == [False] * 12 and alarms[12], alarms
    assert all((m > 0).all() for m in mp[15:]), mp[15:]
    assert not any(m.any() for m in mp[:15])


def test_sharded_auditor_matches_jax(jflow):
    """An attached ShadowAuditor (per-shard attribution) mirrors the host
    batches before the split, skips the valid-masked padding, counts the
    batches already on a device, and closes against the merged window:
    the same snapshot dict as the JAX suite's auditor."""
    rng = np.random.default_rng(14)
    suite = ShardedFlowSuite(CFG, _mesh8())
    audits = (ShadowAuditor(CFG, rate=1.0, shards=8),
              JAuditor(JCFG, rate=1.0, shards=8))
    suite.attach_auditor(audits[0])
    jflow.attach_auditor(audits[1])
    try:
        ts, js = suite.init(), jflow.init()
        for i in range(2):
            cols, mask = _records(rng, B), np.arange(B) < B - 300 * i
            ts = suite.update(ts, *suite.put_batch(cols, mask))
            js = jflow.update(js, *jflow.put_batch(cols, mask))
        on_device = {k: torch.from_numpy(v.view(np.int32))
                     for k, v in cols.items()}
        suite.put_batch(on_device, torch.from_numpy(mask))
        jflow.put_batch(_jcols(cols), jnp.asarray(mask))
        assert suite.audit_device_skipped == jflow.audit_device_skipped == 1
        suite.flush(ts)
        jflow.flush(js)
    finally:
        jflow._auditor = None
    got, want = audits[0].last_window, audits[1].last_window
    assert got is not None and set(got) == set(want)
    assert got["rows"] == 2 * B - 300 and got["shard_sampled_rows"] == \
        want["shard_sampled_rows"]
    for k, b in want.items():
        if isinstance(b, float):
            # entropy_abs_error is |output - shadow|, ~1e-7 of float32
            # entropies computed in the two packages' sum orders
            np.testing.assert_allclose(got[k], b, err_msg=k, **F32)
        else:
            assert got[k] == b, (k, got[k], b)


def test_merge_ring_is_the_reference_composition():
    """`select_ring(sort_pairs(...))` (the port's merge) equals the
    reference's `_dedup_keep_max` + `lax.top_k` on rings with duplicate
    keys, tied counts, keys of 2^31 and above and empty slots; and the
    rescored ring equals the reference's `rescore_ring`."""
    rng = np.random.default_rng(6)
    pool = rng.integers(0, 1 << 32, 40, dtype=np.uint64).astype(np.uint32)
    keys = pool[rng.integers(0, 40, 8 * 32)]
    counts = rng.integers(0, 6, 8 * 32).astype(np.int32)
    empty = rng.random(8 * 32) < 0.3
    keys[empty], counts[empty] = 0xFFFFFFFF, -1
    k, c = jtopk._dedup_keep_max(jnp.asarray(keys), jnp.asarray(counts))
    top_c, top_i = jax.lax.top_k(c, 32)
    ring = topk.select_ring(*topk.sort_pairs(
        torch.from_numpy(keys.view(np.int32)), torch.from_numpy(counts)), 32)
    np.testing.assert_array_equal(ring.keys.numpy().view(np.uint32),
                                  np.asarray(k[top_i]))
    np.testing.assert_array_equal(ring.counts.numpy(), np.asarray(top_c))
    np.testing.assert_array_equal(
        topk._not_sentinel(torch.from_numpy(keys.view(np.int32))).numpy(),
        np.asarray(jtopk._not_sentinel(jnp.asarray(keys))))
    # the whole merge + rescore on stacked states
    js = jfs.init(JCFG)
    jstack = jax.tree.map(lambda x: jnp.stack([x] * 8), js)
    cms_counts = rng.integers(0, 9, (8,) + js.sketch.counts.shape).astype(
        np.int32)
    jstack = jstack._replace(
        sketch=jstack.sketch._replace(counts=jnp.asarray(cms_counts)),
        ring=jfs.topk.TopKState(keys=jnp.asarray(keys.reshape(8, 32)),
                                counts=jnp.asarray(counts.reshape(8, 32))))
    jm = jsh.rescore_ring(jsh._merge_axis0(jstack))
    tstack = convert.sharded_from_numpy(_jleaves(jstack), "flow",
                                        [torch.device("cpu")] * 8)
    tm = sharded.rescore_ring(sharded._merge_axis0(tstack))
    for (name, _), a, b in zip(convert.SUITE_LEAVES,
                               convert.state_to_numpy(tm), _jleaves(jm)):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_no_two_shards_share_storage():
    """Updating shard 0 alone leaves every other shard as it was, after
    init, init_dict and flush, in all three suites."""
    rng = np.random.default_rng(7)
    mesh = make_mesh(4, device="cpu")
    flow = ShardedFlowSuite(CFG, mesh)
    app = ShardedAppSuite(APP_CFG, mesh)
    met = ShardedMetricsSuite(metrics_suite.MetricsSuiteConfig(), mesh)

    def check(state, step):
        before = [[t.clone() for t in sharded.tree_leaves(s)] for s in state]
        state[0] = step(state[0])
        changed = any(not torch.equal(a, b) for a, b in zip(
            before[0], sharded.tree_leaves(state[0])))
        assert changed
        for d in range(1, len(state)):
            for a, b in zip(before[d], sharded.tree_leaves(state[d])):
                assert torch.equal(a, b), d

    cols = _tcols(_records(rng, 1024))
    mask = torch.ones(1024, dtype=torch.bool)
    for state in (flow.init(), flow.flush(flow.init())[0]):
        check(state, lambda s: flow_suite.update(s, cols, mask, CFG))
    acols = _tcols(_app_cols(rng, 256))
    amask = torch.ones(256, dtype=torch.bool)
    for state in (app.init(), app.flush(app.init())[0]):
        check(state, lambda s: app_suite.update(s, acols, amask, APP_CFG))
    mcols = _tcols(_metric_batch(rng, 256))
    mc, mm = met.put_batch({k: v.numpy().view(np.uint32)
                            for k, v in mcols.items()}, np.ones(256, bool))
    for state in (met.init(), met.flush(met.init(), mc, mm)[0]):
        check(state, lambda s: s._replace(ent=metrics_suite.entropy_update(
            s.ent, mcols, amask)))
    tables = flow.init_dict(capacity=1024)
    wire = _wire(rng, batches=1, n=512)
    kind, plane, n = next(w for w in wire if w[0] == "news")
    before = [t.table.clone() for t in tables]
    flow_dict.update_news(flow_suite.init(CFG, "cpu"), tables[0],
                          torch.from_numpy(plane.view(np.int32)), n, CFG)
    assert not torch.equal(tables[0].table, before[0])
    for d in range(1, 4):
        assert torch.equal(tables[d].table, before[d])


# -- the flow_dict overrides the sharded path uses ---------------------------

def test_update_news_count_mask_matches_jax():
    rng = np.random.default_rng(8)
    wire = _wire(rng, batches=1)
    kind, plane, n = next(w for w in wire if w[0] == "news")
    count = (np.arange(plane.shape[1]) < n) & (np.arange(plane.shape[1])
                                               % 3 == 1)
    js = jfs.init(JCFG)
    ts, td = convert.state_from_numpy(jax.device_get(js),
                                      jfd.init_dict(8192), device="cpu")
    js, jd = jfd.update_news(js, jfd.init_dict(8192), jnp.asarray(plane),
                             np.uint32(n), JCFG,
                             count_mask=jnp.asarray(count))
    cfg = flow_suite.FlowSuiteConfig(**_SMALL, fused_hists=True)
    ts, td = flow_dict.update_news(ts, td,
                                   torch.from_numpy(plane.view(np.int32)), n,
                                   cfg, count_mask=torch.from_numpy(count))
    for (name, _), a, b in zip(convert.SUITE_LEAVES,
                               convert.state_to_numpy(ts), _jleaves(js)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(td.table.numpy().view(np.uint32),
                                  np.asarray(jd.table))
    assert int(ts.rows_seen) == int(count.sum()) < n


def test_update_hits_mask_matches_jax():
    rng = np.random.default_rng(9)
    wire = _wire(rng, batches=2)
    js, jd = jfs.init(JCFG), jfd.init_dict(8192)
    ts, td = convert.state_from_numpy(jax.device_get(js), jax.device_get(jd),
                                      device="cpu")
    cfg = flow_suite.FlowSuiteConfig(**_SMALL, fused_hists=True)
    hits = 0
    for kind, plane, n in wire:
        p = torch.from_numpy(plane.view(np.int32))
        if kind == "news":
            js, jd = jfd.update_news(js, jd, jnp.asarray(plane),
                                     np.uint32(n), JCFG)
            ts, td = flow_dict.update_news(ts, td, p, n, cfg)
            continue
        mask = rng.random(2 * plane.shape[1]) < 0.6
        js = jfd.update_hits(js, jd, jnp.asarray(plane), np.uint32(n), JCFG,
                             mask=jnp.asarray(mask))
        ts = flow_dict.update_hits(ts, td, p, n, cfg,
                                   mask=torch.from_numpy(mask))
        hits += 1
        for (name, _), a, b in zip(convert.SUITE_LEAVES,
                                   convert.state_to_numpy(ts), _jleaves(js)):
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert hits >= 2
