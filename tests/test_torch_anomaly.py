"""The port's anomaly plane against the JAX package's, on the CPU.

- `detectors.offer`: bit-equal to the reference on batches built to
  collide inside a batch (the highest admitted row wins a slot), and the
  LRU-by-window cases;
- `detectors.window_step` over a sequence of windows that covers warmup,
  empty windows and alert exclusion: integer leaves exact, float leaves
  within rtol 1e-5 (atol 1e-6), the PCA projector within atol 1e-5, the
  entropy and PCA scores within rtol 1e-4 (atol 1e-4), the
  matrix-profile score within rtol 1e-3 (atol 1e-3): over a 4-window
  subsequence of golden vectors its distance is a difference of
  near-equal float32 products, and the two packages sum them in
  different orders;
- `feed_flat` and `feed_dict_flat` over staged buffers: bit-equal;
- the exporter hook on `ddos_ramp` (4096 rows a window): the port's dict
  feed, dict inline and lanes feed against the JAX exporter's feed path
  of the same wire. First alert window and alerts_total equal, scores
  and z per window within rtol 1e-4 (atol 1e-4); the port's inline dict
  path against the JAX inline path: every integer leaf of the plane's
  state equal at every window close;
- the sketch state bit-identical with the plane on and off, every wire;
- the fault, device-error, feed-error and restart cases that need no
  tracer and no pod; the JAX serving stack reading the port's anomaly
  bus directory; `convert`'s anomaly leaves both ways.

Every exporter is closed in a `finally`; faults are disarmed around
every test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflow_tpu.anomaly import AnomalyConfig as JCfg
from deepflow_tpu.anomaly import AnomalyPlane as JPlane
from deepflow_tpu.anomaly import detectors as jdet
from deepflow_tpu.models import flow_suite as jfs
from deepflow_tpu.replay.generator import ddos_ramp
from deepflow_tpu.runtime import tpu_sketch as jts
from deepflow_tpu.runtime.snapbus import SnapshotBus as JaxBus
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.anomaly import DETECTORS, AnomalyConfig, AnomalyPlane
from deepflow_tpu_torch.anomaly import detectors as tdet
from deepflow_tpu_torch.models import flow_dict, flow_suite
from deepflow_tpu_torch.ops._build import KernelError
from deepflow_tpu_torch.runtime.faults import default_faults
from deepflow_tpu_torch.runtime.snapbus import SnapshotBus
from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter

F32 = dict(rtol=1e-5, atol=1e-6)
PROJ_ATOL = 1e-5
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)
MP_STEP_TOL = dict(rtol=1e-3, atol=1e-3)
ACFG_KW = dict(warmup_windows=4, mp_length=64)
ACFG, JACFG = AnomalyConfig(**ACFG_KW), JCfg(**ACFG_KW)


@pytest.fixture(autouse=True)
def _clean_faults():
    default_faults().disarm()
    yield
    default_faults().disarm()


def _jleaves(jstate):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.device_get(jstate))]


def _assert_state_close(tstate, jstate, exact_floats=False):
    """Port state against the reference's, leaf by leaf in the
    reference's order: integer leaves exact, float leaves within F32
    (exact with `exact_floats`), the PCA basis by its projector."""
    got, want = convert.anomaly_to_numpy(tstate), _jleaves(jstate)
    assert len(got) == len(want) == len(convert.ANOMALY_LEAVES)
    for (path, dt), a, b in zip(convert.ANOMALY_LEAVES, got, want):
        assert a.dtype == b.dtype == np.dtype(dt), path
        assert a.shape == b.shape, path
        if path == "pca.w":
            np.testing.assert_allclose(a.astype(np.float64) @ a.T,
                                       b.astype(np.float64) @ b.T,
                                       atol=PROJ_ATOL, rtol=0)
        elif a.dtype == np.float32 and not exact_floats:
            np.testing.assert_allclose(a, b, err_msg=path, **F32)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)


def _seeded(cfg, jcfg):
    """A JAX plane state and the port's copy of it (via convert)."""
    js = jdet.init(jcfg)
    return convert.anomaly_from_numpy(jax.device_get(js), device="cpu"), js


# -- leaf order and convert -------------------------------------------------

def test_anomaly_leaves_match_the_jax_leaf_order():
    js = jdet.init(JACFG)
    paths, _ = jax.tree_util.tree_flatten_with_path(js)
    names = [".".join(p.name for p in path) for path, _ in paths]
    assert names == [name for name, _ in convert.ANOMALY_LEAVES]
    assert [np.asarray(x).dtype for _, x in paths] == \
        [np.dtype(dt) for _, dt in convert.ANOMALY_LEAVES]


def test_convert_round_trip_keeps_leaves_shapes_and_copies():
    """The JAX plane's state (after feeds and window steps) goes into
    the port and back leaf-equal; 0-d leaves stay 0-d; the returned
    arrays are copies, untouched by later changes to the port's state."""
    plane = JPlane(JACFG)
    rng = np.random.default_rng(2)
    for w in range(6):
        keys = rng.integers(0, 1 << 32, 512, dtype=np.uint64).astype(np.uint32)
        plane.state = jdet.offer(plane.state, jnp.asarray(keys),
                                 jnp.ones(512, bool), JACFG)
        plane.close_window(_jout(4000 + w, [0.8, 0.5, 0.9, 0.3]), now=w)
    host = jax.device_get(plane.state)
    ts = convert.anomaly_from_numpy(host, device="cpu")
    assert ts.window.dim() == 0 and ts.pca.step.dim() == 0 \
        and ts.res_mean.dim() == 0 and ts.mp.count.dim() == 0
    back = convert.anomaly_to_numpy(ts)
    for a, b in zip(back, _jleaves(host)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # from the flat leaf list too
    ts2 = convert.anomaly_from_numpy(_jleaves(host), device="cpu")
    for a, b in zip(convert.anomaly_to_numpy(ts2), back):
        np.testing.assert_array_equal(a, b)
    keys_before = back[0].copy()
    ts.keys.fill_(7)
    ts.window.add_(1)
    np.testing.assert_array_equal(back[0], keys_before)
    assert int(back[5]) == int(host.window)


# -- the active-flow table ----------------------------------------------------

@pytest.mark.parametrize("log2,n,seed", [(2, 64, 0), (3, 200, 1), (6, 512, 2),
                                         (14, 4096, 3)])
def test_offer_collisions_bit_equal(log2, n, seed):
    """Batches built to collide inside the batch (few slots, repeated
    keys, a random mask), over several windows: every leaf bit-equal to
    the reference, whose serial scatter lets the later row win."""
    jcfg, cfg = JCfg(active_log2=log2), AnomalyConfig(active_log2=log2)
    ts, js = _seeded(cfg, jcfg)
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 32, max(8, n // 4),
                        dtype=np.uint64).astype(np.uint32)
    pool[0] = 0xFFFFFFFF                     # the sentinel value as a key
    for w in range(5):
        for _ in range(3):
            keys = pool[rng.integers(0, len(pool), n)]
            mask = rng.random(n) < 0.8
            js = jdet.offer(js, jnp.asarray(keys), jnp.asarray(mask), jcfg)
            ts = tdet.offer(ts, torch.from_numpy(keys.view(np.int32)),
                            torch.from_numpy(mask), cfg)
            _assert_state_close(ts, js, exact_floats=True)
        js = js._replace(window=js.window + 1)
        ts = ts._replace(window=ts.window + 1)
    assert int(ts.evictions) > 0 or log2 == 14


def test_offer_winner_is_the_highest_admitted_row():
    """Three rows of three keys on one slot of an empty table: the last
    admitted row's key and window land in the slot, an unadmitted
    (masked) later row does not win."""
    cfg = AnomalyConfig(active_log2=1)
    ts = tdet.init(cfg, device="cpu")
    keys = torch.tensor([11, 22, 33, 44], dtype=torch.int64)
    slot = (tdet.mix32(keys ^ (cfg.seed & 0xFFFFFFFF)) >> 31).tolist()
    mask = torch.tensor([True, True, True, False])
    ts = tdet.offer(ts, keys, mask, cfg)
    for s in set(slot[:3]):
        winner = max(i for i in range(3) if slot[i] == s)
        assert int(ts.keys[s]) == int(keys[winner])
        assert int(ts.last_window[s]) == 0 and int(ts.born[s]) == 0
    assert int(ts.offers) == 3 and int(ts.evictions) == 0


def test_active_flow_table_lru_by_window():
    cfg = AnomalyConfig(active_log2=8)
    st = tdet.init(cfg, device="cpu")
    keys = torch.arange(1000, 1016)
    mask = torch.ones(16, dtype=torch.bool)
    st = tdet.offer(st, keys, mask, cfg)
    assert int((st.last_window == 0).sum()) == 16
    assert int(st.offers) == 16 and int(st.evictions) == 0
    st = tdet.offer(st, keys, mask, cfg)
    assert int(st.evictions) == 0
    assert int((st.last_window == 0).sum()) == 16
    st = st._replace(window=st.window + 1)
    st = tdet.offer(st, torch.arange(5000, 5016), mask, cfg)
    assert int((st.last_window == 1).sum()) >= 1
    assert bool((st.born[st.last_window == 1] == 1).all())


def test_active_flow_occupant_wins_same_window():
    cfg = AnomalyConfig(active_log2=2)
    st = tdet.init(cfg, device="cpu")
    st = tdet.offer(st, torch.arange(0, 64), torch.ones(64, dtype=torch.bool),
                    cfg)
    before = st.keys.clone()
    st = tdet.offer(st, torch.arange(100, 164),
                    torch.ones(64, dtype=torch.bool), cfg)
    assert torch.equal(st.keys, before)


# -- the window step ----------------------------------------------------------

def _jout(rows, ent, card=100.0, top1=50, k=100):
    counts = np.zeros(k, np.int32)
    counts[0] = top1
    keys = np.zeros(k, np.uint32)
    keys[0] = 0xDEADBEEF
    return jfs.FlowWindowOutput(
        topk_keys=keys, topk_counts=counts,
        service_cardinality=np.asarray([card], np.float32),
        entropies=np.asarray(ent, np.float32),
        rows=np.asarray(rows, np.int32))


def _tout(jout):
    return flow_suite.FlowWindowOutput(
        topk_keys=torch.from_numpy(np.asarray(jout.topk_keys).view(np.int32)),
        topk_counts=torch.from_numpy(np.asarray(jout.topk_counts)),
        service_cardinality=torch.from_numpy(
            np.asarray(jout.service_cardinality)),
        entropies=torch.from_numpy(np.asarray(jout.entropies)),
        rows=torch.tensor(int(jout.rows), dtype=torch.int32))


def _window_sequence(rng):
    """(rows, entropies, card, top1, keys offered) per window: a calm
    stretch with an empty window inside the warmup and one after it, an
    entropy collapse (an alert the baseline must exclude), a
    golden-signal shift, then calm again. Every golden feature varies
    from window to window: the matrix-profile distance of a series that
    is constant to a few float32 ulps is a difference of near-equal
    products, ill-conditioned in either package."""
    ent = np.asarray([0.82, 0.55, 0.9, 0.3])
    seq = []
    for w in range(40):
        rows = 4000 + int(rng.integers(-1500, 1500))
        e = ent + rng.normal(0, 0.02, 4)
        card, top1 = rows / rng.uniform(20, 60), rows // rng.integers(40, 120)
        nkeys = int(rng.integers(64, 256))
        if w in (2, 17):
            rows = nkeys = 0
        elif w in (20, 21):
            e = np.asarray([0.99, 0.05, 0.95, 0.02])      # spoofed flood
        elif w == 26:
            rows, card, top1 = 1 << 20, 1.0, 900000       # PCA shift
        seq.append((rows, e, card, top1, nkeys))
    return seq


def _assert_scores(got, want, w):
    """Detector scores in DETECTORS order: entropy and PCA within
    SCORE_TOL, the matrix-profile discord within MP_STEP_TOL."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got[:2], want[:2], err_msg=f"window {w}",
                               **SCORE_TOL)
    np.testing.assert_allclose(got[2], want[2], err_msg=f"window {w}",
                               **MP_STEP_TOL)


def test_window_step_sequence_matches_jax():
    cfg = AnomalyConfig(warmup_windows=4, mp_length=32, mp_m=4)
    jcfg = JCfg(warmup_windows=4, mp_length=32, mp_m=4)
    ts, js = _seeded(cfg, jcfg)
    rng = np.random.default_rng(11)
    alerted = set()
    for w, (rows, e, card, top1, nkeys) in enumerate(_window_sequence(rng)):
        keys = rng.integers(0, 1 << 20, 256).astype(np.uint32)
        mask = np.arange(256) < nkeys
        js = jdet.offer(js, jnp.asarray(keys), jnp.asarray(mask), jcfg)
        ts = tdet.offer(ts, torch.from_numpy(keys.view(np.int32)),
                        torch.from_numpy(mask), cfg)
        jo = _jout(rows, e, card, top1)
        to = _tout(jo)
        js, jsc = jdet.window_step(js, jo.entropies, jo.topk_counts,
                                   jo.service_cardinality, jo.rows, jcfg)
        ts, tsc = tdet.window_step(ts, to.entropies, to.topk_counts,
                                   to.service_cardinality, to.rows, cfg)
        _assert_scores(tsc.scores.numpy(), np.asarray(jsc.scores), w)
        np.testing.assert_allclose(tsc.z.numpy(), np.asarray(jsc.z), **F32)
        np.testing.assert_allclose(tsc.feats.numpy(), np.asarray(jsc.feats),
                                   **F32)
        for name in ("active_flows", "new_flows", "rows"):
            assert int(getattr(tsc, name)) == int(getattr(jsc, name)), name
        _assert_state_close(ts, js)
        thr = cfg.thresholds
        alerted |= {DETECTORS[i] for i in range(3)
                    if float(jsc.scores[i]) >= thr[i]}
        if rows == 0:
            assert not np.asarray(jsc.scores).any()
    assert int(ts.window) == 40
    assert {"entropy_ddos", "pca_residual"} <= alerted


def test_plane_close_window_matches_jax_plane():
    """The host orchestration on the same outputs: alert decisions,
    latency, contributors, last scores and the anomaly bus leaves."""
    jp, tp = JPlane(JACFG), AnomalyPlane(ACFG, device="cpu")
    rng = np.random.default_rng(4)
    for w, (rows, e, card, top1, _) in enumerate(_window_sequence(rng)):
        jo = _jout(rows, e, card, top1)
        ja = jp.close_window(jo, now=100.0 + w)
        ta = tp.close_window(_tout(jo), now=100.0 + w)
        jp.publish_pending()
        tp.publish_pending()
        assert [a.detector for a in ta] == [a.detector for a in ja]
        for a, b in zip(ta, ja):
            assert (a.window, a.latency_windows, a.top_keys, a.top_counts) \
                == (b.window, b.latency_windows, b.top_keys, b.top_counts)
        _assert_scores(tp.last_scores, jp.last_scores, w)
        assert tp.alerts_total == jp.alerts_total
        assert tp.last_entropy_verdict["alerted"] == \
            jp.last_entropy_verdict["alerted"]
        tl, jl = tp.bus.latest().leaves, jp.bus.latest().leaves
        assert len(tl) == len(jl) == 8
        _assert_scores(tl[0], jl[0], w)
        for a, b in zip(tl, jl):
            assert a.dtype == b.dtype and a.shape == b.shape
        for a, b in zip(tl[1:], jl[1:]):
            np.testing.assert_allclose(a, b, **SCORE_TOL)
    assert sum(tp.alerts_total) > 0


# -- staged feeds -------------------------------------------------------------

def _ramp_cols(w, rows=1500):
    _, cols = ddos_ramp(seed=3, rows_per_window=rows).window_cols(w)
    return cols


def test_feed_flat_matches_jax():
    """A K=3 coalesced lane buffer with partial slots."""
    C, ns = 512, (512, 311, 97)
    flat = np.zeros(flow_suite.coalesced_lanes_words(len(ns), C), np.uint32)
    for i, n in enumerate(ns):
        cols = {k: v[:n] for k, v in _ramp_cols(13 + i).items()}
        plane = flow_suite.slot_plane(flat, i, C)
        full = {k: np.zeros(C, np.uint32) for k in cols}
        for k, v in cols.items():
            full[k][:n] = v
        flow_suite.pack_lanes_into(full, plane)
        flat[i * flow_suite.slot_words(C)] = n
    cfg, jcfg = AnomalyConfig(active_log2=9), JCfg(active_log2=9)
    ts, js = _seeded(cfg, jcfg)
    js = jdet.feed_flat(js, jnp.asarray(flat), len(ns), C, jcfg)
    ts = tdet.feed_flat(ts, torch.from_numpy(flat.view(np.int32)), len(ns),
                        C, cfg)
    _assert_state_close(ts, js, exact_floats=True)
    assert int(ts.offers) == sum(ns)


def test_feed_dict_flat_matches_jax():
    """Staged dict-wire buffers (news and hits planes, the second pack
    mostly hits) against a table that holds the group's news."""
    packer = flow_dict.FlowDictPacker(capacity=4096, hits_batch=512,
                                      news_batch=256)
    table = np.zeros((4, 4096), np.uint32)
    cfg, jcfg = AnomalyConfig(active_log2=10), JCfg(active_log2=10)
    ts, js = _seeded(cfg, jcfg)
    kinds = set()
    for w in (3, 4, 13):
        wire = packer.pack(_ramp_cols(w, rows=900)) + packer.flush()
        flow_dict.mirror_news_np(wire, table)
        sig = flow_dict.wire_signature(wire)
        kinds |= {k for k, _ in sig}
        flat = np.zeros(flow_dict.wire_words(sig), np.uint32)
        flow_dict.stage_wire(wire, flat)
        js = jdet.feed_dict_flat(js, jnp.asarray(table), jnp.asarray(flat),
                                 sig, jcfg)
        ts = tdet.feed_dict_flat(ts, torch.from_numpy(table.view(np.int32)),
                                 torch.from_numpy(flat.view(np.int32)), sig,
                                 cfg)
        _assert_state_close(ts, js, exact_floats=True)
    assert kinds == {"news", "hits"}


# -- the exporter hook on ddos_ramp -------------------------------------------

RAMP_ROWS = 4096
_JAX_RUNS = {}


def _run_ramp(exp, windows=None):
    """Feed ddos_ramp(seed=7) window by window; per window the plane's
    scores, z, alerts_total and counters."""
    ramp = ddos_ramp(seed=7, rows_per_window=RAMP_ROWS)
    out = []
    for w, _phase, cols in ramp.windows():
        if windows is not None and w >= windows:
            break
        exp.process([("l4_flow_log", 0, cols, -1)])
        exp.flush_window(now=1000.0 + w)
        p = exp.anomaly
        snap = p.bus.latest()
        out.append({"scores": list(p.last_scores),
                    "z": np.asarray(snap.leaves[2]),
                    "feats": np.asarray(snap.leaves[3]),
                    "alerts": list(p.alerts_total),
                    "offers": p.table_offers, "evictions": p.table_evictions,
                    "active": p.active_flows, "new": p.new_flows})
    return out


def _jax_ramp(wire):
    if wire not in _JAX_RUNS:
        exp = jts.TpuSketchExporter(
            store=None, cfg=jfs.FlowSuiteConfig(), batch_rows=RAMP_ROWS,
            window_seconds=3600, wire=wire, prefetch_depth=2, zero_copy=True,
            anomaly=JCfg())
        try:
            _JAX_RUNS[wire] = (_run_ramp(exp), exp.rows_in)
        finally:
            exp.close()
    return _JAX_RUNS[wire]


def _first_alert(run):
    return next((w for w, r in enumerate(run) if r["alerts"][0]), None)


@pytest.mark.parametrize("wire,knobs", [
    ("dict", dict(prefetch_depth=2)),
    ("dict", dict()),
    ("lanes", dict(prefetch_depth=2)),
], ids=["dict_feed", "dict_inline", "lanes_feed"])
def test_exporter_matches_jax_feed_path_on_ddos_ramp(wire, knobs):
    want, jrows = _jax_ramp(wire)
    exp = TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(),
                            batch_rows=RAMP_ROWS, window_seconds=3600,
                            wire=wire, anomaly=AnomalyConfig(), device="cpu",
                            **knobs)
    try:
        got = _run_ramp(exp)
        plane = exp.anomaly
        assert plane.rows_seen == exp.rows_in == jrows == plane.table_offers
        assert plane.windows == exp.windows == len(want)
        assert plane.feed_errors == plane.score_errors == 0
        assert plane.alerts_shed == plane.windows_unscored == 0
    finally:
        exp.close()
    onset = ddos_ramp(seed=7).onset_window
    assert _first_alert(got) == _first_alert(want)
    assert _first_alert(got) - onset <= 2
    assert got[-1]["alerts"] == want[-1]["alerts"]
    for w, (g, j) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["scores"], j["scores"],
                                   err_msg=f"window {w}", **SCORE_TOL)
        np.testing.assert_allclose(g["z"], j["z"], err_msg=f"window {w}",
                                   **SCORE_TOL)
        assert g["alerts"] == j["alerts"], w
        assert (g["offers"], g["evictions"], g["active"], g["new"]) == \
            (j["offers"], j["evictions"], j["active"], j["new"]), w
    a = got[_first_alert(got)]
    assert a["z"][0] > 0 and a["z"][1] < 0


def _ramp_plane_ints(exp, to_numpy):
    """Every integer leaf of the plane's state at every window close of
    ddos_ramp(seed=7)."""
    ints = [i for i, (_, dt) in enumerate(convert.ANOMALY_LEAVES)
            if np.dtype(dt).kind in "iu"]
    out = []
    for w, _phase, cols in ddos_ramp(seed=7,
                                     rows_per_window=RAMP_ROWS).windows():
        exp.process([("l4_flow_log", 0, cols, -1)])
        exp.flush_window(now=1000.0 + w)
        leaves = to_numpy(exp.anomaly.state)
        out.append([leaves[i] for i in ints])
    return out


def test_inline_dict_plane_matches_jax_inline_path():
    """The port's inline dict path feeds the plane once per staged group
    (after the group's news and hits), the reference's inline path once
    per plane: every integer leaf of the plane's state is equal at every
    window close of the ramp."""
    kw = dict(batch_rows=RAMP_ROWS, window_seconds=3600, wire="dict")
    jexp = jts.TpuSketchExporter(store=None, cfg=jfs.FlowSuiteConfig(),
                                 anomaly=JCfg(), **kw)
    try:
        assert jexp.prefetch_depth == 0
        want = _ramp_plane_ints(jexp, _jleaves)
    finally:
        jexp.close()
    exp = TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(),
                            anomaly=AnomalyConfig(), device="cpu", **kw)
    try:
        assert exp.prefetch_depth == 0
        got = _ramp_plane_ints(exp, convert.anomaly_to_numpy)
    finally:
        exp.close()
    assert len(got) == len(want) == 28
    for w, (g, j) in enumerate(zip(got, want)):
        assert len(g) == len(j) == 8
        for a, b in zip(g, j):
            np.testing.assert_array_equal(a, b, err_msg=f"window {w}")


@pytest.mark.parametrize("wire,knobs", [
    ("lanes", dict()), ("dict", dict()),
    ("lanes", dict(prefetch_depth=2, coalesce_batches=2)),
    ("dict", dict(prefetch_depth=2)),
], ids=["lanes_inline", "dict_inline", "lanes_feed", "dict_feed"])
def test_sketch_state_bit_identical_with_plane_on(wire, knobs):
    ramp = ddos_ramp(seed=9, rows_per_window=2048)
    exps = [TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(),
                              batch_rows=1024, window_seconds=3600,
                              wire=wire, anomaly=a, device="cpu", **knobs)
            for a in (None, ACFG)]
    snaps = [[], []]
    for exp, s in zip(exps, snaps):
        exp.snapshot_bus.subscribe(lambda x, s=s: s.append(list(x.leaves)))
    try:
        for w, _phase, cols in ramp.windows():
            if w >= 16:
                break
            for exp in exps:
                exp.process([("l4_flow_log", 0, cols, -1)])
                exp.flush_window(now=1000.0 + w)
        for exp in exps:
            if exp._feed is not None:
                assert exp._feed.drain(30)
        assert len(snaps[0]) == len(snaps[1]) == 16
        for a, b in zip(*snaps):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        for x, y in zip(convert.state_to_numpy(exps[0].state),
                        convert.state_to_numpy(exps[1].state)):
            np.testing.assert_array_equal(x, y)
        on = exps[1]
        assert on.anomaly.rows_seen == on.rows_in == on.anomaly.table_offers
        assert on.counters()["anomaly_rows_seen"] == on.rows_in
    finally:
        for exp in exps:
            exp.close()


# -- faults, device errors, feed errors ---------------------------------------

def _lanes_exporter(**kw):
    return TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(), batch_rows=4096,
                             window_seconds=3600, wire="lanes", device="cpu",
                             **kw)


def test_anomaly_score_fault_counted_and_latency_honest():
    """anomaly.score sheds the onset window's scoring (counted); the
    excursion is detected at the next scored window with latency >= 1."""
    ramp = ddos_ramp(seed=7)
    default_faults().arm("anomaly.score", count=1,
                         match=f"window{ramp.onset_window}")
    exp = _lanes_exporter(anomaly=AnomalyConfig())
    try:
        first = None
        for w, _phase, cols in ramp.windows():
            exp.process([("l4_flow_log", 0, cols, -1)])
            exp.flush_window(now=1000.0 + w)
            if exp.anomaly.alerts_total[0]:
                first = w
                break
        plane = exp.anomaly
        assert plane.windows_unscored == 1 and plane.score_errors == 1
        assert first == ramp.onset_window + 1
        assert plane.last_latency_windows >= 1
        assert plane.rows_seen == exp.rows_in
    finally:
        exp.close()


def test_device_error_mid_attack_tagged_never_lost():
    ramp = ddos_ramp(seed=7)
    onset = ramp.onset_window
    default_faults().arm("tpu.device_error", count=1, after=onset + 4)
    exp = _lanes_exporter(anomaly=AnomalyConfig())
    try:
        lossy_seen = False
        for w, _phase, cols in ramp.windows():
            exp.process([("l4_flow_log", 0, cols, -1)])
            exp.flush_window(now=1000.0 + w)
            snap = exp.anomaly.bus.latest()
            lossy_seen |= bool(snap is not None and snap.tags.get("lossy"))
            if w >= onset + 4:
                break
        plane = exp.anomaly
        assert exp.lost_rows > 0 and exp.device_errors == 1
        assert lossy_seen
        assert plane.feed_errors == 1           # device_lost, counted
        assert plane.alerts_total[0] >= 1
        assert plane.rows_seen == exp.rows_in
        assert plane.windows == exp.windows
    finally:
        exp.close()


def test_shed_windows_close_unscored():
    """Degraded with rows shed (as on a CUDA device): the window's output
    is None, so the plane closes it unscored, counted, never scored
    silently; both device errors reach device_lost."""
    ramp = ddos_ramp(seed=7, rows_per_window=4096)   # one batch a window
    exp = _lanes_exporter(anomaly=ACFG, audit_rate=1 / 64)
    exp._host_fallback = False
    try:
        for w in range(3):
            exp.process([("l4_flow_log", 0, ramp.window_cols(w)[1], -1)])
            exp.flush_window(now=1000.0 + w)
        default_faults().arm("tpu.device_error", count=2)
        for w in (3, 4, 5):                     # error, error, shed
            exp.process([("l4_flow_log", 0, ramp.window_cols(w)[1], -1)])
        assert exp.degraded and exp.shed_rows == 4096
        assert exp.flush_window(now=1003.0) is None
        plane = exp.anomaly
        assert plane.windows == exp.windows == 4
        assert plane.windows_unscored == 1 and plane.score_errors == 0
        assert plane.feed_errors == 2
        assert plane.last_entropy_verdict["eligible"] is False
        assert plane.rows_seen == exp.rows_in
        assert exp._audit.windows == 4 and exp._audit.last_window["degraded"]
        exp.process([("l4_flow_log", 0, ramp.window_cols(6)[1], -1)])
        exp.flush_window(now=1004.0)            # recovered: scored again
        assert plane.windows_unscored == 1 and plane.windows == 5
    finally:
        exp.close()


def test_feed_error_recovers_plane(monkeypatch):
    """A RuntimeError in a feed drops the batch's offers (counted) and
    restarts the plane at the host window count; later feeds and the
    window step work. A KernelError is not swallowed."""
    plane = AnomalyPlane(ACFG, device="cpu")
    keys = torch.arange(100, dtype=torch.int32)
    mask = torch.ones(100, dtype=torch.bool)
    lanes = {"ip_src": keys, "ip_dst": keys, "ports": keys,
             "proto_pkts": keys}
    plane.close_window(_tout(_jout(100, [0.8, 0.5, 0.9, 0.3])), now=1.0)
    plane.publish_pending()
    real = tdet.offer

    def boom(*a, **k):
        raise RuntimeError("injected feed failure")

    monkeypatch.setattr(tdet, "offer", boom)
    plane.feed_lanes(lanes, mask)
    assert plane.feed_errors == 1
    assert int(plane.state.window) == plane.windows == 1
    monkeypatch.setattr(tdet, "offer", real)
    plane.feed_lanes(lanes, mask)
    assert plane.feed_errors == 1 and int(plane.state.offers) == 100
    plane.close_window(_tout(_jout(100, [0.8, 0.5, 0.9, 0.3])), now=2.0)
    assert plane.windows_unscored == 0

    def broken(*a, **k):
        raise KernelError("no kernel")

    monkeypatch.setattr(tdet, "offer", broken)
    with pytest.raises(KernelError):
        plane.feed_lanes(lanes, mask)


# -- the anomaly bus: fan-out, durability, JAX serving ------------------------

class _Recorder:
    name = "rec"

    def __init__(self):
        self.puts = []

    def start(self):
        pass

    def close(self):
        pass

    def is_export_data(self, stream, cols):
        return stream == "anomaly"

    def put(self, stream, idx, cols):
        self.puts.append((stream, cols))


def test_alerts_ride_the_jax_exporters_fanout():
    from deepflow_tpu.runtime.exporters import Exporters
    exps = Exporters(breaker_cfg=None)
    rec = _Recorder()
    exps.register(rec)
    exp = _lanes_exporter(anomaly=AnomalyConfig())
    exp.anomaly.attach_exporters(exps)
    try:
        for w, _phase, cols in ddos_ramp(seed=7).windows():
            exp.process([("l4_flow_log", 0, cols, -1)])
            exp.flush_window(now=1000.0 + w)
            if exp.anomaly.alerts_total[0]:
                break
        assert rec.puts
        stream, cols = rec.puts[0]
        assert stream == "anomaly"
        assert cols["detector"][0] == "entropy_ddos"
        assert float(cols["score"][0]) >= float(cols["threshold"][0])
        assert exp.anomaly.alerts_shed == 0
    finally:
        exp.close()


def _ramp_to_dir(make, directory, windows=18):
    exp = make(directory)
    try:
        for w, _phase, cols in ddos_ramp(seed=7).windows():
            if w >= windows:
                break
            exp.process([("l4_flow_log", 0, cols, -1)])
            exp.flush_window(now=1000.0 + w)
    finally:
        exp.close()


@pytest.fixture(scope="module")
def anomaly_dirs(tmp_path_factory):
    """Anomaly bus directories of the same ramp, written by the port and
    by the JAX package."""
    root = tmp_path_factory.mktemp("anomaly_bus")
    port, ref = str(root / "port"), str(root / "jax")
    _ramp_to_dir(lambda d: _lanes_exporter(anomaly=AnomalyConfig(),
                                           anomaly_dir=d), port)
    _ramp_to_dir(lambda d: jts.TpuSketchExporter(
        store=None, cfg=jfs.FlowSuiteConfig(), batch_rows=4096,
        window_seconds=3600, wire="lanes", anomaly=JCfg(),
        anomaly_dir=d), ref)
    return port, ref


def test_alerts_durable_across_restart(anomaly_dirs):
    """Alert windows are fsynced npz: a fresh bus (either package's) over
    the port's directory reads the alerts back."""
    port, _ = anomaly_dirs
    for bus in (SnapshotBus(port, name="anomaly"),
                JaxBus(port, name="anomaly")):
        snap = bus.read_latest()
        assert snap is not None and snap.tags.get("alerts")
        a = snap.tags["alerts"][0]
        assert a["detector"] in DETECTORS and a["score"] >= a["threshold"]
        assert len(snap.leaves) == 8


def _tables(directory):
    from deepflow_tpu.serving import AnomalyTables, SnapshotCache
    return AnomalyTables(SnapshotCache(JaxBus(directory, name="anomaly"),
                                       max_staleness_s=1e9))


def test_jax_serving_answers_sql_off_port_bus(anomaly_dirs):
    from deepflow_tpu.querier.sql import parse_sql
    port, ref = anomaly_dirs
    got = _tables(port).sql(parse_sql("SELECT * FROM anomaly"))
    want = _tables(ref).sql(parse_sql("SELECT * FROM anomaly"))
    assert got.columns == want.columns
    assert [r[2] for r in got.values] == list(DETECTORS)
    assert len(got.values) == len(want.values)
    for g, w in zip(got.values, want.values):
        for i, (a, b) in enumerate(zip(g, w)):
            if isinstance(b, float):
                np.testing.assert_allclose(a, b, **SCORE_TOL)
            else:
                assert a == b, (got.columns[i], a, b)
    assert any(r[5] for r in got.values)


def test_jax_serving_answers_promql_off_port_bus(anomaly_dirs, tmp_path):
    from deepflow_tpu.querier.promql import PromEngine
    from deepflow_tpu.store.db import Store
    from deepflow_tpu.store.dict_store import TagDictRegistry
    port, ref = anomaly_dirs
    answers = []
    for d in (port, ref):
        prom = PromEngine(Store(str(tmp_path / ("store_" + d[-3:]))),
                          TagDictRegistry(None), anomaly=_tables(d))
        q = [prom.query('anomaly_score{detector="entropy_ddos"}', at=1017),
             prom.query('anomaly_alerts_total{detector="entropy_ddos"}',
                        at=1017),
             prom.query("anomaly_active_flows", at=1017),
             prom.query('anomaly_score{detector="nope"}', at=1017)]
        answers.append(q)
    for g, w in zip(*answers):
        assert [r["metric"] for r in g] == [r["metric"] for r in w]
        np.testing.assert_allclose([float(r["value"][1]) for r in g],
                                   [float(r["value"][1]) for r in w],
                                   **SCORE_TOL)
    assert float(answers[0][0][0]["value"][1]) >= 4.0
    assert answers[0][3] == []
