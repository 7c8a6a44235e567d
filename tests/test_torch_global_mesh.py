"""The port's global mesh: two processes, one mesh, merged windows.

The reference's two-process test (`tests/test_multihost.py`) drives its
three sharded suites over a global mesh of 2 processes x 4 CPU devices
and skips on the CPU (XLA's CPU backend has no cross-process
collectives). The port's counterpart runs here: `WORKER` below runs in
two processes joined over gloo (`init_distributed`), 4 CPU shards each
(`make_global_mesh(n_local=4)`), each fed only its own half of every
batch through `process_local_batch` (or its half of the plane for the
plane and lanes forms). Every merged state and window output must equal

- the JAX suites on the single-process 8-device CPU mesh (the
  reference's own baseline), and
- the port's own 8 shards in one process (`WORKER`'s body, run here),

with the reference's configurations and data (`cms_log2_width=12`, ring
256, HLL 64 x 2^8, entropy 2^8, n = 4096 rows from
`default_rng(0xD15C0)` with a heavy hitter planted in rows [0, 512)):
every integer leaf exact; floats within the reference's tolerances
(flow entropy abs 1e-6, metrics entropy abs 1e-5, matrix-profile sum
rel 1e-4, app p95 rel 1e-5, the PCA projector rtol 1e-4). The float
leaves differ only in summation order: 4 local shards then an
all-reduce of 2 against 8 in sequence.

The worker also takes a step in which process 1's rows are all masked
(a flow batch and a metrics update): it must neither deadlock (every
process still issues every collective) nor diverge; builds the 2-D
("dcn_data", "data") mesh; and runs the dict form on a mesh of 2 shards
per process, every process passing the same full news and hits planes
(one `FlowDictPacker` over a stream of 100 heavy 5-tuples and 900
singletons), held against the JAX package's single-process 4-device
dict form on the same planes. Workers run under a timeout and are
killed in a `finally`.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflow_tpu.batch.schema import SKETCH_L4_SCHEMA as JSCHEMA
from deepflow_tpu.models import flow_suite as jfs
from deepflow_tpu.models import metrics_suite as jms
from deepflow_tpu.models.app_suite import AppSuiteConfig as JAppCfg
from deepflow_tpu.parallel import sharded as jsh
from deepflow_tpu.parallel.mesh import make_mesh as jmake_mesh
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.batch.batcher import SKETCH_L4_SCHEMA
from deepflow_tpu_torch.parallel import (local_shard, make_global_mesh,
                                         process_local_batch)
from deepflow_tpu_torch.utils.u32 import fold_columns_np

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 90

# the reference worker's data (tests/test_multihost.py), drawn in its
# order: the flow columns, then the metrics windows, then the app columns
DATA = r'''
import numpy as np

N = 4096
M_WINDOWS = 10          # 2 * mp_m + 2: the matrix profile warms up


def make_data(schema_columns, metric_names):
    rng = np.random.default_rng(0xD15C0)
    cols = {name: rng.integers(0, 2**31, N, dtype=np.uint64).astype(dt)
            for name, dt in schema_columns}
    for k in cols:
        cols[k][:512] = cols[k][0]
    mwins = [{f: rng.integers(0, 1 << 12, N, dtype=np.int64)
              .astype(np.uint32) for f in metric_names}
             for _ in range(M_WINDOWS)]
    acols = {
        "ip_dst": rng.integers(0, 1 << 16, N, dtype=np.int64)
        .astype(np.uint32),
        "port_dst": rng.integers(0, 1024, N, dtype=np.int64)
        .astype(np.uint32),
        "protocol": np.full(N, 6, np.uint32),
        "status": rng.integers(0, 2, N, dtype=np.int64).astype(np.uint32),
        "rrt_us": rng.integers(1, 10_000, N, dtype=np.int64)
        .astype(np.uint32),
    }
    return cols, mwins, acols


def make_dict_data(schema_columns):
    """The dict form's stream: 100 heavy 5-tuples (300, 298, ..., 102
    rows each) and 900 singletons, shuffled, so that its top-100 is one
    the Count-Min noise cannot reorder."""
    rng = np.random.default_rng(0xD1C7)
    counts = np.concatenate([300 - 2 * np.arange(100),
                             np.ones(900, np.int64)])
    flow = rng.permutation(np.repeat(np.arange(len(counts)), counts))
    # ports and protocol at their wire widths (the dict wire packs them)
    top = {"port_src": 1 << 16, "port_dst": 1 << 16, "proto": 1 << 8}
    return {name: rng.integers(0, top.get(name, 2**31), len(counts),
                               dtype=np.uint64).astype(dt)[flow]
            for name, dt in schema_columns}


def idle_mask():
    """The second half of the rows masked: all of process 1's rows in
    the two-process run."""
    mask = np.ones(N, np.bool_)
    mask[N // 2:] = False
    return mask
'''

WORKER = DATA + r'''
import json
import pickle
import sys
import time

import torch

from deepflow_tpu_torch import convert
from deepflow_tpu_torch.batch.batcher import SKETCH_L4_SCHEMA
from deepflow_tpu_torch.models import flow_dict, flow_suite, metrics_suite
from deepflow_tpu_torch.models.app_suite import AppSuiteConfig
from deepflow_tpu_torch.parallel import (ShardedAppSuite, ShardedFlowSuite,
                                         ShardedMetricsSuite,
                                         init_distributed, local_shard,
                                         make_global_mesh,
                                         process_local_batch, sharded)

FLOW_CFG = flow_suite.FlowSuiteConfig(cms_log2_width=12, ring_size=256,
                                      hll_groups=64, hll_precision=8,
                                      entropy_log2_buckets=8)
METRICS_CFG = metrics_suite.MetricsSuiteConfig(entropy_log2_buckets=6,
                                               mp_length=32, mp_m=4)
APP_CFG = AppSuiteConfig(groups=16, dd_buckets=128, dd_alpha=0.05)


def host(out):
    return [t.detach().cpu().numpy() for t in out]


def dict_wire(cols):
    """The news and hits planes one FlowDictPacker emits for the whole
    stream, in 4096-row batches: what every process passes."""
    packer = flow_dict.FlowDictPacker(capacity=8192, hits_batch=2048,
                                      news_batch=512)
    wire = []
    for s in range(0, len(cols["ip_src"]), 4096):
        wire += packer.pack({k: v[s:s + 4096] for k, v in cols.items()})
    return wire + packer.flush()


def run(n_proc, pid):
    """Every suite over a global mesh of 8 shards (8 // n_proc in this
    process), fed this process's rows; returns the results to compare."""
    mesh = make_global_mesh(n_local=8 // n_proc, device="cpu")
    assert mesh.shape["data"] == 8 and mesh.process == pid
    sl = slice(pid * N // n_proc, (pid + 1) * N // n_proc)
    cols, mwins, acols = make_data(
        SKETCH_L4_SCHEMA.columns,
        metrics_suite.ENTROPY_FEATURES + metrics_suite.GOLDEN_SIGNALS)
    mask = np.ones(N, np.bool_)
    r = {"pid": pid}

    def local(c):
        return {k: v[sl] for k, v in c.items()}

    # the l4 flow suite, columns (the reference's drive), then a batch
    # whose last process's rows are all masked, each window flushed
    suite = ShardedFlowSuite(FLOW_CFG, mesh)
    st = suite.init()
    for w, m in enumerate((mask, idle_mask())):
        st = suite.update(st, *process_local_batch(local(cols), m[sl], mesh))
        r[f"flow_state{w}"] = convert.sharded_to_numpy(st)
        r[f"flow_merged{w}"] = convert.state_to_numpy(
            sharded._merge_axis0(st, suite._comm))
        st, out = suite.flush(st)
        r[f"flow_out{w}"] = host(out)
    # the full-row plane and the packed lanes, this process's columns
    plane = np.stack([cols[name].astype(np.uint32)
                      for name, _ in SKETCH_L4_SCHEMA.columns])
    pmask = np.arange(N) < N - 100
    st = suite.update_plane(suite.init(), *suite.put_plane(
        plane[:, sl], pmask[sl]))
    r["plane_merged"] = convert.state_to_numpy(
        sharded._merge_axis0(st, suite._comm))
    lanes = flow_suite.pack_lanes(cols)
    lplane = np.stack([lanes[k] for k in flow_suite.SKETCH_LANE_NAMES])
    st = suite.update_lanes(suite.init(), suite.put_lanes(lplane[:, sl]),
                            N - 333)
    r["lanes_merged"] = convert.state_to_numpy(
        sharded._merge_axis0(st, suite._comm))
    # the dict form on 4 global shards (2 in each of two processes):
    # every process passes the same full news and hits planes
    dsuite = ShardedFlowSuite(FLOW_CFG,
                              make_global_mesh(n_local=4 // n_proc,
                                               device="cpu"))
    ds, dt = dsuite.init(), dsuite.init_dict(8192)
    for kind, dplane, n in dict_wire(make_dict_data(
            SKETCH_L4_SCHEMA.columns)):
        if kind == "news":
            ds, dt = dsuite.update_news(ds, dt, dplane, n)
        else:
            ds = dsuite.update_hits(ds, dt, dplane, n)
    r["dict_state"] = convert.sharded_to_numpy(ds)
    r["dict_tables"] = [t.table.numpy().view(np.uint32) for t in dt]
    ds, dout = dsuite.flush(ds)
    r["dict_out"] = host(dout)
    r["dict_fresh"] = convert.sharded_to_numpy(ds)

    # the metrics suite over the warm-up windows, then one window whose
    # last process's rows are all masked (its per-update sum still runs)
    msuite = ShardedMetricsSuite(METRICS_CFG, mesh)
    ms = msuite.init()
    r["m_out"], r["m_scores_local"] = [], []
    for w, mw in enumerate(mwins + [mwins[0]]):
        m = mask if w < len(mwins) else idle_mask()
        mcols_d, mmask_d = process_local_batch(local(mw), m[sl], mesh)
        ms = msuite.update(ms, mcols_d, mmask_d)
        ms, mout = msuite.flush(ms, mcols_d, mmask_d)
        r["m_out"].append(host(mout))
        r["m_scores_local"].append(local_shard(mout.anomaly_scores))
    r["m_state"] = convert.sharded_to_numpy(ms)
    r["m_collectives"] = msuite.collectives

    # the app suite: one whole-state sum at flush
    asuite = ShardedAppSuite(APP_CFG, mesh)
    ast = asuite.update(asuite.init(),
                        *process_local_batch(local(acols), mask[sl], mesh))
    r["app_state"] = convert.sharded_to_numpy(ast)
    ast, aout = asuite.flush(ast)
    r["app_out"] = host(aout)

    mesh2 = make_global_mesh(("dcn_data", "data"), n_local=8 // n_proc,
                             device="cpu")
    r["mesh2"] = (dict(mesh2.shape), mesh2.process_index.tolist())
    return r


if __name__ == "__main__":
    torch.set_num_threads(1)     # two workers beside the other test files
    coord, n_proc, pid, out_path = (sys.argv[1], int(sys.argv[2]),
                                    int(sys.argv[3]), sys.argv[4])
    if n_proc > 1:
        init_distributed(coord, n_proc, pid, timeout_s=60)
    from deepflow_tpu_torch.runtime.tracing import default_tracer
    default_tracer().enable()
    t0 = time.perf_counter()
    res = run(n_proc, pid)
    res["seconds"] = time.perf_counter() - t0
    res["stages"] = default_tracer().latency()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    print("RESULT " + json.dumps({"pid": pid, "seconds": res["seconds"]}))
'''


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _namespace():
    ns = {"__name__": "global_mesh_worker"}
    exec(compile(WORKER, "global_mesh_worker", "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """The worker in two processes over gloo on a free 127.0.0.1 port."""
    tmp = tmp_path_factory.mktemp("global_mesh")
    script = tmp / "worker.py"
    script.write_text(WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK"))}
    env["PYTHONPATH"] = str(REPO)
    procs = [subprocess.Popen(
        [sys.executable, str(script), coord, "2", str(pid),
         str(tmp / f"p{pid}.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]
    try:
        for pid, p in enumerate(procs):
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, f"worker {pid}:\n{err[-4000:]}"
            assert "RESULT " in out, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for pid in range(2):
        with open(tmp / f"p{pid}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def one_process():
    """The port's own 8 shards in this process, the same body."""
    return _namespace()["run"](1, 0)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX suites on the single-process 8-device CPU mesh over the
    same rows and steps (the reference's baseline)."""
    ns = _namespace()
    cols, mwins, acols = ns["make_data"](
        JSCHEMA.columns, jms.ENTROPY_FEATURES + jms.GOLDEN_SIGNALS)
    n = ns["N"]
    mask = np.ones(n, np.bool_)
    mesh = jmake_mesh(8)
    r = {}
    cfg = jfs.FlowSuiteConfig(cms_log2_width=12, ring_size=256,
                              hll_groups=64, hll_precision=8,
                              entropy_log2_buckets=8)
    suite = jsh.ShardedFlowSuite(cfg, mesh)
    st = suite.init()
    for w, m in enumerate((mask, ns["idle_mask"]())):
        st = suite.update(st, *suite.put_batch(cols, m))
        r[f"flow_state{w}"] = _jleaves(st)
        r[f"flow_merged{w}"] = _jleaves(jsh._merge_axis0(st))
        st, out = suite.flush(st)
        r[f"flow_out{w}"] = _jleaves(out)
    mcfg = jms.MetricsSuiteConfig(entropy_log2_buckets=6, mp_length=32,
                                  mp_m=4)
    msuite = jsh.ShardedMetricsSuite(mcfg, mesh)
    ms = msuite.init()
    r["m_out"] = []
    for w, mw in enumerate(mwins + [mwins[0]]):
        m = mask if w < len(mwins) else ns["idle_mask"]()
        mc, mm = msuite.put_batch({k: jnp.asarray(v) for k, v in mw.items()},
                                  jnp.asarray(m))
        ms = msuite.update(ms, mc, mm)
        ms, mout = msuite.flush(ms, mc, mm)
        r["m_out"].append(_jleaves(mout))
    r["m_state"] = _jleaves(ms)
    asuite = jsh.ShardedAppSuite(JAppCfg(groups=16, dd_buckets=128,
                                         dd_alpha=0.05), mesh)
    ast = asuite.update(asuite.init(), *asuite.put_batch(acols, mask))
    r["app_state"] = _jleaves(ast)
    ast, aout = asuite.flush(ast)
    r["app_out"] = _jleaves(aout)
    dsuite = jsh.ShardedFlowSuite(cfg, jmake_mesh(4))
    ds, dt = dsuite.init(), dsuite.init_dict(8192)
    for kind, plane, n in ns["dict_wire"](ns["make_dict_data"](
            JSCHEMA.columns)):
        if kind == "news":
            ds, dt = dsuite.update_news(ds, dt, jnp.asarray(plane),
                                        np.uint32(n))
        else:
            ds = dsuite.update_hits(ds, dt, jnp.asarray(plane),
                                    np.uint32(n))
    r["dict_state"] = _jleaves(ds)
    r["dict_tables"] = np.asarray(dt)
    ds, dout = dsuite.flush(ds)
    r["dict_out"] = _jleaves(dout)
    r["dict_fresh"] = _jleaves(ds)
    return r


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.device_get(tree))]


def _cat(results, key):
    """Both processes' stacked local-shard leaves, in shard order."""
    return [np.concatenate(ls) for ls in zip(*(r[key] for r in results))]


def _assert_leaves(got, want, spec, ctx):
    """Integer leaves exact; float leaves within rtol 1e-4; the PCA basis
    by its projector (rtol 1e-4)."""
    assert len(got) == len(want) == len(spec), ctx
    for (path, dt), a, b in zip(spec, got, want):
        assert a.dtype == b.dtype == np.dtype(dt), (ctx, path)
        if path == "pca.w":
            for d in range(a.shape[0]):
                np.testing.assert_allclose(
                    a[d].astype(np.float64) @ a[d].T,
                    b[d].astype(np.float64) @ b[d].T, rtol=1e-4, atol=1e-5,
                    err_msg=f"{ctx} {path}[{d}]")
        elif np.dtype(dt).kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{ctx} {path}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{ctx} {path}")


def _u32(a):
    return a.view(np.uint32) if a.dtype == np.int32 else a


@pytest.mark.parametrize("baseline", ["jax", "port"])
def test_two_process_flow_suite_matches_one_process(two_processes,
                                                    one_process, jax_run,
                                                    baseline):
    """The flow suite's columns form, a full window then one whose second
    process's rows are all masked: every process's stacked shards,
    merged state and window output equal the 8-shard single process;
    the planted heavy hitter tops the merged ring in both processes."""
    base = jax_run if baseline == "jax" else one_process
    for w in range(2):
        _assert_leaves(_cat(two_processes, f"flow_state{w}"),
                       base[f"flow_state{w}"], convert.SUITE_LEAVES,
                       f"flow state w{w}")
        for r in two_processes:
            _assert_leaves(r[f"flow_merged{w}"], base[f"flow_merged{w}"],
                           convert.SUITE_LEAVES,
                           f"flow merged w{w} p{r['pid']}")
            keys, counts, card, ent, rows = r[f"flow_out{w}"]
            bkeys, bcounts, bcard, bent, brows = base[f"flow_out{w}"]
            np.testing.assert_array_equal(_u32(keys), _u32(bkeys))
            np.testing.assert_array_equal(counts, bcounts)
            np.testing.assert_array_equal(rows, brows)
            np.testing.assert_allclose(card, bcard, rtol=1e-6)
            np.testing.assert_allclose(ent, bent, rtol=0, atol=1e-6)
            assert int(rows) == (4096 if w == 0 else 2048)
            if w == 0:
                assert counts[0] >= 512     # the planted heavy hitter


def test_two_process_plane_and_lanes_forms_match_one_process(
        two_processes, one_process):
    """The full-row plane (masked tail) and the packed lanes (global
    valid count) from each process's own columns: merged state equal to
    the 8-shard single process, leaf for leaf."""
    for r in two_processes:
        for key in ("plane_merged", "lanes_merged"):
            _assert_leaves(r[key], one_process[key], convert.SUITE_LEAVES,
                           f"{key} p{r['pid']}")
        assert int(r["plane_merged"][-2]) == 4096 - 100
        assert int(r["lanes_merged"][-2]) == 4096 - 333


@pytest.mark.parametrize("baseline", ["jax", "port"])
def test_two_process_metrics_suite_matches_one_process(two_processes,
                                                       one_process, jax_run,
                                                       baseline):
    """The metrics suite over the reference's warm-up windows and one
    window whose second process's rows are all masked: entropies within
    abs 1e-5, alarms equal, z within rtol 1e-4; each process's
    `local_shard` of the anomaly scores is its own rows of the single
    process's; the stacked final state (integer leaves exact, the basis
    by its projector) and the matrix profile's ring of merged window sums
    bit for bit. The matrix-profile sum is held within rel 1e-4 of the
    port's one-process run (the reference's two-against-one tolerance).
    Against JAX the scores are not compared: the reference data's window
    sums are nearly constant (uniform draws), and the discord of a
    near-constant series is a difference of near-equal float32 products
    that the two packages round apart by up to the whole score on the
    same ring (ROADMAP Queue 3, the matrix-profile ruling); the ring they
    score is compared instead."""
    base = jax_run if baseline == "jax" else one_process
    for r in two_processes:
        for w, (got, want) in enumerate(zip(r["m_out"], base["m_out"])):
            ent, z, alarm, scores, mp = got
            bent, bz, balarm, bscores, bmp = want
            np.testing.assert_allclose(ent, bent, rtol=0, atol=1e-5,
                                       err_msg=f"w{w}")
            np.testing.assert_allclose(z, bz, rtol=1e-4, atol=1e-4,
                                       err_msg=f"w{w}")
            assert bool(alarm) == bool(balarm), w
            if baseline == "port":
                assert float(mp.sum()) == pytest.approx(
                    float(bmp.sum()), rel=1e-4, abs=1e-6), w
            half = slice(r["pid"] * len(bscores) // 2,
                         (r["pid"] + 1) * len(bscores) // 2)
            np.testing.assert_array_equal(scores, r["m_scores_local"][w])
            np.testing.assert_allclose(scores, bscores[half], rtol=1e-4,
                                       atol=1e-5, err_msg=f"w{w}")
        assert float(base["m_out"][-2][4].sum()) > 0, "the profile is warm"
    state = _cat(two_processes, "m_state")
    _assert_leaves(state, base["m_state"], convert.METRICS_LEAVES,
                   "metrics state")
    # the merged window sums the discord scores read, bit for bit
    ring = [p for p, _ in convert.METRICS_LEAVES].index("mp.ring")
    np.testing.assert_array_equal(state[ring], base["m_state"][ring])


@pytest.mark.parametrize("baseline", ["jax", "port"])
def test_two_process_app_suite_matches_one_process(two_processes,
                                                   one_process, jax_run,
                                                   baseline):
    """The app suite: stacked shards exact, every output field of the
    merged window equal (p95 within rel 1e-5), every request counted."""
    base = jax_run if baseline == "jax" else one_process
    _assert_leaves(_cat(two_processes, "app_state"), base["app_state"],
                   convert.APP_LEAVES, "app state")
    for r in two_processes:
        req, err, ratio, q, hist, zeros = r["app_out"]
        breq, berr, bratio, bq, bhist, bzeros = base["app_out"]
        for a, b in ((req, breq), (err, berr), (hist, bhist),
                     (zeros, bzeros)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(ratio, bratio, rtol=1e-6)
        assert float(q[1].sum()) == pytest.approx(float(bq[1].sum()),
                                                  rel=1e-5)
        assert float(req.sum()) == 4096


def test_two_process_mesh_layout_and_dict_form(two_processes, one_process,
                                               jax_run):
    """The 2-D global mesh has a row per process and a column per local
    shard; the dict form over two processes x 2 shards (every process
    passing the same full news and hits planes) equals, in every shard's
    leaves, the JAX package's single-process 4-device dict form and the
    port's 4 shards in one process (integer leaves exact), every table
    replica in both processes is the reference's, the merged window
    equals it and its top-100 recall is >= 0.99; the per-update PCA sum
    ran once per update (11 windows x 1 batch) and the flush sums once
    per dtype per window; with the tracer on, every collective is a
    `shard.collective` span beside the suites' update, flush and sampled
    put spans."""
    for r in two_processes:
        assert {"shard.update", "shard.flush", "shard.collective",
                "shard.h2d"} <= set(r["stages"])
        # the metrics suite's, 3 for each of the flow suite's 7 merges
        # (two windows' checks and flushes, the plane's and the lanes'
        # checks, the dict form's flush) and one for the app flush
        # (every leaf int32)
        assert r["stages"]["shard.collective"]["count"] == \
            sum(r["m_collectives"]["calls"].values()) + 3 * 7 + 1
        shape, procs = r["mesh2"]
        assert shape == {"dcn_data": 2, "data": 4}
        assert procs == [[0] * 4, [1] * 4]
        calls = r["m_collectives"]["calls"]
        assert calls == {"update": 11, "flush": 22}, calls
    for base in (jax_run, one_process):
        for key in ("dict_state", "dict_fresh"):
            _assert_leaves(_cat(two_processes, key), base[key],
                           convert.SUITE_LEAVES, key)
    table = jax_run["dict_tables"][0]
    assert (jax_run["dict_tables"] == table).all() and table.any()
    for r in [one_process] + two_processes:
        assert len(r["dict_tables"]) == (4 if r is one_process else 2)
        for t in r["dict_tables"]:
            np.testing.assert_array_equal(t, table)
        keys, counts, card, ent, rows = r["dict_out"]
        bkeys, bcounts, bcard, bent, brows = jax_run["dict_out"]
        np.testing.assert_array_equal(_u32(keys), _u32(bkeys))
        np.testing.assert_array_equal(counts, bcounts)
        np.testing.assert_array_equal(rows, brows)
        np.testing.assert_allclose(card, bcard, rtol=1e-6)
        np.testing.assert_allclose(ent, bent, rtol=0, atol=1e-6)
        ns = _namespace()
        cols = ns["make_dict_data"](SKETCH_L4_SCHEMA.columns)
        assert int(rows) == len(cols["ip_src"])
        exact = fold_columns_np([cols[k] for k in (
            "ip_src", "ip_dst", "port_src", "port_dst", "proto")])
        uniq, n = np.unique(exact, return_counts=True)
        top = set(uniq[np.argsort(-n, kind="stable")[:100]].tolist())
        got = set(_u32(keys).tolist())
        assert len(got & top) / 100 >= 0.99


def test_local_shard_single_process():
    """The counterpart of the reference's test: a data-sharded batch
    (process_local_batch's per-shard blocks) comes back whole, in shard
    order; a replicated tensor comes back once, not once per shard."""
    mesh = make_global_mesh(n_local=8, device="cpu")
    x = np.arange(8 * 8, dtype=np.int32)
    cols, masks = process_local_batch({"x": x}, np.ones(64, bool), mesh)
    assert len(cols) == 8
    np.testing.assert_array_equal(local_shard([c["x"] for c in cols]), x)
    np.testing.assert_array_equal(local_shard(masks), np.ones(64, bool))
    np.testing.assert_array_equal(local_shard(torch.from_numpy(x)), x)


def test_two_axis_global_mesh():
    """The counterpart of the reference's test: one process, one host
    row spanning every local shard."""
    mesh = make_global_mesh(("dcn_data", "data"), n_local=8, device="cpu")
    assert mesh.shape == {"dcn_data": 1, "data": 8}
    assert mesh.process_count == 1
    assert mesh.local_indices("data") == tuple(range(8))


def test_schema_and_configs_match_the_reference():
    """The worker draws its columns from the port's schema: the same
    names and dtypes as the reference's."""
    assert [(n, np.dtype(d)) for n, d in SKETCH_L4_SCHEMA.columns] == \
        [(n, np.dtype(d)) for n, d in JSCHEMA.columns]
