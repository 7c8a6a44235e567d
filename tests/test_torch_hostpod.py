"""The port's cross-host pod (`parallel/multihost.py`) against the JAX
`HostPodCoordinator`, both over their `SimulatedDcnTransport`.

One test for each runtime case of the reference's `tests/test_hostpod.py`
(merge equivalence, marker loss, partition and heal, host kill and
rejoin by snapshot, ingest to a lost host, the anomaly plane forced
lossy on a missing host, the exporter's `pod_hosts` branch), both
coordinators fed the same planes and the same fault spec: the merged
window outputs (integer fields exact, float fields within rtol 1e-5 /
atol 1e-6), the merged bus leaves and tags, the `EpochResult` fields
and every counter but the merge time. Beside them:

- the collective close (`_close_epoch_collective`) of both packages
  through one loopback transport standing in for host 0 of 2: with one
  outbox entry the exchanged leaves and the merge are equal; with two
  entries (a `snapshot_host` before the close) both packages sum every
  leaf, seeds and HLL registers included, and so merge a sketch under
  doubled seeds (ROADMAP Queue 3: a divergence of the reference, to be
  ruled on; the port keeps it); and with an empty local box beside a
  peer that delivered rows, its leaves crossing as the port's collective
  wire carries them (32-bit words read with the local dtypes);
- two processes joined over gloo (`init_distributed`,
  `TorchDcnTransport`), each one host of 2 shards fed its own hosts'
  rows, or process 1 none: each process's merged output and merged bus
  leaves equal the single-process coordinator's over the simulated DCN.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from deepflow_tpu.models import flow_suite as jfs
from deepflow_tpu.parallel import HostPodCoordinator as JCoord
from deepflow_tpu.replay import SyntheticAgent
from deepflow_tpu.runtime.faults import default_faults as jfaults
from deepflow_tpu_torch.models import flow_suite
from deepflow_tpu_torch.parallel import HostPodCoordinator, PodFlowSuite
from deepflow_tpu_torch.parallel.multihost import (from_words, route_hosts,
                                                  to_words)
from deepflow_tpu_torch.runtime.faults import default_faults as tfaults

REPO = Path(__file__).resolve().parent.parent
F32 = dict(rtol=1e-5, atol=1e-6)
_SMALL = dict(cms_log2_width=10, ring_size=128, top_k=20, hll_groups=32,
              hll_precision=6, entropy_log2_buckets=8)
CFG, JCFG = flow_suite.FlowSuiteConfig(**_SMALL), jfs.FlowSuiteConfig(**_SMALL)
B = 1024
KEEP = ("ip_src", "ip_dst", "port_src", "port_dst", "proto", "packet_tx",
        "packet_rx")


def _plane(agent, n=B):
    cols = agent.l4_columns_pooled(n)
    lanes = flow_suite.pack_lanes({k: cols[k].astype(np.uint32)
                                   for k in KEEP})
    return np.stack([lanes[k] for k in flow_suite.SKETCH_LANE_NAMES])


def _coords(**kw):
    """(port coordinator on the CPU, JAX coordinator), 2 hosts of 2
    shards over the simulated DCN unless kw says otherwise."""
    kw.setdefault("n_hosts", 2)
    kw.setdefault("shards_per_host", 2)
    kw.setdefault("transport", "sim")
    kw.setdefault("dcn_marker_deadline_s", 5.0)
    kw.setdefault("merge_deadline_s", 5.0)
    return HostPodCoordinator(CFG, device="cpu", **kw), JCoord(JCFG, **kw)


def _put(coords, plane, n=B):
    for co in coords:
        co.put_lanes(plane.copy(), n)


def _conserve(co):
    c = co.counters()
    assert c["pod_rows_sent"] == (c["pod_rows_delivered"]
                                  + c["pod_rows_host"] + c["pod_rows_lost"]
                                  + c["pod_rows_pending"]), c
    return c


def _assert_counters(t, j, ctx=""):
    tc, jc = _conserve(t), _conserve(j)
    want = {k: v for k, v in jc.items() if k != "pod_merge_epoch_s"}
    assert {k: tc[k] for k in want} == want, ctx
    return tc


def _assert_out(t, j, ctx=""):
    if j is None:
        assert t is None, ctx
        return
    np.testing.assert_array_equal(t.topk_keys.numpy().view(np.uint32),
                                  np.asarray(j.topk_keys), err_msg=ctx)
    for name in ("topk_counts", "rows"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=f"{ctx} {name}")
    for name in ("service_cardinality", "entropies"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)),
                                   err_msg=f"{ctx} {name}", **F32)


def _assert_result(tr, jr, ctx=""):
    for f in ("epoch", "participated", "missed", "degraded", "lost",
              "merged_rows", "lossy", "tags"):
        assert getattr(tr, f) == getattr(jr, f), (ctx, f, tr, jr)
    _assert_out(tr.out, jr.out, ctx)


def _assert_leaves(a_leaves, b_leaves, ctx=""):
    assert len(a_leaves) == len(b_leaves), ctx
    for i, (a, b) in enumerate(zip(a_leaves, b_leaves)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx} leaf {i}")


def _assert_bus(t, j, ctx=""):
    ts, js = t.bus.latest(), j.bus.latest()
    assert (ts is None) == (js is None), ctx
    if ts is not None:
        assert ts.step == js.step and ts.tags == js.tags, ctx
        _assert_leaves(ts.leaves, js.leaves, ctx)


def _close(coords, **kw):
    for co in coords:
        co.close(**kw)


@pytest.fixture
def faults():
    armed = []

    def arm(spec):
        armed.extend(tfaults().arm_spec(spec))
        jfaults().arm_spec(spec)
    yield arm
    for site in armed:
        tfaults().disarm(site)
        jfaults().disarm(site)


def _warm(coords, agent):
    """A fault-free first epoch (the reference's jit warm-up)."""
    _put(coords, _plane(agent))
    for co in coords:
        assert co.drain(30)
    tr, jr = (co.close_epoch() for co in coords)
    _assert_result(tr, jr, "warm epoch")
    assert tr.missed == []


# -- equivalence ----------------------------------------------------------

def test_hostpod_merge_matches_single_pod_and_jax():
    """No faults: the 2-host merged epoch meets the reference's contract
    against a 4-shard pod over the same rows (rows, entropies, the top-K
    head, every surviving key priced as the flat merge prices it), and
    equals the JAX coordinator's merge leaf for leaf."""
    agent = SyntheticAgent(seed=11)
    planes = [_plane(agent) for _ in range(3)]
    ref = PodFlowSuite(CFG, n_shards=4, merge_deadline_s=5.0, device="cpu")
    for p in planes:
        ref.put_lanes(p.copy(), B)
    assert ref.drain(30)
    ref_res = ref.close_epoch()
    ref.close(final_epoch=False)

    coords = t, j = _coords()
    try:
        for p in planes:
            _put(coords, p)
        assert t.drain(30) and j.drain(30)
        res, jres = t.close_epoch(), j.close_epoch()
        _assert_result(res, jres)
        _assert_bus(t, j)
        c = _assert_counters(t, j)
    finally:
        _close(coords, final_epoch=False)
    assert res.merged_rows == ref_res.merged_rows == 3 * B
    assert c["pod_rows_delivered"] == 3 * B
    assert res.tags["pod_hosts_participated"] == 2
    assert res.tags["pod_hosts_missing"] == [] and not res.lossy
    r_out, h_out = ref_res.out, res.out
    np.testing.assert_allclose(h_out.entropies.numpy(),
                               r_out.entropies.numpy(), atol=1e-5)
    ref_counts = dict(zip(r_out.topk_keys.tolist(),
                          r_out.topk_counts.tolist()))
    np.testing.assert_array_equal(h_out.topk_keys[:8], r_out.topk_keys[:8])
    np.testing.assert_array_equal(h_out.topk_counts[:8],
                                  r_out.topk_counts[:8])
    for k, n in zip(h_out.topk_keys.tolist(), h_out.topk_counts.tolist()):
        if k in ref_counts:
            assert n == ref_counts[k], (k, n, ref_counts[k])


# -- the fault ladders ------------------------------------------------------

def test_marker_loss_excludes_host_then_recovers(faults):
    """A lost marker excludes the whole host past the DCN deadline
    (counted, tagged lossy); the next marker recovers every row."""
    coords = t, j = _coords()
    agent = SyntheticAgent(seed=3)
    try:
        _warm(coords, agent)
        faults("dcn.marker_loss:count=1,match=host1;seed=7")
        _put(coords, _plane(agent))
        assert t.drain(30) and j.drain(30)
        res, jres = t.close_epoch(deadline_s=0.6), j.close_epoch(
            deadline_s=0.6)
        _assert_result(res, jres, "excluded")
        assert res.missed == [1] and res.lossy
        assert res.tags["pod_hosts_missing"] == [1]
        c = _assert_counters(t, j, "excluded")
        assert c["pod_hosts_missed"] == 1 and c["dcn_markers_lost"] == 1
        assert c["pod_host_rows_excluded"] > 0 and c["pod_rows_pending"] > 0
        res, jres = t.close_epoch(), j.close_epoch()
        _assert_result(res, jres, "recovered")
        _assert_bus(t, j, "recovered")
        assert res.missed == [] and res.tags["pod_hosts_participated"] == 2
    finally:
        _close(coords, final_epoch=False)
    c = _assert_counters(t, j)
    assert c["pod_rows_delivered"] == c["pod_rows_sent"] == 2 * B
    assert c["pod_rows_pending"] == 0


def test_partition_holds_contribution_until_heal(faults):
    """A severed link HOLDS messages: the epoch excludes the host, heal
    releases the held contribution and it merges late; nothing lost."""
    coords = t, j = _coords()
    agent = SyntheticAgent(seed=5)
    try:
        _warm(coords, agent)
        faults("dcn.partition:count=1,match=host1;seed=7")
        _put(coords, _plane(agent))
        assert t.drain(30) and j.drain(30)
        res, jres = t.close_epoch(deadline_s=0.6), j.close_epoch(
            deadline_s=0.6)
        _assert_result(res, jres, "partitioned")
        assert res.missed == [1] and res.lossy
        c = _assert_counters(t, j, "partitioned")
        assert c["dcn_partitions"] == 1 and c["dcn_links_down"] == 1
        assert c["dcn_held_messages"] >= 1
        t.transport.heal(1)
        j.transport.heal(1)
        res, jres = t.close_epoch(), j.close_epoch()
        _assert_result(res, jres, "healed")
        _assert_bus(t, j, "healed")
        assert res.tags["pod_hosts_participated"] == 2
    finally:
        _close(coords, final_epoch=False)
    c = _assert_counters(t, j)
    assert c["dcn_heals"] == 1 and c["dcn_links_down"] == 0
    assert c["pod_host_late_merges"] >= 1
    assert c["pod_rows_delivered"] == c["pod_rows_sent"] == 2 * B
    assert c["pod_rows_pending"] == 0


def test_host_kill_rejoins_by_snapshot(faults):
    """host.lost fires inside host 1's agent: the epoch counts the host
    lost, the boundary rejoin re-ships its outbox, and what was locally
    closed before the kill delivers late."""
    coords = t, j = _coords()
    agent = SyntheticAgent(seed=9)
    try:
        _warm(coords, agent)
        _put(coords, _plane(agent))
        assert t.drain(30) and j.drain(30)
        assert t.snapshot_host(1) == j.snapshot_host(1) > 0
        faults("host.lost:count=1,match=host1;seed=7")
        res, jres = t.close_epoch(deadline_s=0.6), j.close_epoch(
            deadline_s=0.6)
        _assert_result(res, jres, "killed")
        assert res.lossy and (res.missed == [1] or res.lost == [1])
        c = _assert_counters(t, j, "killed")
        assert c["pod_hosts_killed"] == 1
        res, jres = t.close_epoch(), j.close_epoch()
        _assert_result(res, jres, "rejoined")
        assert res.lost == [1]
        c = _assert_counters(t, j, "rejoined")
        assert c["pod_host_rejoins"] == 1
        assert all(h["status"] == "active" for h in t.host_status())
        _close(coords)
        _assert_bus(t, j, "final")
    finally:
        _close(coords, final_epoch=False)
    c = _assert_counters(t, j)
    assert c["pod_rows_pending"] == 0 and c["pod_host_late_merges"] >= 1
    assert c["pod_rows_delivered"] + c["pod_rows_lost"] == 2 * B
    assert c["pod_rows_delivered"] > B


def test_ingest_to_lost_host_drops_counted():
    coords = t, j = _coords(auto_rejoin=False)
    agent = SyntheticAgent(seed=13)
    try:
        for co in coords:
            co.kill_host(1)
        _put(coords, _plane(agent))
        assert t.drain(30) and j.drain(30)
        res, jres = t.close_epoch(), j.close_epoch()
        _assert_result(res, jres)
        c = _assert_counters(t, j)
        assert c["pod_rows_lost"] > 0 and c["pod_rows_delivered"] > 0
        assert c["pod_rows_lost"] + c["pod_rows_delivered"] == B
        st = {h["host"]: h for h in t.host_status()}
        assert st[1]["status"] == "lost" and st[1]["rows_dropped"] > 0
        assert [h["rows_dropped"] for h in t.host_status()] == \
            [h["rows_dropped"] for h in j.host_status()]
        sh = {s["shard"]: s["status"] for s in t.shard_status()}
        assert all(v == "lost" for k, v in sh.items() if k >= 2)
    finally:
        _close(coords, final_epoch=False)
    _assert_counters(t, j)


# -- honest degradation above the pod ---------------------------------------

def test_anomaly_window_forced_lossy_on_missing_host():
    """A window whose merge excluded a whole host scores lossy whatever
    the caller said, and the alert carries the host keys, as the JAX
    plane's does."""
    import torch

    from deepflow_tpu.anomaly import AnomalyConfig as JCfg
    from deepflow_tpu.anomaly import AnomalyPlane as JPlane
    from deepflow_tpu.models.flow_suite import FlowWindowOutput as JOut
    from deepflow_tpu_torch.anomaly import AnomalyConfig, AnomalyPlane

    def outs(rows, ent):
        counts = np.zeros(CFG.top_k, np.int32)
        counts[0] = rows // 8
        host = dict(topk_keys=np.zeros(CFG.top_k, np.uint32),
                    topk_counts=counts,
                    service_cardinality=np.asarray([100.0], np.float32),
                    entropies=np.asarray(ent, np.float32),
                    rows=np.asarray(rows, np.int32))
        tout = flow_suite.FlowWindowOutput(**{
            k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                                else v) for k, v in host.items()})
        return tout, JOut(**host)

    knobs = dict(warmup_windows=2, entropy_z=0.0, pca_z=1e9,
                 mp_threshold=1e9)
    tplane = AnomalyPlane(AnomalyConfig(**knobs), device="cpu")
    jplane = JPlane(JCfg(**knobs))
    for w in range(4):
        tout, jout = outs(4000, [0.8, 0.5, 0.9, 0.3])
        tplane.close_window(tout, now=100.0 + w)
        jplane.close_window(jout, now=100.0 + w)
        tplane.publish_pending()
        jplane.publish_pending()
    part = {"pod_hosts": 2, "pod_hosts_participated": 1,
            "pod_hosts_missing": [1]}
    tout, jout = outs(4000, [0.8, 0.5, 0.9, 0.3])
    talerts = tplane.close_window(tout, now=200.0, lossy=False,
                                  participation=part)
    jalerts = jplane.close_window(jout, now=200.0, lossy=False,
                                  participation=part)
    tplane.publish_pending()
    jplane.publish_pending()
    assert talerts and len(talerts) == len(jalerts)
    for a, b in zip(talerts, jalerts):
        assert a.detector == b.detector and a.lossy and b.lossy
        assert a.participation == b.participation == part
    assert tplane.bus.latest().tags["lossy"]
    assert tplane.bus.latest().tags["pod_hosts_missing"] == [1]


def test_exporter_pod_hosts_matches_jax_exporter():
    """pod_hosts=2 through the exporter: the cross-host merged window and
    its bus snapshot (host participation tags) equal the JAX exporter's,
    the JAX serving tables read the port's bus with host columns, and
    the ledger closes at exporter close."""
    from deepflow_tpu.batch.schema import L4_SCHEMA
    from deepflow_tpu.runtime.tpu_sketch import TpuSketchExporter as JExp
    from deepflow_tpu.serving import SketchTables, SnapshotCache
    from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter

    knobs = dict(window_seconds=3600, batch_rows=B, pod_shards=2,
                 pod_hosts=2, dcn_transport="sim", pod_merge_deadline_s=5.0)
    texp = TpuSketchExporter(cfg=CFG, device="cpu", **knobs)
    jexp = JExp(store=None, cfg=JCFG, **knobs)
    assert hasattr(texp.pod, "host_status")
    cache = SnapshotCache(texp.snapshot_bus, max_staleness_s=3600)
    tables = SketchTables(cache)
    rng = np.random.default_rng(0)
    cols = {name: rng.integers(0, 1 << 10, 2 * B).astype(dt)
            for name, dt in L4_SCHEMA.columns}
    try:
        texp.process([("l4_flow_log", 0, dict(cols), -1)])
        jexp.process([("l4_flow_log", 0, dict(cols))])
        assert texp.pod.drain(30) and jexp.pod.drain(30)
        tout = texp.flush_window(now=1000.0)
        jout = jexp.flush_window(now=1000.0)
        _assert_out(tout, jout)
        _assert_bus(texp.pod, jexp.pod)
        snap = cache.latest()
        assert snap.tags["pod_hosts"] == 2
        assert snap.tags["pod_hosts_participated"] == 2
        assert snap.tags["pod_hosts_missing"] == []
        rows = tables.topk(5)
        assert rows and rows[0]["hosts_active"] == 2
        assert rows[0]["hosts_missing"] == []
    finally:
        texp.close()
        jexp.close()
        cache.close()
    c = texp.counters()
    assert c["pod_rows_pending"] == 0
    assert c["pod_rows_sent"] == c["pod_rows_delivered"] == 2 * B


# -- the collective close -----------------------------------------------------

class _LoopDcn:
    """A collective transport of one process standing in for host 0 of
    2. The peer host contributes nothing, or `peer` (leaves, rows); with
    `words` the peer's leaves cross as `TorchDcnTransport` carries them,
    32-bit words read back with host 0's leaf dtypes. Keeps what host 0
    shipped."""

    collective = True
    n_hosts = 2
    local_host = 0

    def __init__(self, peer=None, words=False):
        self.peer, self.words = peer, words

    def exchange(self, leaves, rows):
        self.shipped = [np.array(a) for a in leaves]
        if self.peer is None:
            return [tuple(leaves), tuple(np.zeros_like(a) for a in leaves)
                    ], [rows, 0]
        other, other_rows = self.peer
        if self.words:
            other, other_rows = from_words(to_words(other, other_rows),
                                           self.shipped)
        return [tuple(leaves), tuple(other)], [rows, other_rows]

    def quiet(self):
        return True

    def counters(self):
        return {}

    def close(self):
        pass


def _host0_planes(agent, batches):
    """Planes of host 0's rows only (host 1's lane would hold the rest
    pending forever: in a collective run it is another process's)."""
    out = []
    for _ in range(batches):
        p = _plane(agent)
        mine = np.ascontiguousarray(p[:, route_hosts(p, B, 2) == 0])
        out.append(mine)
    return out


@pytest.mark.parametrize("entries", [1, 2])
def test_collective_close_matches_jax(entries):
    """The collective close of both packages through the loopback
    transport. One outbox entry: the shipped leaves, the merged output
    and the bus equal. Two entries (a snapshot_host of the local host
    before the close, reachable in a collective run): both packages sum
    every leaf, wrapping to 32 bits, so the merged sketch carries doubled
    hash seeds (ROADMAP Queue 3); the port keeps the reference's
    behaviour, and this test shows it."""
    knobs = dict(n_hosts=2, shards_per_host=2, merge_deadline_s=5.0)
    coords = t, j = (
        HostPodCoordinator(CFG, transport=_LoopDcn(), device="cpu", **knobs),
        JCoord(JCFG, transport=_LoopDcn(), **knobs))
    planes = _host0_planes(SyntheticAgent(seed=29), 4)
    try:
        for i, p in enumerate(planes):
            _put(coords, p, p.shape[1])
            if entries == 2 and i == 1:
                for co in coords:
                    assert co.drain(30)
                assert t.snapshot_host(0) == j.snapshot_host(0) > 0
        for co in coords:
            assert co.drain(30)
        res, jres = t.close_epoch(), j.close_epoch()
        _assert_result(res, jres)
        _assert_bus(t, j)
        tship, jship = t.transport.shipped, j.transport.shipped
        # the reference's sum widens to 64 bits; its device put wraps it
        _assert_leaves(tship, [np.asarray(b).astype(a.dtype)
                               for a, b in zip(tship, jship)])
        seeds = flow_suite.init(CFG, "cpu").sketch.seeds.numpy().view(
            np.uint32)
        np.testing.assert_array_equal(tship[1], seeds * np.uint32(entries))
        assert res.merged_rows == sum(p.shape[1] for p in planes)
        c = _assert_counters(t, j)
        assert c["pod_rows_pending"] == 0
    finally:
        _close(coords, final_epoch=False)


def test_collective_close_of_an_idle_host_matches_jax():
    """The local host delivered no rows in the epoch and its peer did:
    the local box ships uint32 zeros whatever the leaf's dtype, so over
    the port's collective wire the peer's int32 leaves decode as uint32.
    The port's merge reads them with the reference dtypes, and its
    output, bus and counters equal the JAX coordinator's, whose peer
    leaves arrive typed."""
    knobs = dict(n_hosts=2, shards_per_host=2, merge_deadline_s=5.0)
    src = HostPodCoordinator(CFG, transport=_LoopDcn(), device="cpu",
                             **knobs)
    planes = _host0_planes(SyntheticAgent(seed=37), 2)
    try:
        for p in planes:
            src.put_lanes(p.copy(), p.shape[1])
        assert src.drain(30)
        src.close_epoch()
    finally:
        src.close(final_epoch=False)
    peer = (src.transport.shipped, sum(p.shape[1] for p in planes))
    assert {a.dtype for a in peer[0]} == {np.dtype(np.int32),
                                          np.dtype(np.uint32)}
    coords = t, j = (
        HostPodCoordinator(CFG, transport=_LoopDcn(peer, words=True),
                           device="cpu", **knobs),
        JCoord(JCFG, transport=_LoopDcn(peer), **knobs))
    try:
        res, jres = t.close_epoch(), j.close_epoch()
        assert all(a.dtype == np.uint32 for a in t.transport.shipped)
        assert res.participated == [1] and res.merged_rows == peer[1]
        _assert_result(res, jres)
        _assert_bus(t, j)
        _assert_counters(t, j)
    finally:
        _close(coords, final_epoch=False)


# -- two processes over torch.distributed -------------------------------------

WORKER = r"""
import hashlib, json, sys
import numpy as np
coordinator, pid, path, cfg, idle = sys.argv[1], int(sys.argv[2]), \
    sys.argv[3], json.loads(sys.argv[4]), sys.argv[5] == "1"
import torch
import torch.distributed as dist
torch.set_num_threads(1)     # two workers beside the other test files
from deepflow_tpu_torch.models.flow_suite import FlowSuiteConfig
from deepflow_tpu_torch.parallel import (HostPodCoordinator,
                                         TorchDcnTransport, init_distributed)
from deepflow_tpu_torch.parallel.multihost import route_hosts
assert init_distributed(coordinator, 2, pid, timeout_s=60) == 2
co = HostPodCoordinator(FlowSuiteConfig(**cfg), n_hosts=2, shards_per_host=2,
                        transport="auto", device="cpu")
assert isinstance(co.transport, TorchDcnTransport)
for plane in np.load(path) if not (idle and pid == 1) else ():
    n = plane.shape[1]
    mine = np.ascontiguousarray(plane[:, route_hosts(plane, n, 2) == pid])
    co.put_lanes(mine, mine.shape[1])
assert co.drain(30)
res = co.close_epoch()
c = co.counters()
co.close(final_epoch=False)
dist.destroy_process_group()
out = res.out
print("RESULT " + json.dumps({
    "pid": pid, "rows": res.merged_rows, "participated": res.participated,
    "keys": out.topk_keys.numpy().view(np.uint32).tolist(),
    "counts": out.topk_counts.tolist(),
    "card": out.service_cardinality.tolist(),
    "ent": out.entropies.tolist(),
    "bus": [hashlib.sha256(a.tobytes()).hexdigest()
            for a in co.bus.latest().leaves],
    "sent": c["pod_rows_sent"], "delivered": c["pod_rows_delivered"],
    "pending": c["pod_rows_pending"]}))
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_processes_over_gloo_match_the_simulated_dcn(tmp_path):
    """Two processes, one host of 2 shards each, joined over gloo at
    tcp://127.0.0.1: each one's merged epoch (output and merged bus
    leaves) equals the single-process coordinator's over the simulated
    DCN on the same rows. Workers are killed on the way out."""
    _gloo_pair(tmp_path, idle=False)


def test_two_processes_over_gloo_with_an_idle_host(tmp_path):
    """As above, but process 1 is given no rows and ships an empty box
    (uint32 zeros): both processes still merge process 0's rows, equal
    to the simulated DCN fed only those."""
    _gloo_pair(tmp_path, idle=True)


def _gloo_pair(tmp_path, idle):
    agent = SyntheticAgent(seed=31)
    planes = np.stack([_plane(agent) for _ in range(3)])
    path = tmp_path / "planes.npy"
    np.save(path, planes)
    fed = [np.ascontiguousarray(p[:, route_hosts(p, B, 2) == 0])
           if idle else p for p in planes]
    co = HostPodCoordinator(CFG, n_hosts=2, shards_per_host=2,
                            transport="sim", device="cpu")
    try:
        for p in fed:
            co.put_lanes(p.copy(), p.shape[1])
        assert co.drain(30)
        ref = co.close_epoch()
        ref_bus = [hashlib.sha256(a.tobytes()).hexdigest()
                   for a in co.bus.latest().leaves]
    finally:
        co.close(final_epoch=False)

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK"))}
    env["PYTHONPATH"] = str(REPO)
    coord = f"127.0.0.1:{_free_port()}"
    workers = [subprocess.Popen(
        [sys.executable, "-c", WORKER, coord, str(pid), str(path),
         json.dumps(_SMALL), "1" if idle else "0"], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    results = []
    deadline = time.monotonic() + 110
    try:
        for w in workers:
            out, err = w.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert w.returncode == 0, err[-4000:]
            line = next(x for x in out.splitlines()
                        if x.startswith("RESULT "))
            results.append(json.loads(line[len("RESULT "):]))
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
    assert sorted(r["pid"] for r in results) == [0, 1]
    rows = sum(p.shape[1] for p in fed)
    for r in results:
        assert r["rows"] == ref.merged_rows == rows
        assert r["participated"] == ([0] if idle else [0, 1])
        assert r["keys"] == ref.out.topk_keys.numpy().view(np.uint32).tolist()
        assert r["counts"] == ref.out.topk_counts.tolist()
        assert r["card"] == ref.out.service_cardinality.tolist()
        assert r["ent"] == ref.out.entropies.tolist()
        assert r["bus"] == ref_bus
        assert r["sent"] == r["delivered"] and r["pending"] == 0
    assert sum(r["sent"] for r in results) == rows


@pytest.fixture
def tracers():
    """Both packages' process tracers, emptied and enabled; disabled and
    emptied again after the test."""
    from deepflow_tpu.runtime.tracing import default_tracer as jtracer
    from deepflow_tpu_torch.runtime.tracing import default_tracer as ttracer
    both = (ttracer(), jtracer())
    for tr in both:
        tr.reset()
        tr.enable()
    yield both
    for tr in both:
        tr.disable()
        tr.reset()


def test_hostpod_tracer_gauges_match_jax(faults, tracers):
    """Each global epoch close sets pod_hosts_active, pod_hosts_missed
    and pod_merge_epoch_s under the tracer, as the JAX coordinator does;
    a lost marker reads one host missed."""
    coords = t, j = _coords()
    tt, jt = tracers
    names = ("pod_hosts_active", "pod_hosts_missed", "pod_shards_active",
             "pod_merge_missed")
    agent = SyntheticAgent(seed=3)
    try:
        _warm(coords, agent)
        tg, jg = tt.gauges(), jt.gauges()
        assert {k: tg[k] for k in names} == {k: jg[k] for k in names}
        assert tg["pod_hosts_active"] == 2.0 and tg["pod_hosts_missed"] == 0
        faults("dcn.marker_loss:count=1,match=host1;seed=7")
        _put(coords, _plane(agent))
        assert t.drain(30) and j.drain(30)
        t.close_epoch(deadline_s=0.6)
        j.close_epoch(deadline_s=0.6)
        tg, jg = tt.gauges(), jt.gauges()
        assert {k: tg[k] for k in names} == {k: jg[k] for k in names}
        assert tg["pod_hosts_missed"] == 1.0
        assert tg["pod_merge_epoch_s"] > 0
    finally:
        _close(coords, final_epoch=False)
