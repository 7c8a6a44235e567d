"""The port's zero-copy stagers and host twins against the JAX package's:
the same chunks must give word-for-word equal staged buffers and equal
signatures, aligned and unaligned, one and four batches per group, with
and without a pack pool; the degraded-mode host twins must equal the
reference's; a buffer whose fence has not retired is never reused."""

import numpy as np
import pytest
import torch

from deepflow_tpu.batch import staging as jstaging
from deepflow_tpu.models import flow_dict as jfd
from deepflow_tpu.models import flow_suite as jfs
from deepflow_tpu_torch.batch import staging
from deepflow_tpu_torch.models import flow_dict, flow_suite

CAP = 256


def _chunks(seed, aligned, n_chunks=7):
    """Zipf(1.1) records over a small pool, so the dict wire sees both
    news and hits; unaligned chunk sizes straddle the batch cuts."""
    rng = np.random.default_rng(seed)
    pool = 300
    base = {k: rng.integers(0, 1 << 32, pool, dtype=np.uint64)
            .astype(np.uint32) for k in ("ip_src", "ip_dst")}
    base["port_src"] = rng.integers(1024, 1 << 16, pool).astype(np.uint32)
    base["port_dst"] = rng.choice([53, 80, 443], pool).astype(np.uint32)
    base["proto"] = rng.choice([6, 17], pool).astype(np.uint32)
    out = []
    for i in range(n_chunks):
        n = CAP if aligned else int(rng.integers(1, 3 * CAP))
        pick = (rng.zipf(1.1, n) - 1).clip(max=pool - 1)
        cols = {k: v[pick] for k, v in base.items()}
        cols["packet_tx"] = rng.integers(0, 1 << 16, n).astype(np.uint32)
        cols["packet_rx"] = rng.integers(0, 1 << 16, n).astype(np.uint32)
        out.append(cols)
    return out


def _run(stager, chunks):
    groups = []
    for c in chunks:
        groups += stager.put(c)
    groups += stager.flush()
    for g in groups:
        g.wait_ready(timeout=30)
    return groups


def _pools(workers):
    if not workers:
        return None, None
    return jstaging.PackPool(workers), staging.PackPool(workers)


def _close(*pools):
    for p in pools:
        if p is not None:
            p.close()


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("group_batches", [1, 4])
@pytest.mark.parametrize("workers", [0, 2])
def test_lane_stager_words_match_jax(aligned, group_batches, workers):
    jpool, tpool = _pools(workers)
    try:
        chunks = _chunks(1, aligned)
        jg = _run(jstaging.LaneStager(CAP, group_batches, pool=jpool),
                  chunks)
        tg = _run(staging.LaneStager(CAP, group_batches, pool=tpool),
                  chunks)
    finally:
        _close(jpool, tpool)
    assert len(tg) == len(jg) > 0
    for a, b in zip(tg, jg):
        assert (a.k, a.capacity, a.valid) == (b.k, b.capacity, b.valid)
        assert a.flat.dtype == b.flat.dtype == np.uint32
        np.testing.assert_array_equal(a.flat, b.flat)
    assert sum(g.valid for g in tg) == sum(len(c["ip_src"]) for c in chunks)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("group_batches", [1, 4])
@pytest.mark.parametrize("workers", [0, 2])
def test_dict_stager_words_match_jax(aligned, group_batches, workers):
    jpool, tpool = _pools(workers)
    try:
        chunks = _chunks(2, aligned)
        js = jstaging.DictWireStager(
            CAP, lambda: jfd.FlowDictPacker(capacity=1024, hits_batch=CAP),
            group_batches, pool=jpool)
        ts = staging.DictWireStager(
            CAP, lambda: flow_dict.FlowDictPacker(capacity=1024,
                                                  hits_batch=CAP),
            group_batches, pool=tpool)
        jg, tg = _run(js, chunks), _run(ts, chunks)
    finally:
        _close(jpool, tpool)
    assert len(tg) == len(jg) > 0
    for a, b in zip(tg, jg):
        assert a.sig == b.sig
        assert (a.k, a.valid, a.epoch) == (b.k, b.valid, b.epoch)
        np.testing.assert_array_equal(a.flat, b.flat)
    np.testing.assert_array_equal(ts.mirror, js.mirror)
    assert ts.counters()["staged_batches"] == js.counters()["staged_batches"]
    # a restore bumps the generation on both sides alike
    assert ts.reset_packer() == js.reset_packer()
    assert ts.epoch == js.epoch == 1


def test_unpack_lanes_np_matches_jax():
    (cols,) = _chunks(3, aligned=True, n_chunks=1)
    plane = np.zeros((4, CAP + 100), np.uint32)
    flow_suite.pack_lanes_into(cols, plane[:, :CAP])
    got = flow_suite.unpack_lanes_np(plane, CAP - 7)
    ref = jfs.unpack_lanes_np(plane, CAP - 7)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == np.asarray(ref[k]).dtype
        np.testing.assert_array_equal(got[k], ref[k])


def test_mirror_and_unpack_wire_np_match_jax():
    packer = flow_dict.FlowDictPacker(capacity=1024, hits_batch=CAP,
                                      news_batch=128)
    tmirror = np.zeros((4, 1024), np.uint32)
    jmirror = np.zeros((4, 1024), np.uint32)
    for cols in _chunks(4, aligned=False, n_chunks=4):
        wire = packer.pack(cols) + packer.flush()
        flow_dict.mirror_news_np(wire, tmirror)
        jfd.mirror_news_np(wire, jmirror)
        np.testing.assert_array_equal(tmirror, jmirror)
        sig = flow_dict.wire_signature(wire)
        flat = np.zeros(flow_dict.wire_words(sig), np.uint32)
        flow_dict.stage_wire(wire, flat)
        got = flow_dict.unpack_wire_np(flat, sig, tmirror)
        ref = jfd.unpack_wire_np(flat, sig, jmirror)
        assert [n for _, n in got] == [n for _, n in ref]
        assert sum(n for _, n in got) == len(cols["ip_src"])
        for (gc, _), (rc, _) in zip(got, ref):
            for k in rc:
                np.testing.assert_array_equal(gc[k], rc[k])


class _Fence:
    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done


@pytest.mark.parametrize("kind", ["lanes", "dict"])
def test_recycle_waits_for_the_fence(kind):
    """A buffer whose fence the device has not passed is refused
    (counted) and never handed out again; a retired one is reused."""
    if kind == "lanes":
        st = staging.LaneStager(CAP)
    else:
        st = staging.DictWireStager(
            CAP, lambda: flow_dict.FlowDictPacker(capacity=1024,
                                                  hits_batch=CAP))
    g1, g2 = _run(st, _chunks(5, aligned=True, n_chunks=2))
    g1.fence, g2.fence = _Fence(False), _Fence(True)
    st.recycle(g1)
    st.recycle(g2)
    c = st.counters()
    assert c["staging_recycle_refused"] == 1 and c["staging_recycled"] == 1
    (g3,) = _run(st, _chunks(6, aligned=True, n_chunks=1))
    assert g3.buffer is g2.buffer and g3.buffer is not g1.buffer
    assert st.counters()["staging_pool_hits"] == 1


def test_pinned_buffers_are_views_of_pinned_tensors(monkeypatch):
    """On a CUDA exporter the stagers ask for page-locked memory and
    stage into a uint32 view of it."""
    seen = []
    real_empty = torch.empty

    def fake_empty(*a, **kw):
        seen.append(kw.get("pin_memory"))
        kw.pop("pin_memory", None)
        return real_empty(*a, **kw)

    monkeypatch.setattr(staging.torch, "empty", fake_empty)
    st = staging.LaneStager(CAP, pinned=True)
    (g,) = _run(st, _chunks(7, aligned=True, n_chunks=1))
    assert seen == [True]
    assert g.flat.dtype == np.uint32 and isinstance(g.flat.base, np.ndarray)
    plain = staging.alloc_words(16, pinned=False)
    assert plain.dtype == np.uint32 and seen == [True]
