"""The deepflow_tpu_torch l4 sketch step as a whole against the JAX
package, on identical numpy records and identical starting state (moved
across with `convert`): full-row `update`, the coalesced lane program
(K=1 and K=3), and the dict wire through `make_wire_update`, each over 2
windows with a flush between. Every integer leaf must be equal; float32
window outputs (entropies, HLL estimates) agree within rtol=1e-5,
atol=1e-6 (XLA-CPU and ATen round log/sqrt and float sums apart in the
last ulp). Per-batch histogram cell sums stay below 2^24, the bound
inside which the reference's f32 kernels are exact.

The port runs with device="cpu" here, fused kernels through their plain
versions (fused_hists=True) or the unfused ops (None)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepflow_tpu.models import flow_dict as jfd
from deepflow_tpu.models import flow_suite as jfs
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.models import flow_dict, flow_suite
from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter

F32_TOL = dict(rtol=1e-5, atol=1e-6)
_SMALL = dict(cms_log2_width=12, ring_size=256, hll_groups=64,
              hll_precision=8, entropy_log2_buckets=10)


def _cfgs(fused=None):
    return jfs.FlowSuiteConfig(**_SMALL), \
        flow_suite.FlowSuiteConfig(**_SMALL, fused_hists=fused)


def _records(rng, n, pool=600):
    """n l4 records drawn by Zipf(1.1) from a pool of in-range 5-tuples."""
    base = {
        "ip_src": rng.integers(0, 1 << 32, pool, dtype=np.uint64),
        "ip_dst": rng.integers(0, 1 << 32, pool, dtype=np.uint64),
        "port_src": rng.integers(1024, 1 << 16, pool),
        "port_dst": rng.choice([53, 80, 443, 3306, 8080], pool),
        "proto": rng.choice([6, 17], pool),
    }
    pick = (rng.zipf(1.1, n) - 1).clip(max=pool - 1)
    cols = {k: v[pick].astype(np.uint32) for k, v in base.items()}
    cols["packet_tx"] = rng.integers(0, 50000, n).astype(np.uint32)
    cols["packet_rx"] = rng.integers(0, 50000, n).astype(np.uint32)
    return cols


def _bits(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _start(jcfg, device="cpu"):
    """A fresh JAX state and the port's copy of it (via convert)."""
    js = jfs.init(jcfg)
    ts, _ = convert.state_from_numpy(jax.device_get(js), device=device)
    return js, ts


def _assert_state_equal(ts, js, tdict=None, jdict=None):
    ref = jax.tree_util.tree_leaves(jax.device_get(js))
    got = convert.state_to_numpy(ts)
    assert len(got) == len(ref) == len(convert.SUITE_LEAVES)
    for (name, _), a, b in zip(convert.SUITE_LEAVES, got, ref):
        assert a.dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    if tdict is not None:
        np.testing.assert_array_equal(convert.state_to_numpy(ts, tdict)[-1],
                                      np.asarray(jdict.table))


def _assert_output_equal(tout, jout):
    np.testing.assert_array_equal(tout.topk_keys.numpy().view(np.uint32),
                                  np.asarray(jout.topk_keys))
    np.testing.assert_array_equal(tout.topk_counts.numpy(),
                                  np.asarray(jout.topk_counts))
    assert int(tout.rows) == int(jout.rows)
    np.testing.assert_allclose(tout.service_cardinality.numpy(),
                               np.asarray(jout.service_cardinality), **F32_TOL)
    np.testing.assert_allclose(tout.entropies.numpy(),
                               np.asarray(jout.entropies), **F32_TOL)


def _windows(seed, batches_per_window, C):
    """Per window: [(cols, n)] with a ragged last batch (padded to C)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        win = []
        for b in range(batches_per_window):
            n = C if b < batches_per_window - 1 else C - 123
            cols = _records(rng, C)
            for v in cols.values():
                v[n:] = 0
            win.append((cols, n))
        out.append(win)
    return out


def test_full_row_update_matches_jax_over_two_windows():
    C = 2048
    jcfg, tcfg = _cfgs()
    js, ts = _start(jcfg)
    jupd = jax.jit(lambda s, c, m: jfs.update(s, c, m, jcfg))
    jflush = jax.jit(lambda s: jfs.flush(s, jcfg))
    for win in _windows(1, 3, C):
        for cols, n in win:
            mask = np.arange(C) < n
            js = jupd(js, {k: jnp.asarray(v) for k, v in cols.items()},
                      jnp.asarray(mask))
            ts = flow_suite.update(ts, {k: _bits(v) for k, v in cols.items()},
                                   torch.from_numpy(mask), tcfg)
            _assert_state_equal(ts, js)
        js, jout = jflush(js)
        ts, tout = flow_suite.flush(ts, tcfg)
        _assert_output_equal(tout, jout)
        _assert_state_equal(ts, js)


@pytest.mark.parametrize("K,fused", [(1, None), (1, True), (3, None),
                                     (3, True)])
def test_coalesced_lanes_match_jax_over_two_windows(K, fused):
    C = 1024
    jcfg, tcfg = _cfgs(fused)
    js, ts = _start(jcfg)
    jprog = jfs.make_coalesced_update(jcfg, K, C)
    tprog = flow_suite.make_coalesced_update(tcfg, K, C)
    jflush = jax.jit(lambda s: jfs.flush(s, jcfg))
    for win in _windows(2 + K, K, C):
        flat = np.zeros(jfs.coalesced_lanes_words(K, C), np.uint32)
        for k, (cols, n) in enumerate(win):
            flat[k * jfs.slot_words(C)] = n
            flow_suite.pack_lanes_into(cols, flow_suite.slot_plane(flat, k, C))
        ref_flat = np.zeros_like(flat)
        for k, (cols, n) in enumerate(win):
            ref_flat[k * jfs.slot_words(C)] = n
            jfs.pack_lanes_into(cols, jfs.slot_plane(ref_flat, k, C))
        np.testing.assert_array_equal(flat, ref_flat)
        js, jfence = jprog(js, jnp.asarray(flat))
        ts, tfence = tprog(ts, _bits(flat))
        assert int(tfence) == int(jfence) == sum(n for _, n in win)
        _assert_state_equal(ts, js)
        js, jout = jflush(js)
        ts, tout = flow_suite.flush(ts, tcfg)
        _assert_output_equal(tout, jout)


def _dict_stream(seed, batches, B):
    rng = np.random.default_rng(seed)
    return [_records(rng, B - (37 if i % 2 else 0), pool=900)
            for i in range(batches)]


@pytest.mark.parametrize("fused", [None, True])
def test_dict_wire_matches_jax_over_two_windows(fused):
    B = 1024
    jcfg, tcfg = _cfgs(fused)
    js, ts = _start(jcfg)
    jd = jfd.init_dict(4096)
    _, td = convert.state_from_numpy(jax.device_get(js),
                                     jax.device_get(jd), device="cpu")
    jpack = jfd.FlowDictPacker(capacity=4096, hits_batch=B, news_batch=512)
    tpack = flow_dict.FlowDictPacker(capacity=4096, hits_batch=B,
                                     news_batch=512)
    jflush = jax.jit(lambda s: jfs.flush(s, jcfg))
    jprogs, tprogs = {}, {}
    for window in range(2):
        for cols in _dict_stream(10 + window, 3, B):
            jwire = jpack.pack(cols) + jpack.flush()
            twire = tpack.pack(cols) + tpack.flush()
            assert flow_dict.wire_signature(twire) == jfd.wire_signature(jwire)
            sig = flow_dict.wire_signature(twire)
            flat = np.zeros(flow_dict.wire_words(sig), np.uint32)
            flow_dict.stage_wire(twire, flat)
            ref_flat = np.zeros_like(flat)
            jfd.stage_wire(jwire, ref_flat)
            np.testing.assert_array_equal(flat, ref_flat)
            if sig not in jprogs:
                jprogs[sig] = jfd.make_wire_update(jcfg, sig)
                tprogs[sig] = flow_dict.make_wire_update(tcfg, sig)
            js, jd, jrows = jprogs[sig](js, jd, jnp.asarray(flat))
            ts, td, trows = tprogs[sig](ts, td, _bits(flat))
            assert int(trows) == int(jrows) == len(cols["ip_src"])
            _assert_state_equal(ts, js, td, jd)
        js, jout = jflush(js)
        ts, tout = flow_suite.flush(ts, tcfg)
        _assert_output_equal(tout, jout)


def test_dict_apply_batches_matches_wire_program():
    """Plane-by-plane application equals the staged program."""
    B = 512
    _, tcfg = _cfgs()
    s1 = flow_suite.init(tcfg, device="cpu")
    s2 = flow_suite.init(tcfg, device="cpu")
    d1 = flow_dict.init_dict(2048, device="cpu")
    d2 = flow_dict.init_dict(2048, device="cpu")
    pack = flow_dict.FlowDictPacker(capacity=2048, hits_batch=B)
    for cols in _dict_stream(5, 3, B):
        wire = pack.pack(cols) + pack.flush()
        s1, d1 = flow_dict.apply_batches(s1, d1, wire, tcfg)
        sig = flow_dict.wire_signature(wire)
        flat = np.zeros(flow_dict.wire_words(sig), np.uint32)
        flow_dict.stage_wire(wire, flat)
        s2, d2, _ = flow_dict.make_wire_update(tcfg, sig)(s2, d2, _bits(flat))
    for a, b in zip(convert.state_to_numpy(s1, d1),
                    convert.state_to_numpy(s2, d2)):
        np.testing.assert_array_equal(a, b)


def test_merge_matches_jax():
    C = 1024
    jcfg, tcfg = _cfgs()
    win = _windows(7, 2, C)[0]
    parts = []
    for cols, n in win:
        js, ts = _start(jcfg)
        mask = np.arange(C) < n
        js = jfs.update(js, {k: jnp.asarray(v) for k, v in cols.items()},
                        jnp.asarray(mask), jcfg)
        ts = flow_suite.update(ts, {k: _bits(v) for k, v in cols.items()},
                               torch.from_numpy(mask), tcfg)
        parts.append((js, ts))
    jm = jfs.merge(parts[0][0], parts[1][0], jcfg)
    tm = flow_suite.merge(parts[0][1], parts[1][1], tcfg)
    _assert_state_equal(tm, jm)


def test_convert_round_trip_keeps_dtypes_and_bits():
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(4)
    js = jfs.init(jcfg)
    cols = _records(rng, 3000)
    js = jfs.update(js, {k: jnp.asarray(v) for k, v in cols.items()},
                    jnp.ones(3000, bool), jcfg)
    jd = jfd.FlowDictState(table=jnp.asarray(
        rng.integers(0, 1 << 32, (4, 512), dtype=np.uint64).astype(np.uint32)))
    leaves = jax.tree_util.tree_leaves(jax.device_get(js)) + [np.asarray(jd.table)]
    ts, td = convert.state_from_numpy(jax.device_get(js), jax.device_get(jd),
                                      device="cpu")
    assert ts.ring.keys.dtype == torch.int32 and td.table.dtype == torch.int32
    back = convert.state_to_numpy(ts, td)
    assert [a.dtype for a in back] == [np.asarray(b).dtype for b in leaves]
    for a, b in zip(back, leaves):
        np.testing.assert_array_equal(a, b)
    # the flat leaf-list form converts the same way
    ts2, _ = convert.state_from_numpy(leaves[:9], device="cpu")
    for a, b in zip(convert.state_to_numpy(ts2), leaves[:9]):
        np.testing.assert_array_equal(a, b)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        flow_suite.init(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        flow_dict.init_dict(1024)
    with pytest.raises(RuntimeError, match="CUDA"):
        TpuSketchExporter(cfg=tcfg, batch_rows=256)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.state_from_numpy(jax.device_get(jfs.init(_cfgs()[0])))


def _exporter_chunks(seed):
    rng = np.random.default_rng(seed)
    return [[_records(rng, n, pool=700) for n in (1500, 900, 2000)]
            for _ in range(2)]


@pytest.mark.parametrize("coalesce", [1, 2])
def test_exporter_lanes_windows_match_jax(coalesce):
    B = 1024
    jcfg, tcfg = _cfgs()
    exp = TpuSketchExporter(cfg=tcfg, batch_rows=B, wire="lanes",
                            coalesce_batches=coalesce, device="cpu")
    js = jfs.init(jcfg)
    jupd = jax.jit(lambda s, l, m: jfs.update_packed(s, l, m, jcfg))
    for chunks in _exporter_chunks(21):
        for cols in chunks:
            exp.process([("l4_flow_log", 0, cols, -1)])
        allc = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
        total = len(allc["ip_src"])
        for s in range(0, total, B):
            n = min(B, total - s)
            part = {k: np.zeros(B, np.uint32) for k in allc}
            for k in allc:
                part[k][:n] = allc[k][s:s + n]
            lanes = jfs.pack_lanes(part)
            js = jupd(js, {k: jnp.asarray(v) for k, v in lanes.items()},
                      jnp.asarray(np.arange(B) < n))
        js, jout = jfs.flush(js, jcfg)
        _assert_output_equal(exp.flush_window(), jout)
    assert exp.rows_in == 2 * 4400 and exp.windows == 2


def test_exporter_dict_windows_match_jax():
    B = 1024
    jcfg, tcfg = _cfgs()
    exp = TpuSketchExporter(cfg=tcfg, batch_rows=B, wire="dict", device="cpu")
    assert exp._dict_packer.capacity == 1 << 17
    js, jd = jfs.init(jcfg), jfd.init_dict(1 << 17)
    jpack = jfd.FlowDictPacker(capacity=1 << 17, hits_batch=B)
    for chunks in _exporter_chunks(22):
        for cols in chunks:
            exp.process([("l4_flow_log", 0, cols, -1)])
        allc = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
        total = len(allc["ip_src"])
        for s in range(0, total, B):
            part = {k: v[s:s + B] for k, v in allc.items()}
            js, jd = jfd.apply_batches(js, jd,
                                       jpack.pack(part) + jpack.flush(), jcfg)
        js, jout = jfs.flush(js, jcfg)
        _assert_output_equal(exp.flush_window(), jout)


@pytest.mark.parametrize("n", [0, 1, 5, 256])
def test_update_news_padding_never_touches_the_table(n):
    """Padded news rows (>= n) must leave the table as the valid rows
    alone would -- also when their stale index words collide with a
    valid row's index, and when n == 0."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(n)
    cap, C = 512, 256
    table = rng.integers(0, 1 << 32, (4, cap), dtype=np.uint64).astype(
        np.uint32)
    plane = rng.integers(0, 1 << 32, (6, C), dtype=np.uint64).astype(np.uint32)
    plane[0] = rng.permutation(cap)[:C]
    plane[0, n:] = plane[0, 0] if n else 7          # colliding stale indices
    plane[4] &= 0xFF
    plane[5] &= 0xFFFF
    js, ts = _start(jcfg)
    jd = jfd.FlowDictState(table=jnp.asarray(table))
    td = flow_dict.FlowDictState(table=_bits(table))
    js, jd = jfd.update_news(js, jd, jnp.asarray(plane), jnp.uint32(n), jcfg)
    ts, td = flow_dict.update_news(ts, td, _bits(plane), n, tcfg)
    _assert_state_equal(ts, js, td, jd)


@pytest.mark.parametrize("fused,n", [(None, 200), (True, 200), (None, 6),
                                     (True, 2)])
def test_update_news_out_of_range_index_matches_jax(fused, n):
    """A valid news row whose index word lies outside the table is read
    as the reference reads it (int32; negatives count from the end, the
    rest is dropped by the scatter) and is still counted in the sketches:
    index capacity + 3 writes nothing, 2^32 - 1 (int32 -1) writes the
    last column."""
    jcfg, tcfg = _cfgs(fused)
    rng = np.random.default_rng(31 + n)
    cap, C = 512, 256
    table = rng.integers(0, 1 << 32, (4, cap), dtype=np.uint64).astype(
        np.uint32)
    plane = rng.integers(0, 1 << 32, (6, C), dtype=np.uint64).astype(np.uint32)
    plane[0] = rng.permutation(cap - 1)[:C]
    plane[0, 0] = cap + 3
    plane[0, 1] = 0xFFFFFFFF
    plane[0, n - 1] = cap + 3 if n > 2 else plane[0, n - 1]   # last valid row
    plane[4] &= 0xFF
    plane[5] &= 0xFFFF
    js, ts = _start(jcfg)
    jd = jfd.FlowDictState(table=jnp.asarray(table))
    td = flow_dict.FlowDictState(table=_bits(table))
    js, jd = jfd.update_news(js, jd, jnp.asarray(plane), jnp.uint32(n), jcfg)
    ts, td = flow_dict.update_news(ts, td, _bits(plane), n, tcfg)
    _assert_state_equal(ts, js, td, jd)
    assert int(ts.rows_seen) == n
    np.testing.assert_array_equal(td.table.numpy().view(np.uint32)[:, -1],
                                  np.asarray(jd.table)[:, -1])
