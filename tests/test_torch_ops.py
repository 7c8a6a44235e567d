"""deepflow_tpu_torch sketch ops (cms, entropy, hll, topk) against the
JAX package on identical numpy inputs. Integer state is compared for
exact equality; float32 readouts (entropies, HLL estimates) within
rtol=1e-5, atol=1e-6, because XLA-CPU and ATen may round log/sqrt and
the order of a float sum differently in the last ulp."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepflow_tpu.ops import cms as jcms
from deepflow_tpu.ops import entropy as jentropy
from deepflow_tpu.ops import hll as jhll
from deepflow_tpu.ops import topk as jtopk
from deepflow_tpu_torch.ops import (cms, cuda_hist, entropy, hll, mxu_hist,
                                    topk)

F32_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    """numpy -> CPU torch, uint32 as int32 bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _u(t):
    return t.numpy().view(np.uint32)


def _keys(rng, n, universe=1 << 32):
    return rng.integers(0, universe, n, dtype=np.uint64).astype(np.uint32)


# -- cms --------------------------------------------------------------------

@pytest.mark.parametrize("n,masked,weighted", [
    (512, False, False), (512, True, True), (9000, True, False),
    (9000, True, True), (16384, False, True),
    # at and past MIN_LANES: the in-place histogram path
    (8192, False, False), (12289, True, False)])
def test_cms_update_query_matches_jax(n, masked, weighted):
    rng = np.random.default_rng(n + masked * 3 + weighted)
    keys = _keys(rng, n, 1 << 11)           # repeats: real collisions
    mask = rng.random(n) < 0.8 if masked else None
    # weights up to 2^17: the histogram path saturates them at 65535,
    # the small-batch scatter path adds them in full -- on both packages
    w = rng.integers(0, 1 << 17, n).astype(np.int32) if weighted else None
    js = jcms.init(4, 10)
    ts = cms.init(4, 10, device="cpu")
    for _ in range(2):
        js = jcms.update(js, jnp.asarray(keys),
                         None if w is None else jnp.asarray(w),
                         None if mask is None else jnp.asarray(mask))
        ts = cms.update(ts, _t(keys), None if w is None else _t(w),
                        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    np.testing.assert_array_equal(_u(ts.seeds), np.asarray(js.seeds))
    q = _keys(rng, 700, 1 << 11)
    np.testing.assert_array_equal(cms.query(ts, _t(q)).numpy(),
                                  np.asarray(jcms.query(js, jnp.asarray(q))))


def test_cms_merge_reset_and_conservative():
    rng = np.random.default_rng(5)
    k1, k2 = _keys(rng, 300), _keys(rng, 300)
    ja = jcms.update(jcms.init(2, 8), jnp.asarray(k1))
    jb = jcms.update(jcms.init(2, 8), jnp.asarray(k2))
    ta = cms.update(cms.init(2, 8, device="cpu"), _t(k1))
    tb = cms.update(cms.init(2, 8, device="cpu"), _t(k2))
    np.testing.assert_array_equal(cms.merge(ta, tb).counts.numpy(),
                                  np.asarray(jcms.merge(ja, jb).counts))
    assert int(cms.reset(ta).counts.abs().sum()) == 0
    # conservative update on the merged state (test_torch_conservative.py
    # holds it against the reference in depth)
    jc = jcms.update_conservative(jcms.merge(ja, jb), jnp.asarray(k1))
    tc = cms.update_conservative(cms.merge(ta, tb), _t(k1))
    np.testing.assert_array_equal(tc.counts.numpy(), np.asarray(jc.counts))


# -- entropy ----------------------------------------------------------------

@pytest.mark.parametrize("n,masked", [(700, False), (700, True),
                                      (8192, True), (12000, False),
                                      (8192, False), (16385, True)])
def test_entropy_update_matches_jax(n, masked):
    rng = np.random.default_rng(n + masked)
    feats = np.stack([_keys(rng, n, 1 << 9) for _ in range(4)])
    w = rng.integers(0, 1 << 18, n).astype(np.int32)   # saturates at 65535
    mask = rng.random(n) < 0.7 if masked else None
    js = jentropy.init(4, 10)
    ts = entropy.init(4, 10, device="cpu")
    js = jentropy.update(js, jnp.asarray(feats), jnp.asarray(w),
                         None if mask is None else jnp.asarray(mask))
    ts = entropy.update(ts, _t(feats), _t(w),
                        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(ts.hist.numpy(), np.asarray(js.hist))
    np.testing.assert_allclose(entropy.entropies(ts).numpy(),
                               np.asarray(jentropy.entropies(js)), **F32_TOL)


@pytest.mark.parametrize("sketch", ["cms", "entropy"])
def test_sketch_update_adds_histogram_in_place(sketch, monkeypatch):
    """At n >= MIN_LANES a sketch update is one `hist_add_` call into the
    sketch's own int32 state: no float histogram, no separate add."""
    calls = []
    real = cuda_hist.hist_add_

    def spy(acc, *args, **kw):
        calls.append(acc.data_ptr())
        return real(acc, *args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("float histogram on the update path")

    monkeypatch.setattr(cuda_hist, "hist_add_", spy)
    monkeypatch.setattr(mxu_hist, "hist_masked", refuse)
    rng = np.random.default_rng(17)
    n = mxu_hist.MIN_LANES + 5
    mask = torch.from_numpy(rng.random(n) < 0.5)
    if sketch == "cms":
        state = cms.init(4, 10, device="cpu")
        target = state.counts
        state = cms.update(state, _t(_keys(rng, n)), mask=mask)
        assert int(state.counts.sum()) == 4 * int(mask.sum())
    else:
        state = entropy.init(4, 10, device="cpu")
        target = state.hist
        w = _t(rng.integers(0, 1 << 18, n).astype(np.int32))
        state = entropy.update(state, _t(np.stack(
            [_keys(rng, n) for _ in range(4)])), w, mask)
        assert int(state.hist.sum()) > 0
    assert calls == [target.data_ptr()]


def test_entropy_empty_and_merge():
    ts = entropy.init(4, 6, device="cpu")
    np.testing.assert_array_equal(entropy.entropies(ts).numpy(), np.zeros(4))
    js = jentropy.init(4, 6)
    rng = np.random.default_rng(9)
    feats = np.stack([_keys(rng, 100) for _ in range(4)])
    js = jentropy.update(js, jnp.asarray(feats))
    ts = entropy.update(ts, _t(feats))
    np.testing.assert_array_equal(entropy.merge(ts, ts).hist.numpy(),
                                  np.asarray(jentropy.merge(js, js).hist))
    np.testing.assert_allclose(entropy.entropies(ts).numpy(),
                               np.asarray(jentropy.entropies(js)), **F32_TOL)


# -- hll --------------------------------------------------------------------

@pytest.mark.parametrize("precision,masked", [(4, False), (8, True),
                                              (10, False), (16, True)])
def test_hll_update_estimate_matches_jax(precision, masked):
    rng = np.random.default_rng(precision)
    groups, n = 16, 6000
    gid = rng.integers(-3, groups + 3, n).astype(np.int32)   # clipped
    keys = np.concatenate([np.array([0, 0xFFFFFFFF, 1, 1 << 31], np.uint32),
                           _keys(rng, n - 4)])
    mask = rng.random(n) < 0.6 if masked else None
    js = jhll.update(jhll.init(groups, precision), jnp.asarray(gid),
                     jnp.asarray(keys),
                     None if mask is None else jnp.asarray(mask))
    ts = hll.update(hll.init(groups, precision, device="cpu"), _t(gid),
                    _t(keys), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(ts.registers.numpy(),
                                  np.asarray(js.registers))
    np.testing.assert_allclose(hll.estimate(ts).numpy(),
                               np.asarray(jhll.estimate(js)), **F32_TOL)


def test_hll_empty_merge_reset():
    ta = hll.init(4, 6, device="cpu")
    assert hll.estimate(ta).abs().sum() == 0
    rng = np.random.default_rng(1)
    k = _keys(rng, 500)
    g = rng.integers(0, 4, 500).astype(np.int32)
    ja = jhll.update(jhll.init(4, 6), jnp.asarray(g), jnp.asarray(k))
    ta = hll.update(ta, _t(g), _t(k))
    tb = hll.update(hll.init(4, 6, device="cpu"), _t(g[:250][::-1].copy()),
                    _t(k[:250]))
    jb = jhll.update(jhll.init(4, 6), jnp.asarray(g[:250][::-1].copy()),
                     jnp.asarray(k[:250]))
    np.testing.assert_array_equal(hll.merge(ta, tb).registers.numpy(),
                                  np.asarray(jhll.merge(ja, jb).registers))
    assert int(hll.reset(ta).registers.sum()) == 0


# -- topk -------------------------------------------------------------------

def _ring_equal(ts, js):
    np.testing.assert_array_equal(_u(ts.keys), np.asarray(js.keys))
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))


@pytest.mark.parametrize("sample_log2,universe", [
    (0, 1 << 8),      # heavy repeats, many tied estimates
    (0, 1 << 20),     # mostly count-1 keys: the ring is decided by ties
    (2, 1 << 10), (4, 1 << 12)])
def test_topk_offer_matches_jax_with_ties(sample_log2, universe):
    rng = np.random.default_rng(sample_log2 * 7 + universe)
    ring, n = 64, 1000
    jsk, tsk = jcms.init(3, 9), cms.init(3, 9, device="cpu")
    jr, tr = jtopk.init(ring), topk.init(ring, device="cpu")
    for phase in range(5):
        keys = _keys(rng, n, universe)
        keys[:7] = 0xFFFFFFFF                     # sentinel-valued keys
        mask = rng.random(n) < 0.9
        jsk = jcms.update(jsk, jnp.asarray(keys), mask=jnp.asarray(mask))
        tsk = cms.update(tsk, _t(keys), mask=torch.from_numpy(mask))
        jr = jtopk.offer(jr, jnp.asarray(keys), jsk, mask=jnp.asarray(mask),
                         sample_log2=sample_log2,
                         phase=jnp.int32(phase * 3))
        tr = topk.offer(tr, _t(keys), tsk, mask=torch.from_numpy(mask),
                        sample_log2=sample_log2,
                        phase=torch.tensor(phase * 3, dtype=torch.int32))
        _ring_equal(tr, jr)
    jk, jc = jtopk.result(jr, 10)
    tk, tc = topk.result(tr, 10)
    np.testing.assert_array_equal(_u(tk), np.asarray(jk))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _ring_equal(topk.reset(tr), jtopk.reset(jr))


def test_topk_sort_pairs_lexicographic():
    rng = np.random.default_rng(3)
    k = np.concatenate([np.array([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF] * 3,
                                 np.uint32), _keys(rng, 200, 16)])
    c = rng.integers(-1, 5, k.shape[0]).astype(np.int32)
    c[:12] = [-1, 5, 0, 2, 3, -1, 7, 7, -(1 << 31), (1 << 31) - 1, 0, 1]
    jk, jc = jtopk.sort_pairs(jnp.asarray(k), jnp.asarray(c))
    tk, tc = topk.sort_pairs(_t(k), _t(c))
    np.testing.assert_array_equal(tk.numpy().astype(np.uint32), np.asarray(jk))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
