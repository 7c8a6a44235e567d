"""The plain PyTorch version of each deepflow_tpu_torch kernel against the
Pallas kernel it replaces, run in interpret mode on the CPU, on the same
numpy inputs: padding (n < C, ragged n) and saturating weights included.

The CUDA kernels themselves run only on the card; `chip_smoke.py` holds
each of them bit-equal to these plain versions at the main path's
shapes. Here the wrappers are checked to refuse what the kernels do not
take, and never to launch (or count a launch) for a CPU tensor."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepflow_tpu.ops import hashing as jhashing
from deepflow_tpu.ops import mxu_hist as jmxu
from deepflow_tpu.ops.pallas_hist import hist_pallas
from deepflow_tpu.ops.pallas_sketch import fused_lane_hists, fused_news_hists
from deepflow_tpu_torch.ops import cuda_hist, cuda_sketch, hashing, mxu_hist


def _bits(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _acc(d=2, width=16, dtype=torch.int32):
    return torch.zeros(d, width, dtype=dtype)


@pytest.mark.parametrize("d,n,log2_width,weighted,planes", [
    (4, 3000, 10, False, 2),        # padded past the chunk, unweighted
    (4, 4096, 12, True, 2),         # weights saturating at 65535
    (2, 1000, 8, True, 1),          # one plane: saturate at 255
    (3, 777, 9, True, 3)])
def test_hist_plain_matches_hist_pallas(d, n, log2_width, weighted, planes):
    rng = np.random.default_rng(n + log2_width)
    width = 1 << log2_width
    idx = rng.integers(-5, width + 5, (d, n)).astype(np.int32)   # clamped
    w = rng.integers(0, 1 << 18, n).astype(np.int32) if weighted else None
    ref = np.asarray(hist_pallas(jnp.asarray(idx), width,
                                 None if w is None else jnp.asarray(w),
                                 weight_planes=planes, interpret=True))
    got = mxu_hist.hist(torch.from_numpy(idx), width,
                        None if w is None else torch.from_numpy(w),
                        weight_planes=planes)
    assert got.dtype == torch.float32 and tuple(got.shape) == (d, width)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("d,n,log2_width,weights,masked,planes", [
    (4, 3001, 10, None, False, 2),     # no weights: 1 per lane
    (4, 3001, 10, None, True, 2),      # mask only: the 0/1 weight, 1 plane
    (2, 1000, 8, "w", False, 1),       # saturate at 255
    (4, 4097, 12, "w", False, 2),      # saturate at 65535
    (3, 777, 9, "w", False, 3),        # saturate at 2^24 - 1
    (4, 5000, 11, "w", True, 2),       # weights and a mask
    (1, 4099, 13, "w", True, 3)])      # one row, n past a chunk
def test_hist_add_plain_matches_state_plus_hist_pallas(d, n, log2_width,
                                                       weights, masked,
                                                       planes):
    """hist_add_plain adds into a non-zero int32 state exactly what the
    reference's `hist_masked` contract gives through `hist_pallas`:
    indices out of range on both sides clamp, weights saturate."""
    rng = np.random.default_rng(7 * n + log2_width + masked)
    width = 1 << log2_width
    idx = rng.integers(-5, width + 5, (d, n)).astype(np.int32)
    w = None
    if weights and planes < 3:      # three quarters of them saturate
        w = rng.integers(0, 1 << (8 * planes + 2), n).astype(np.int32)
    elif weights:
        # the reference sums in f32, exact below 2^24 per cell: the lanes
        # that saturate at 2^24 - 1 get bins of their own
        w = rng.integers(0, 1 << 20, n).astype(np.int32)
        sat = rng.choice(n, 3, replace=False)
        w[sat] = [1 << 24, (1 << 31) - 1, (1 << 25) + 3]
        idx[np.isin(idx, [100, 101, 102])] = 103
        idx[:, sat] = [100, 101, 102]
    mask = rng.random(n) < 0.6 if masked else None
    ref_w, ref_planes = w, planes          # mxu_hist.hist_masked's folding
    if w is None and mask is not None:
        ref_w, ref_planes = mask.astype(np.int32), 1
    elif w is not None and mask is not None:
        ref_w = w * mask.astype(np.int32)
    ref = np.asarray(hist_pallas(jnp.asarray(idx), width,
                                 None if ref_w is None else jnp.asarray(ref_w),
                                 weight_planes=ref_planes, interpret=True))
    base = rng.integers(0, 1000, (d, width)).astype(np.int32)
    acc = torch.from_numpy(base.copy())
    out = cuda_hist.hist_add_plain(
        acc, torch.from_numpy(idx), width,
        None if w is None else torch.from_numpy(w),
        None if mask is None else torch.from_numpy(mask), planes)
    assert out is acc
    np.testing.assert_array_equal(acc.numpy(), base + ref.astype(np.int32))
    # the dispatching front ends agree with the plain version on the CPU
    acc2 = torch.from_numpy(base.copy())
    mxu_hist.hist_add_(acc2, torch.from_numpy(idx).to(torch.int64), width,
                       None if w is None else torch.from_numpy(w),
                       None if mask is None else torch.from_numpy(mask),
                       planes)
    np.testing.assert_array_equal(acc2.numpy(), acc.numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_port_hist_matches_mxu_hist(masked):
    rng = np.random.default_rng(11 + masked)
    d, n, width = 4, 9000, 1 << 12
    idx = rng.integers(0, width, (d, n)).astype(np.int32)
    w = rng.integers(0, 1 << 17, n).astype(np.int32)
    mask = rng.random(n) < 0.5 if masked else None
    ref = np.asarray(jmxu.hist_masked(jnp.asarray(idx), width, jnp.asarray(w),
                                      None if mask is None
                                      else jnp.asarray(mask), 2))
    got = mxu_hist.hist_masked(torch.from_numpy(idx), width,
                               torch.from_numpy(w),
                               None if mask is None else torch.from_numpy(mask),
                               2)
    np.testing.assert_array_equal(got.numpy(), ref)


def _seeds(depth, seed):
    js = jhashing.make_seeds(depth, seed)
    return js, hashing.make_seeds(depth, seed, device="cpu")


def _lane_plane(rng, C):
    plane = rng.integers(0, 1 << 32, (4, C), dtype=np.uint64).astype(np.uint32)
    pk = rng.integers(0, 1 << 24, C).astype(np.uint32)   # saturates at 65535
    plane[3] = (rng.integers(0, 256, C).astype(np.uint32) << 24) | pk
    plane[0, :5] = [0, 0xFFFFFFFF, 0x80000000, 1, 0xFFFFFFFF]
    return plane


def _news_plane(rng, C):
    plane = rng.integers(0, 1 << 32, (6, C), dtype=np.uint64).astype(np.uint32)
    plane[4] = rng.integers(0, 256, C)          # raw proto byte
    plane[5] = rng.integers(0, 0x10000, C)      # PKTS_CAP'd packets
    return plane


@pytest.mark.parametrize("kind,C,n", [
    ("lane", 2048, 2048), ("lane", 2048, 2011), ("lane", 1024, 1),
    ("lane", 512, 0), ("news", 1024, 1024), ("news", 2048, 1500),
    ("news", 256, 3),
    # n that split unevenly across the kernel's blocks
    ("lane", 2048, 2047), ("news", 1024, 1023), ("lane", 1024, 257),
    ("news", 512, 257), ("lane", 32768, 32767)])
def test_fused_plain_matches_pallas_interpret(kind, C, n):
    rng = np.random.default_rng(C + n + (kind == "news"))
    plane = (_lane_plane if kind == "lane" else _news_plane)(rng, C)
    jc, tc = _seeds(4, 0xDEC0DE)
    je, te = _seeds(4, 0xDEC0DE ^ 0xE27)
    pallas_fn = fused_lane_hists if kind == "lane" else fused_news_hists
    ref_c, ref_e = pallas_fn(jnp.asarray(plane), jnp.uint32(n), jc, je,
                             cms_log2_width=12, ent_log2_buckets=10,
                             interpret=True)
    # start from non-zero state: the port adds into it in place
    base_c = rng.integers(0, 1000, (4, 1 << 12)).astype(np.int32)
    base_e = rng.integers(0, 1000, (4, 1 << 10)).astype(np.int32)
    cms_counts, ent_hist = torch.from_numpy(base_c.copy()), \
        torch.from_numpy(base_e.copy())
    plain = cuda_sketch.fused_lane_hists_plain if kind == "lane" \
        else cuda_sketch.fused_news_hists_plain
    n_dev = torch.tensor([n], dtype=torch.int32)
    plain(_bits(plane), n_dev, cms_counts, ent_hist, tc, te)
    np.testing.assert_array_equal(
        cms_counts.numpy(), base_c + np.asarray(ref_c).astype(np.int32))
    np.testing.assert_array_equal(
        ent_hist.numpy(), base_e + np.asarray(ref_e).astype(np.int32))
    assert int(cms_counts.sum() - base_c.sum()) == 4 * n


def test_dispatch_on_cpu_runs_plain_and_counts_no_launch():
    rng = np.random.default_rng(2)
    before = (cuda_hist.hist_add_cuda.launches,
              cuda_sketch.fused_lane_hists_cuda.launches,
              cuda_sketch.fused_news_hists_cuda.launches)
    idx = torch.from_numpy(rng.integers(0, 64, (2, 100)).astype(np.int32))
    np.testing.assert_array_equal(
        mxu_hist.hist(idx, 64).numpy(),
        cuda_hist.hist_add_plain(_acc(2, 64), idx, 64).numpy())
    acc = torch.zeros(2, 64, dtype=torch.int32)
    mask = torch.from_numpy(rng.random(100) < 0.5)
    cuda_hist.hist_add_(acc, idx, 64, mask=mask)
    assert int(acc.sum()) == 2 * int(mask.sum())
    _, tc = _seeds(2, 1)
    _, te = _seeds(4, 2)
    for fn, rows in ((cuda_sketch.fused_lane_hists, 4),
                     (cuda_sketch.fused_news_hists, 6)):
        c = torch.zeros(2, 256, dtype=torch.int32)
        e = torch.zeros(4, 64, dtype=torch.int32)
        fn(_bits(_news_plane(rng, 300)[:rows]), 300, c, e, tc, te)
        assert int(c.sum()) == 2 * 300
    assert before == (cuda_hist.hist_add_cuda.launches,
                      cuda_sketch.fused_lane_hists_cuda.launches,
                      cuda_sketch.fused_news_hists_cuda.launches)


@pytest.mark.parametrize("case,match", [
    ("cpu", "needs CUDA"),
    ("acc_dtype", "acc must be"),
    ("acc_shape", "acc must be"),
    ("acc_strided", "acc must be"),
    ("idx_strided", "contiguous"),
    ("weights_strided", "contiguous"),
    ("mask_dtype", "mask must be"),
    ("weights_shape", "weights must be")])
def test_hist_add_cuda_refuses_bad_input(case, match):
    idx = torch.zeros(2, 8, dtype=torch.int32)
    acc, w, mask = _acc(), None, None
    if case == "acc_dtype":
        acc = _acc(dtype=torch.int64)
    elif case == "acc_shape":
        acc = _acc(width=15)
    elif case == "acc_strided":
        acc = _acc(width=32)[:, ::2]
    elif case == "idx_strided":
        idx = torch.zeros(8, 2, dtype=torch.int32).t()
    elif case == "weights_strided":
        w = torch.ones(16, dtype=torch.int32)[::2]
    elif case == "mask_dtype":
        mask = torch.ones(8, dtype=torch.int32)
    elif case == "weights_shape":
        w = torch.ones(7, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        cuda_hist.hist_add_cuda(acc, idx, 16, w, mask)
    assert int(acc.abs().sum()) == 0


def test_wrappers_refuse_bad_input():
    idx = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_hist.hist_add_cuda(_acc(), idx, 16)            # CPU tensor
    with pytest.raises(ValueError):
        cuda_hist.hist_add_(_acc(), idx.to(torch.int64), 16)   # dtype
    with pytest.raises(ValueError):
        cuda_hist.hist_add_(_acc(), idx, 16,
                            torch.ones(7, dtype=torch.int32))   # shape
    _, tc = _seeds(2, 1)
    _, te = _seeds(4, 2)
    c = torch.zeros(2, 256, dtype=torch.int32)
    e = torch.zeros(4, 64, dtype=torch.int32)
    plane = torch.zeros(4, 32, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_sketch.fused_lane_hists_cuda(plane, 3, c, e, tc, te)   # CPU
    with pytest.raises(ValueError):
        cuda_sketch.fused_news_hists(plane, 3, c, e, tc, te)        # rows
    with pytest.raises(ValueError):
        cuda_sketch.fused_lane_hists(plane, 3, torch.zeros(2, 200,
                                                           dtype=torch.int32),
                                     e, tc, te)                      # width
    with pytest.raises(ValueError):
        cuda_sketch.fused_lane_hists(plane.to(torch.int64), 3, c, e, tc, te)
