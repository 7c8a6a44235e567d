"""deepflow_tpu_torch u32 lane arithmetic and hashing against the JAX
package: bit-exact on random and edge inputs (0, 2^32-1, negative int32
ids read through their bits)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepflow_tpu.ops import hashing as jhashing
from deepflow_tpu.utils import u32 as ju32
from deepflow_tpu_torch.ops import hashing
from deepflow_tpu_torch.utils import u32

EDGES_U32 = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                      0xFFFFFFFF, 0x9E3779B9], np.uint32)


def _u32_cases(seed):
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([EDGES_U32, rand])


def _np_u32(t: torch.Tensor) -> np.ndarray:
    """Port u32 values (int64) -> uint32 numpy, checking the range."""
    a = t.numpy()
    assert a.dtype == np.int64 and a.min() >= 0 and a.max() <= 0xFFFFFFFF
    return a.astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix32_matches_jax_and_numpy(seed):
    x = _u32_cases(seed)
    got = _np_u32(u32.mix32(torch.from_numpy(x.astype(np.int64))))
    np.testing.assert_array_equal(got, np.asarray(ju32.mix32(jnp.asarray(x))))
    np.testing.assert_array_equal(got, u32._mix32_np(x))


def test_mix32_reads_int32_bits_and_uint32_tensors():
    neg = np.array([-1, -2, -(1 << 31), 0, 5], np.int32)
    ref = np.asarray(ju32.mix32(jnp.asarray(neg)))
    np.testing.assert_array_equal(_np_u32(u32.mix32(torch.from_numpy(neg))), ref)
    as_u = torch.from_numpy(neg.view(np.uint32))
    assert as_u.dtype == torch.uint32
    np.testing.assert_array_equal(_np_u32(u32.mix32(as_u)), ref)


@pytest.mark.parametrize("ncols", [1, 3, 5])
def test_fold_columns_matches_jax_and_numpy(ncols):
    rng = np.random.default_rng(ncols)
    cols = [np.concatenate([EDGES_U32, rng.integers(0, 1 << 32, 2048,
                                                    dtype=np.uint64)
                            .astype(np.uint32)]) for _ in range(ncols)]
    cols[0] = cols[0].view(np.int32)           # a signed id column
    got = _np_u32(u32.fold_columns([torch.from_numpy(c) for c in cols]))
    np.testing.assert_array_equal(
        got, np.asarray(ju32.fold_columns([jnp.asarray(c) for c in cols])))
    np.testing.assert_array_equal(got, ju32.fold_columns_np(cols))
    np.testing.assert_array_equal(got, u32.fold_columns_np(cols))


def test_to_bits_round_trip():
    x = _u32_cases(7)
    bits = u32.to_bits(torch.from_numpy(x.astype(np.int64)))
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), x)
    np.testing.assert_array_equal(_np_u32(u32.as_u32(bits)), x)


def test_mul32_wraps_like_uint32():
    a, b = _u32_cases(3), _u32_cases(4)[::-1].copy()
    got = _np_u32(u32.mul32(torch.from_numpy(a.astype(np.int64)),
                            torch.from_numpy(b.astype(np.int64))))
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(got, a * b)


@pytest.mark.parametrize("depth,seed", [(1, 0xDEC0DE), (4, 0xDEC0DE),
                                        (4, 0xDEC0DE ^ 0xE27), (8, 7)])
def test_make_seeds_matches_jax(depth, seed):
    got = hashing.make_seeds(depth, seed, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (depth, 2)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(jhashing.make_seeds(depth, seed)))
    np.testing.assert_array_equal(u32.splitmix32_seeds(2 * depth, seed),
                                  ju32.splitmix32_seeds(2 * depth, seed))


@pytest.mark.parametrize("log2_width", [1, 10, 12, 17, 24])
def test_bucket_matches_jax(log2_width):
    keys = _u32_cases(log2_width)
    seeds = np.asarray(jhashing.make_seeds(3, 11))
    for j in range(3):
        ref = np.asarray(jhashing.bucket(jnp.asarray(keys), seeds[j, 0],
                                         seeds[j, 1], log2_width))
        got = hashing.bucket(torch.from_numpy(keys.view(np.int32)),
                             int(seeds[j, 0]), int(seeds[j, 1]), log2_width)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
        assert got.min() >= 0 and got.max() < (1 << log2_width)


@pytest.mark.parametrize("log2_width,depth", [(12, 4), (17, 4), (10, 2)])
def test_multi_bucket_matches_jax(log2_width, depth):
    keys = _u32_cases(depth)
    js = jhashing.make_seeds(depth, 0xDEC0DE)
    ref = np.asarray(jhashing.multi_bucket(jnp.asarray(keys), js, log2_width))
    ts = hashing.make_seeds(depth, 0xDEC0DE, device="cpu")
    got = hashing.multi_bucket(torch.from_numpy(keys.astype(np.int64)), ts,
                               log2_width)
    np.testing.assert_array_equal(got.numpy(), ref)
