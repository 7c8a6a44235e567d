"""The port's streaming PCA and matrix profile against the JAX package's.

The same seed-made numpy inputs go through `deepflow_tpu/ops/{pca,
matrix_profile}.py` (JAX on the CPU) and `deepflow_tpu_torch/ops/...`
(torch on the CPU). PCA is compared on the projector `w @ w.T`, never on
`w` (QR column signs are the implementation's choice), within atol 1e-5;
`mean`, `var` and scores within rtol 1e-5. Matrix-profile distances are
compared within rtol 1e-4, atol 1e-4: a z-normalized distance is a
difference of near-equal float32 products (qt - m mu_a mu_b), so the
order of the einsum's sums moves it by more than one ulp."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflow_tpu.ops import matrix_profile as jmp
from deepflow_tpu.ops import pca as jpca
from deepflow_tpu_torch.ops import matrix_profile as tmp
from deepflow_tpu_torch.ops import pca as tpca

F32 = dict(rtol=1e-5, atol=1e-6)
PROJ_ATOL = 1e-5
MP_TOL = dict(rtol=1e-4, atol=1e-4)


def _proj(w) -> np.ndarray:
    w = np.asarray(w, np.float64)
    return w @ w.T


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_pca_equal(ts, js):
    np.testing.assert_allclose(_proj(ts.w.numpy()), _proj(js.w),
                               atol=PROJ_ATOL, rtol=0)
    np.testing.assert_allclose(ts.mean.numpy(), np.asarray(js.mean), **F32)
    np.testing.assert_allclose(ts.var.numpy(), np.asarray(js.var), **F32)
    assert int(ts.step) == int(js.step)
    assert ts.step.dtype == torch.int32 and ts.step.dim() == 0


@pytest.mark.parametrize("features,k", [(9, 3), (6, 2), (16, 4)])
def test_pca_init_projector_matches_jax(features, k):
    ts, js = tpca.init(features, k, device="cpu"), jpca.init(features, k)
    _assert_pca_equal(ts, js)
    wtw = ts.w.T @ ts.w
    np.testing.assert_allclose(wtw.numpy(), np.eye(k), atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_pca_update_sequence_matches_jax(seed, masked):
    """Projector, mean, var and scores after a sequence of updates on
    correlated data (a 3-dimensional signal in 9 features plus noise),
    with and without a padding mask."""
    rng = np.random.default_rng(seed)
    f, k = 9, 3
    basis = rng.normal(size=(3, f))
    ts, js = tpca.init(f, k, device="cpu"), jpca.init(f, k)
    for step in range(40):
        x = (rng.normal(size=(32, 3)) @ basis
             + 0.05 * rng.normal(size=(32, f)) + 2.0).astype(np.float32)
        mask = (np.arange(32) < 20 + step % 12) if masked else None
        ts = tpca.update(ts, _t(x), None if mask is None else _t(mask))
        js = jpca.update(js, jnp.asarray(x),
                         None if mask is None else jnp.asarray(mask))
        _assert_pca_equal(ts, js)
    probe = (rng.normal(size=(8, 3)) @ basis
             + rng.normal(size=(8, f))).astype(np.float32)
    np.testing.assert_allclose(tpca.score(ts, _t(probe)).numpy(),
                               np.asarray(jpca.score(js, jnp.asarray(probe))),
                               rtol=1e-4, atol=1e-5)


def test_pca_grad_then_apply_is_update():
    """The split a multi-device caller sums between: grad + apply_grad
    is update, bit for bit, and grad's terms match the reference's."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 9)).astype(np.float32)
    ts, js = tpca.init(9, 3, device="cpu"), jpca.init(9, 3)
    a = tpca.update(ts, _t(x))
    terms = tpca.grad(ts, _t(x))
    b = tpca.apply_grad(ts, *terms)
    for la, lb in zip(a, b):
        assert torch.equal(la, lb)
    for got, want in zip(terms, jpca.grad(js, jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def _series(kind: str, rng, length: int) -> np.ndarray:
    t = np.arange(length, dtype=np.float64)
    s = np.sin(t / 5.0) + rng.normal(0, 0.05, length)
    if kind == "flat":
        s[length // 3:length // 3 + 24] = 1.5           # a flat plateau
        s[-20:] = 0.25                                   # flat at the end
    elif kind == "inf":
        s[length // 2] = np.inf
        s[length // 2 + 5] = -np.inf
    elif kind == "nan":
        s[length // 4] = np.nan
        s[min(length - 1, length // 4 + 30)] = np.inf
    elif kind == "huge":
        s[length // 2:length // 2 + 3] = 3e38            # f32 overflow
    return s.astype(np.float32)


def _rings(kinds, length, pushes, seed=5):
    """Both packages' MP state after the same pushes of 2 series each."""
    rng = np.random.default_rng(seed)
    series = np.stack([_series(k, rng, pushes) for k in kinds])
    ts, js = tmp.init(len(kinds), length, device="cpu"), \
        jmp.init(len(kinds), length)
    for i in range(pushes):
        ts = tmp.push(ts, _t(series[:, i]))
        js = jmp.push(js, jnp.asarray(series[:, i]))
    np.testing.assert_array_equal(ts.ring.numpy(), np.asarray(js.ring))
    assert int(ts.count) == int(js.count) == pushes
    return ts, js


KINDS = [("plain", "flat"), ("inf", "nan"), ("huge", "flat")]


@pytest.mark.parametrize("kinds", KINDS, ids=["-".join(k) for k in KINDS])
@pytest.mark.parametrize("pushes", [20, 70, 160])
def test_mp_latest_score_matches_jax(kinds, pushes):
    ts, js = _rings(kinds, 64, pushes)
    for m in (4, 8, 16):
        got = tmp.latest_score(ts, m).numpy()
        want = np.asarray(jmp.latest_score(js, m))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **MP_TOL)


@pytest.mark.parametrize("kinds", KINDS, ids=["-".join(k) for k in KINDS])
@pytest.mark.parametrize("pushes", [30, 160])
def test_mp_profile_and_discords_match_jax(kinds, pushes):
    """The whole profile (+inf exactly where the reference has it, no
    NaN) and the top-3 discords: scores within tolerance and the same
    subsequence indices."""
    ts, js = _rings(kinds, 64, pushes)
    m = 8
    got = tmp.profile(ts, m).numpy()
    want = np.asarray(jmp.profile(js, m))
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **MP_TOL)
    gs, gi = tmp.discords(ts, m, k=3)
    js_, ji = jmp.discords(js, m, k=3)
    np.testing.assert_allclose(gs.numpy(), np.asarray(js_), **MP_TOL)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))


def test_mp_discord_found_at_plateau():
    """A sine with one injected plateau: the port's top discord covers
    it, as the reference's does."""
    L, m = 256, 16
    series = np.sin(np.arange(L, dtype=np.float32) / 6)
    series[180:196] = 2.5
    ts = tmp.init(1, L, device="cpu")
    for v in series:
        ts = tmp.push(ts, torch.tensor([v]))
    _, idx = tmp.discords(ts, m, k=1)
    assert 180 - m < int(idx[0, 0]) < 196
