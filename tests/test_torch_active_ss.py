"""Port parity: the kNN (exact indices and distances; query-chunked and
support-streamed equal to the dense path), the local polynomial gradient
estimators, the active-subspace fits and ``api.active_ss`` against the JAX
package (reference active_subspaces.rs:281-386). Inputs are tie-free draws
in f64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrla_rs_tpu as crt
import corrla_rs_tpu_torch as port
from _torch_parity import cpu_device, same_sketch  # noqa: F401 (fixtures)
from corrla_rs_tpu.models import active_subspaces as jas
from corrla_rs_tpu.ops.knn import knn as jax_knn
from corrla_rs_tpu.utils.prng import as_key
from corrla_rs_tpu_torch import native
from corrla_rs_tpu_torch.models import active_subspaces as tas
from corrla_rs_tpu_torch.ops.knn import knn

torch.set_num_threads(1)

TOL = 1e-8


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def _aniso(n=120, k=3, seed=1):
    """The reference's anisotropic fixture (active_subspaces.rs:324-385),
    drawn with numpy."""
    rng = np.random.default_rng(seed)
    cov = np.full((k, k), 0.5) + 0.4 * np.eye(k)
    x = rng.standard_normal((n, k)) @ np.linalg.cholesky(cov).T
    y = (0.2 * x[:, 0] + 0.5 * x[:, 1] ** 2 + 0.1 * x[:, 2] * x[:, 0])
    return x, y[:, None]


def _same_up_to_sign(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    sign = np.sign(np.sum(a * b, axis=0))
    np.testing.assert_allclose(a * sign, b, rtol=0, atol=tol)


def test_knn_matches_jax(rng):
    xs = rng.standard_normal((50, 3))
    xq = rng.standard_normal((7, 3))
    d, idx = knn(torch.tensor(xq), torch.tensor(xs), 5)
    dj, ij = jax_knn(jnp.asarray(xq), jnp.asarray(xs), 5)
    assert idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ij))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-12,
                               atol=0)
    assert bool((d[:, 1:] >= d[:, :-1]).all())          # ascending


def test_knn_chunked_and_streamed_equal_dense(rng):
    xs = torch.tensor(rng.standard_normal((157, 4)))
    xq = torch.tensor(rng.standard_normal((23, 4)))
    d1, i1 = knn(xq, xs, 7)
    cases = [dict(query_chunk=8), dict(support_chunk=16),
             dict(support_chunk=50), dict(support_chunk=157),
             dict(support_chunk=200), dict(query_chunk=8, support_chunk=32),
             dict(support_chunk=7), dict(query_chunk=1, support_chunk=3)]
    for kw in cases:
        d2, i2 = knn(xq, xs, 7, **kw)
        assert torch.equal(i1, i2), kw
        torch.testing.assert_close(d2, d1, rtol=1e-12, atol=0)


def test_knn_k_validation(rng):
    xs = torch.tensor(rng.standard_normal((5, 2)))
    with pytest.raises(ValueError, match="exceeds"):
        knn(xs, xs, 6)


@pytest.mark.parametrize("order,n_nbrs", [(1, 10), (2, 14)])
def test_poly_gradients_match_jax(cpu_device, order, n_nbrs):
    x, y = _aniso()
    got = tas.PolyGradientEstimator(x, y, order, n_nbrs).grad_batch(x[:40])
    want = jas.PolyGradientEstimator(x, y, order, n_nbrs).grad_batch(x[:40])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL * np.abs(want).max())
    g0 = tas.PolyGradientEstimator(x, y, order, n_nbrs,
                                   query_chunk=16,
                                   support_chunk=33).grad_at(x[5])
    np.testing.assert_allclose(g0.numpy(), np.asarray(want)[5:6], rtol=0,
                               atol=TOL * np.abs(want).max())


def test_linear_order_recovers_the_plane(cpu_device, rng):
    x = rng.standard_normal((200, 3))
    y = (2.0 * x[:, 0] - 0.5 * x[:, 1] + 3.0)[:, None]
    g = tas.PolyGradientEstimator(x, y, est_order=1, n_nbrs=10).grad_batch(
        x[:5])
    np.testing.assert_allclose(g.numpy(), np.tile([[2.0, -0.5, 0.0]], (5, 1)),
                               atol=1e-8)


def test_native_kdtree_backend_matches_device(cpu_device):
    if not native.available():
        pytest.skip("needs g++ to build native/")
    x, y = _aniso()
    dev = tas.PolyGradientEstimator(x, y, 2, 14).grad_batch(x)
    nat = tas.PolyGradientEstimator(x, y, 2, 14, backend="native")
    torch.testing.assert_close(nat.grad_batch(x), dev, rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="backend"):
        tas.PolyGradientEstimator(x, y, 2, 14, backend="gpu")


def test_active_ss_api_matches_jax(cpu_device):
    x, y = _aniso()
    comps, vals, sensi = port.active_ss(x, y, 2, 14, 2)
    cj, vj, sj = crt.active_ss(x, y, 2, 14, 2)
    assert comps.shape == (3, 2) and vals.shape == (3, 2)
    assert sensi.shape == (3,)
    _same_up_to_sign(comps, cj)
    np.testing.assert_allclose(vals.numpy(), np.asarray(vj), rtol=0,
                               atol=TOL * float(np.abs(vj).max()))
    np.testing.assert_allclose(sensi.numpy(), np.asarray(sj), rtol=TOL)
    # x2 dominates the gradient variability (active_subspaces.rs:379-384)
    assert float(sensi[1]) > float(sensi[0])


def test_fitted_transforms_and_scores_match_jax(cpu_device):
    x, y = _aniso()
    ft = tas.ActiveSsRsvd(tas.PolyGradientEstimator(x, y, 2, 14), 2).fit(x)
    fj = jas.ActiveSsRsvd(jas.PolyGradientEstimator(x, y, 2, 14), 2).fit(x)
    np.testing.assert_allclose(ft.activity_scores().numpy(),
                               np.asarray(fj.activity_scores()), rtol=TOL)
    np.testing.assert_allclose(ft.var_diag_evd_sensi().numpy(),
                               np.asarray(fj.var_diag_evd_sensi()), rtol=TOL)
    tr = ft.transform(x)
    _same_up_to_sign(tr, fj.transform(jnp.asarray(x)), TOL * 10)
    back = ft.inv_transform(tr)
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(fj.inv_transform(fj.transform(x))),
                               atol=TOL * 10)
    with pytest.raises(TypeError, match="mesh"):
        tas.ActiveSsRsvd(tas.PolyGradientEstimator(x, y, 2, 14), 2).fit(
            x, mesh=object())


def test_fit_svd_matches_jax_same_sketch(same_sketch):
    x, y = _aniso()
    ft = tas.ActiveSsRsvd(tas.PolyGradientEstimator(x, y, 2, 14),
                          2).fit_svd(x, key=6)
    fj = jas.ActiveSsRsvd(jas.PolyGradientEstimator(x, y, 2, 14),
                          2).fit_svd(x, key=6)
    np.testing.assert_allclose(np.diag(ft.singular_vals_.numpy()),
                               np.diag(np.asarray(fj.singular_vals_)),
                               rtol=TOL)
    _same_up_to_sign(ft.components, fj.components)


def test_fit_bootstrap_matches_jax_same_indices(cpu_device, monkeypatch):
    monkeypatch.setattr(
        tas, "_bootstrap_indices",
        lambda key, n_boot, n, device: torch.tensor(np.asarray(
            jax.random.randint(as_key(key), (n_boot, n), 0, n))))
    x, y = _aniso()
    bt = tas.ActiveSsRsvd(tas.PolyGradientEstimator(x, y, 2, 14),
                          2).fit_bootstrap(x, n_boot=20, key=2)
    bj = jas.ActiveSsRsvd(jas.PolyGradientEstimator(x, y, 2, 14),
                          2).fit_bootstrap(x, n_boot=20, key=2)
    for name in ("eigs", "eig_lo", "eig_hi", "subspace_dist"):
        np.testing.assert_allclose(bt[name].numpy(), np.asarray(bj[name]),
                                   rtol=0, atol=TOL, err_msg=name)
    assert bt["subspace_dist"].shape == (20,)


def test_bootstrap_own_draw_runs(cpu_device):
    x, y = _aniso()
    bt = tas.ActiveSsRsvd(tas.PolyGradientEstimator(x, y, 2, 14),
                          2).fit_bootstrap(x, n_boot=8, key=1)
    assert bool((bt["eig_lo"] <= bt["eig_hi"]).all())


def test_ad_gradient_estimator_matches_jax(cpu_device, rng):
    x = rng.standard_normal((9, 4))
    at = tas.AdGradientEstimator(lambda v: torch.sum(torch.sin(v) * v))
    aj = jas.AdGradientEstimator(lambda v: jnp.sum(jnp.sin(v) * v))
    np.testing.assert_allclose(at.grad_batch(torch.tensor(x)).numpy(),
                               np.asarray(aj.grad_batch(x)), rtol=1e-12)
    np.testing.assert_allclose(at.grad_at(torch.tensor(x[0])).numpy(),
                               np.asarray(aj.grad_at(x[0])), rtol=1e-12)
    fit = tas.ActiveSsRsvd(at, 2).fit(torch.tensor(x))
    assert fit.components.shape == (4, 2)


def test_converted_fitted_subspace_matches_jax(cpu_device, tmp_path):
    from corrla_rs_tpu.utils.checkpoint import save_model
    from corrla_rs_tpu_torch.utils.convert import (
        from_jax_state,
        load_jax_checkpoint,
    )

    x, y = _aniso()
    fj = jas.ActiveSsRsvd(jas.PolyGradientEstimator(x, y, 2, 14), 2).fit(x)
    save_model(str(tmp_path / "f.npz"), fj)
    for ft in (from_jax_state("FittedActiveSsRsvd", vars(fj)),
               load_jax_checkpoint(str(tmp_path / "f.npz"))):
        assert isinstance(ft, tas.FittedActiveSsRsvd) and ft.n_comps == 2
        np.testing.assert_allclose(ft.transform(x).numpy(),
                                   np.asarray(fj.transform(x)), rtol=1e-12)
        np.testing.assert_allclose(ft.var_diag_evd_sensi().numpy(),
                                   np.asarray(fj.var_diag_evd_sensi()),
                                   rtol=1e-12)
