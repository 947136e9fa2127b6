"""Port parity: every function of ops/mat_utils and ops/stats_corr against
the JAX package (f64, 1e-12), plus the recorded goldens ``pearson`` and
``linfit`` (tests/golden_values.npz)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cpu_device, same_sketch  # noqa: F401 (fixtures)
from corrla_rs_tpu.ops import mat_utils as jm
from corrla_rs_tpu.ops import stats_corr as js
from corrla_rs_tpu_torch.ops import mat_utils as tm
from corrla_rs_tpu_torch.ops import stats_corr as ts

torch.set_num_threads(1)

TOL = 1e-12
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden_values.npz")


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def test_goldens_pearson_and_linfit():
    rng = np.random.default_rng(12345)
    rng.standard_normal((80, 24))                # the goldens' rsvd input
    x = rng.standard_normal((200, 5))
    golden = np.load(GOLDEN_PATH)
    np.testing.assert_allclose(ts.pearson_corr(_t(x)).numpy(),
                               golden["pearson"], rtol=1e-9, atol=1e-12)
    y = (2.0 * x[:, 0] - x[:, 2] + 0.5)[:, None]
    np.testing.assert_allclose(ts.linear_fit(_t(x), _t(y)).numpy(),
                               golden["linfit"], rtol=1e-9, atol=1e-12)


def test_pinv_diag_truncated_svd_sort_evd(rng):
    d = np.diag([3.0, 0.0, 1e-25, -2.0])
    _close(tm.pinv_diag(_t(d)), jm.pinv_diag(jnp.asarray(d)))
    a = rng.standard_normal((9, 6))
    u, s, vt = tm.truncated_svd(_t(a), 3)
    uj, sj, vtj = jm.truncated_svd(jnp.asarray(a), 3)
    _close(s, sj)
    _close(u @ u.mT, np.asarray(uj) @ np.asarray(uj).T)
    _close(vt.mT @ vt, np.asarray(vtj).T @ np.asarray(vtj))
    e = np.array([0.5, -3.0, 2.0, 2.0, -0.1])     # value order, not |.|
    v = rng.standard_normal((7, 5))
    for eigs in (e, np.diag(e)):
        got_d, got_v = tm.sort_evd(_t(eigs), _t(v))
        want_d, want_v = jm.sort_evd(jnp.asarray(eigs), jnp.asarray(v))
        _close(got_d, want_d, 0)
        _close(got_v, want_v, 0)


def test_centering_and_linspace_quirk(rng):
    a = rng.standard_normal((11, 4)) * 3 + 1
    _close(tm.zcenter_mat_col(_t(a)), jm.zcenter_mat_col(jnp.asarray(a)))
    _close(tm.center_mat_col(_t(a)), jm.center_mat_col(jnp.asarray(a)))
    got = tm.mat_linspace(2.0, 10.0, 8, torch.float64)
    _close(got, jm.mat_linspace(2.0, 10.0, 8, jnp.float64), 0)
    assert float(got[0, 0]) == 0.0     # start is ignored, end excluded


@pytest.mark.parametrize("mode,eps", [("reference", 1e-16),
                                      ("cutoff", 1e-10)])
def test_mat_pinv_comp(rng, mode, eps):
    x = rng.standard_normal((8, 3)) + 1j * rng.standard_normal((8, 3))
    x[:, 2] = x[:, 0] * 1e-13 if mode == "cutoff" else x[:, 2]
    got = tm.mat_pinv_comp(torch.tensor(x), eps=eps, mode=mode)
    _close(got, jm.mat_pinv_comp(x, eps=eps, mode=mode))
    with pytest.raises(ValueError, match="mode"):
        tm.mat_pinv_comp(x, mode="nope")


@pytest.mark.parametrize("dtype,tol", [(np.float64, TOL), (np.float32, 1e-4)])
def test_pinv_comp_parts(rng, dtype, tol):
    xr = rng.standard_normal((10, 4))
    xi = rng.standard_normal((10, 4))
    xr[:, 3], xi[:, 3] = xr[:, 0], xi[:, 0]          # rank 3: the cutoff bites
    xr, xi = xr.astype(dtype), xi.astype(dtype)
    pr, pi = tm.pinv_comp_parts(_t(xr), _t(xi))
    jr, ji = jm.pinv_comp_parts(jnp.asarray(xr), jnp.asarray(xi))
    assert pr.dtype == torch.from_numpy(xr).dtype and pr.shape == (4, 10)
    _close(pr, jr, tol)
    _close(pi, ji, tol)
    # batched: each member as alone
    br, bi = tm.pinv_comp_parts(_t(np.stack([xr, 2 * xr])),
                                _t(np.stack([xi, 2 * xi])))
    _close(br[1], np.asarray(jr) / 2, tol)
    _close(bi[0], ji, tol)


def test_complex_parts_operator_and_fd(rng):
    re, im = rng.standard_normal((3, 4)), rng.standard_normal((3, 4))
    c = tm.complex_from_parts(_t(re), _t(im))
    _close(c, jm.complex_from_parts(re, im), 0)
    r2, i2 = tm.parts_from_complex(c)
    _close(r2, re, 0)
    _close(i2, im, 0)
    a, blk = rng.standard_normal((5, 5)), rng.standard_normal((5, 2))
    _close(tm.apply_operator(_t(a), _t(blk)), a @ blk)
    _close(tm.apply_operator(lambda b: _t(a) @ b, _t(blk)), a @ blk)
    x = rng.standard_normal((12, 3))
    _close(tm.fd_derivative(_t(x), 0.1),
           jm.fd_derivative(jnp.asarray(x), 0.1))


def test_correlation_covariance_sandwich_rsquared(rng):
    x = rng.standard_normal((60, 4))
    y = (x @ np.array([1.0, -0.5, 0.0, 0.2]) + 0.3 * rng.standard_normal(60))
    y = y[:, None]
    _close(ts.pearson_corr(_t(x)), js.pearson_corr(jnp.asarray(x)))
    _close(ts.mat_cov_centered(_t(x)), js.mat_cov_centered(jnp.asarray(x)))
    cov, jac = np.cov(x.T), rng.standard_normal((2, 4))
    _close(ts.sandwich_prop(_t(cov), _t(jac)),
           js.sandwich_prop(jnp.asarray(cov), jnp.asarray(jac)))
    for dof in (False, True):
        got = ts.rsquared_sens(_t(x), _t(y), cor_dof=dof)
        assert got.shape == (1, 1)
        _close(got, js.rsquared_sens(jnp.asarray(x), jnp.asarray(y), dof))


@pytest.mark.parametrize("mode", ["cholesky", "reference"])
def test_sample_mv_normal_same_draw(same_sketch, mode):
    cov = np.array([[0.9, 0.5], [0.5, 0.9]])
    got = ts.sample_mv_normal(cov, 50, key=3, mode=mode)
    _close(got, js.sample_mv_normal(jnp.asarray(cov), 50, key=3, mode=mode))


def test_interactions_fits_and_vandermonde(rng):
    x = rng.standard_normal((30, 3))
    y = rng.standard_normal((30, 2))
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    for inc in (True, False):
        _close(ts.mat_col_interactions(_t(x), inc),
               js.mat_col_interactions(xj, inc), 0)
        _close(ts.build_vandermonde(_t(x), inc),
               js.build_vandermonde(xj, inc), 0)
    for deg in (1, 2):
        _close(ts.build_full_vandermonde(_t(x), deg),
               js.build_full_vandermonde(xj, deg), 0)
    _close(ts.mat_col_powers(_t(x), 3), js.mat_col_powers(xj, 3))
    _close(ts.linear_fit(_t(x), _t(y)), js.linear_fit(xj, yj))
    _close(ts.jac_from_lin(_t(x), _t(y)), js.jac_from_lin(xj, yj))
    coeffs = ts.quad_fit(_t(x), _t(y))
    _close(coeffs, js.quad_fit(xj, yj))
    _close(ts.quad_eval(_t(x), coeffs), js.quad_eval(xj, js.quad_fit(xj, yj)))


@pytest.mark.parametrize("k", [1, 2, 5])
def test_jac_from_quad_closed_form_matches_autodiff(rng, k):
    # the JAX package differentiates quad_eval with vmap(grad); the port's
    # closed form must give the same gradients, also batched
    coeffs = rng.standard_normal((k + k * (k + 1) // 2 + 1, 2))
    x0 = rng.standard_normal((7, k))
    want = js.jac_from_quad(jnp.asarray(x0), jnp.asarray(coeffs))
    _close(ts.jac_from_quad(_t(x0), _t(coeffs)), want)
    batched = ts.jac_from_quad(_t(x0)[:, None, :],
                               _t(np.broadcast_to(coeffs, (7,) + coeffs.shape)))
    _close(batched[:, 0, :], want)
    # and the gradient is the derivative of quad_eval's first column
    g = jax.vmap(jax.grad(lambda r: js.quad_eval(r[None], jnp.asarray(
        coeffs))[0, 0]))(jnp.asarray(x0))
    _close(ts.jac_from_quad(_t(x0), _t(coeffs)), g)
