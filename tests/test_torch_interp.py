"""Port parity: rbf_fit / rbf_predict / RbfInterp against the JAX package.

The saddle system [[K, P], [P^T, 0]] is indefinite and can be
ill-conditioned, so the two LU (or pinv) solves agree to what its condition
number allows: each tolerance is eps(dtype) * cond(system), computed in f64
for the inputs at hand (measured agreement is 10-1000x inside it).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import EPS, cpu_device  # noqa: F401 (fixture)
from corrla_rs_tpu.ops import interp as jax_interp
from corrla_rs_tpu.ops.stats_corr import build_full_vandermonde as jax_vand
from corrla_rs_tpu_torch.ops import interp as port_interp
from corrla_rs_tpu_torch.ops.stats_corr import build_full_vandermonde

torch.set_num_threads(1)

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden_values.npz")


def _saddle_cond(x, kernel, eps, degree):
    x64 = jnp.asarray(np.asarray(x, np.float64))
    k = np.asarray(jax_interp.rbf_kernel_eval(
        jax_interp.pairwise_dists(x64, x64), kernel, eps))
    p = np.asarray(jax_vand(x64, degree))
    z = np.zeros((p.shape[1], p.shape[1]))
    return np.linalg.cond(np.block([[k, p], [p.T, z]]))


def _fit_predict_both(x, y, xq, kernel, eps, degree, method):
    cj = jax_interp.rbf_fit(jnp.asarray(x), jnp.asarray(y), kernel, eps,
                            degree, method)
    pj = jax_interp.rbf_predict(jnp.asarray(x), cj, jnp.asarray(xq), kernel,
                                eps, degree)
    t = torch.from_numpy
    ct = port_interp.rbf_fit(t(x), t(y), kernel, eps, degree, method)
    pt = port_interp.rbf_predict(t(x), ct, t(xq), kernel, eps, degree)
    return (np.asarray(cj), np.asarray(pj)), (ct.numpy(), pt.numpy())


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("method", ["solve", "pinv"])
@pytest.mark.parametrize("kernel,degree", [
    ("linear", 1), ("multiquadric", 1), ("cubic", 2), ("gaussian", 1),
    ("gaussian", 2),
])
def test_rbf_fit_predict_match_jax_f64(rng, kernel, degree, method):
    x = 4.0 * rng.random((40, 2))
    y = np.stack([np.sin(x[:, 0]) + x[:, 1], np.cos(x[:, 1])], axis=1)
    xq = 4.0 * rng.random((25, 2))
    (cj, pj), (ct, pt) = _fit_predict_both(x, y, xq, kernel, 1.3, degree,
                                           method)
    assert ct.shape == (40 + (3 if degree < 2 else 6), 2)
    tol = EPS[np.float64] * _saddle_cond(x, kernel, 1.3, degree)
    assert tol < 1e-7   # the comparison means something
    assert _rel(ct, cj) <= tol
    assert _rel(pt, pj) <= tol


@pytest.mark.parametrize("method", ["solve", "pinv"])
def test_rbf_linear_matches_jax_f32(rng, method):
    # the linear kernel is the one PodI and the chip's RbfInterp run in f32;
    # its saddle system is well-conditioned (cond ~ 1e3)
    x = (4.0 * rng.random((40, 3))).astype(np.float32)
    y = (np.sin(x[:, :1]) * x[:, 1:2] + x[:, 2:]).astype(np.float32)
    xq = (4.0 * rng.random((30, 3))).astype(np.float32)
    (cj, pj), (ct, pt) = _fit_predict_both(x, y, xq, "linear", 1.0, 1,
                                           method)
    assert ct.dtype == np.float32
    tol = EPS[np.float32] * _saddle_cond(x, "linear", 1.0, 1)
    assert tol < 1e-3
    assert _rel(ct, cj) <= tol
    assert _rel(pt, pj) <= tol


@pytest.mark.parametrize("code,name", [(1, "linear"), (2, "multiquadric"),
                                       (3, "cubic"), (7, "gaussian")])
def test_rbf_interp_class_matches_jax(cpu_device, rng, code, name):
    x = 3.0 * rng.random((30, 3))
    y = np.sin(x[:, 0]) * x[:, 1] - x[:, 2]
    xq = 3.0 * rng.random((12, 3))
    mj = jax_interp.RbfInterp(code, 1.1, 3, 1).fit(x, y)
    mt = port_interp.RbfInterp(code, 1.1, 3, 1).fit(x, y)
    assert mt.kernel == mj.kernel == name
    assert mt.coeffs.shape == (34, 1) and mt.x_known.device.type == "cpu"
    tol = EPS[np.float64] * _saddle_cond(x, name, 1.1, 1)
    pt = mt.predict(xq).numpy()
    assert pt.shape == (12, 1)
    assert _rel(pt, np.asarray(mj.predict(xq))) <= tol
    # interpolation is exact at the support points (to the solve's accuracy)
    np.testing.assert_allclose(mt.predict(x).numpy()[:, 0], y,
                               atol=tol * np.abs(y).max())


def test_rbf_interp_checks_dim(cpu_device, rng):
    m = port_interp.RbfInterp("cubic", 1.0, dim=2)
    with pytest.raises(ValueError, match=r"expected \(n, 2\)"):
        m.fit(rng.random((10, 3)), rng.random(10))
    m.fit(rng.random((10, 2)), rng.random(10))
    with pytest.raises(ValueError, match=r"expected \(n, 2\)"):
        m.predict(rng.random((4, 3)))


def test_vandermonde_matches_jax(rng):
    x = rng.standard_normal((9, 3))
    for degree in (0, 1, 2, 3):
        np.testing.assert_array_equal(
            build_full_vandermonde(torch.from_numpy(x), degree).numpy(),
            np.asarray(jax_vand(jnp.asarray(x), degree)),
        )


def test_rbf_goldens():
    # the JAX package's recorded f64 goldens (tests/test_golden.py), with
    # its inputs regenerated from the same seed and draw order
    golden = np.load(GOLDEN_PATH)
    rng = np.random.default_rng(12345)
    rng.standard_normal((80, 24))
    rng.standard_normal((200, 5))
    xi = torch.from_numpy(rng.standard_normal((30, 2)))
    yi = torch.sin(xi[:, :1])
    coeffs = port_interp.rbf_fit(xi, yi, "multiquadric", 1.0, 1)
    pred = port_interp.rbf_predict(xi, coeffs, xi[:7], "multiquadric", 1.0, 1)
    # the goldens' own tolerance (test_golden.py) holds for the prediction;
    # the coefficients of this cond ~1e9 system agree to eps * cond
    np.testing.assert_allclose(pred.numpy(), golden["rbf_pred"], rtol=1e-9,
                               atol=1e-12)
    tol = EPS[np.float64] * _saddle_cond(xi.numpy(), "multiquadric", 1.0, 1)
    assert _rel(coeffs.numpy(), golden["rbf_coeffs"]) <= tol
