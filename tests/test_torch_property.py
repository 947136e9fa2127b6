"""The JAX suite's random-shape sweeps and f32 lanes, run on the port.

The counterpart of ``tests/test_property.py`` and ``tests/test_f32_smoke.py``
for ``corrla_rs_tpu_torch``, on the CPU: every test of ``test_property.py``
in its order, with its seed grid (``_seeds(n, n_default)``: the seeds past
``n_default`` run with ``-m slow``), its configurations drawn from numpy
generators seeded as there, and its oracles and limits. Where a JAX test
draws from a key, the port draws through its own seam from the same int
seed (a ``torch.Generator``); the oracles do not depend on the draws.

Then both f32 lanes of ``test_f32_smoke.py`` in process (the JAX file runs
them in a subprocess because x64 is a process-wide switch in JAX; in the
port the inputs' dtype decides): the main path (POD sigma and field, the
DMDc sine fixture, the RBF saddle solve, the rejection sampler) and wave 3
(SPOD, ``HankelDmd``, ``OptDmd``, ERA, ``sketched_lstsq``, ``robust_pca``),
at that file's shapes and limits, each output also held to f32.
"""
import numpy as np
import pytest
import torch

from _torch_parity import cpu_device  # noqa: F401
from corrla_rs_tpu_torch.ops.interp import RbfInterp
from corrla_rs_tpu_torch.ops.random_svd import random_svd
from corrla_rs_tpu_torch.ops.samplers import constr_dirichlet_sample

torch.set_num_threads(1)

pytestmark = pytest.mark.usefixtures("cpu_device")


def _seeds(n, n_default=2):
    """Seed grid tiering (test_property.py's): the first `n_default` random
    configs run in the default lane; the rest of the sweep runs with -m
    slow."""
    return [
        s if s < n_default else pytest.param(s, marks=pytest.mark.slow)
        for s in range(n)
    ]


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _polyval(coeffs, x):
    """numpy's polyval (highest power first) by Horner, traceable."""
    out = torch.zeros_like(x)
    for c in coeffs:
        out = out * x + float(c)
    return out


@pytest.mark.parametrize("seed", _seeds(6))
def test_rsvd_random_configs(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(8, 300))
    n = int(rng.integers(8, 300))
    rank = int(rng.integers(1, min(m, n, 12) + 1))
    n_iter = int(rng.integers(4, 16))
    n_over = int(rng.integers(2, 12))
    a = rng.standard_normal((m, n))
    u, s, vt = random_svd(torch.as_tensor(a), rank, n_iter, n_over, key=seed)
    assert u.shape == (m, rank) and s.shape == (rank,)
    assert vt.shape == (rank, n)
    assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(vt).all())
    s_exact = np.linalg.svd(a, compute_uv=False)
    # leading singular value always well converged; all estimates bounded
    np.testing.assert_allclose(float(s[0]), s_exact[0], rtol=1e-2)
    assert (_np(s) <= s_exact[0] * (1 + 1e-6)).all()
    assert (_np(s) >= -1e-9).all()


@pytest.mark.parametrize("seed", _seeds(4))
def test_rsvd_exact_low_rank_random(seed):
    rng = np.random.default_rng(100 + seed)
    m = int(rng.integers(30, 200))
    n = int(rng.integers(30, 200))
    r = int(rng.integers(1, 6))
    a = rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
    u, s, vt = random_svd(torch.as_tensor(a), r, 12, 8, key=seed)
    recon = _np(u) @ np.diag(_np(s)) @ _np(vt)
    np.testing.assert_allclose(recon, a, atol=1e-6)


@pytest.mark.parametrize("seed", _seeds(4))
def test_dirichlet_random_feasible_bounds(seed):
    rng = np.random.default_rng(200 + seed)
    d = int(rng.integers(2, 6))
    # build feasible bounds around a random simplex point
    center = rng.dirichlet(np.ones(d))
    width = rng.uniform(0.05, 0.3)
    bounds = np.stack(
        [np.clip(center - width, 0, 1), np.clip(center + width, 0, 1)],
        axis=1,
    )
    s = constr_dirichlet_sample(bounds, 32, 500, 200_000, 1.0, key=seed)
    arr = _np(s)
    np.testing.assert_allclose(arr.sum(axis=1), 1.0, atol=1e-6)
    assert (arr >= bounds[:, 0][None, :] - 1e-12).all()
    assert (arr <= bounds[:, 1][None, :] + 1e-12).all()


def test_dirichlet_c_scale_device():
    bounds = np.array([[0.0, 0.01], [0.7, 0.9], [0.2, 0.4]]) * 2.0
    s = constr_dirichlet_sample(bounds, 16, 500, 100_000, 2.0, key=0)
    np.testing.assert_allclose(_np(s).sum(axis=1), 2.0, atol=1e-6)


def test_rbf_duplicate_support_points(rng):
    # exact duplicate rows make the kernel matrix singular; the LU default
    # cannot solve it, but the reference-parity pinv path must survive
    # (interp_utils.rs:131-144 uses pinv unconditionally).
    x = rng.standard_normal((20, 2))
    x = np.concatenate([x, x[:3]], axis=0)  # 3 duplicates
    y = np.sin(x[:, :1])
    rbf = RbfInterp(2, 1.0, 2, 1, method="pinv").fit(x, y)
    pred = rbf.predict(x[:5])
    assert bool(torch.isfinite(pred).all())
    # interpolation quality still reasonable away from the degeneracy
    assert float(np.max(np.abs(_np(pred) - y[:5]))) < 0.2


def test_rsvd_zero_matrix():
    a = torch.zeros((40, 10), dtype=torch.float64)
    u, s, vt = random_svd(a, 3, 8, 5, key=0)
    np.testing.assert_allclose(_np(s), 0.0, atol=1e-12)
    assert bool(torch.isfinite(u).all())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rsvd_dtypes(dtype, rng):
    a = rng.standard_normal((100, 30)).astype(dtype)
    u, s, vt = random_svd(torch.as_tensor(a), 4, 10, 8, key=0)
    assert u.dtype == getattr(torch, dtype)
    s_exact = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    # f64 with the reference skip-QR heuristic converges trailing sigmas
    # only to ~1e-5 rel on gapless Gaussian spectra (same as the reference)
    rtol = 1e-3 if dtype == "float32" else 1e-5
    np.testing.assert_allclose(_np(s).astype(np.float64), s_exact[:4],
                               rtol=rtol)


@pytest.mark.parametrize("seed", _seeds(6, n_default=1))
def test_eig_device_random_configs(seed):
    from corrla_rs_tpu_torch.ops.eig_device import eig_device

    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(2, 40))
    scale = 10.0 ** rng.integers(-3, 4)
    a = rng.standard_normal((n, n)) * scale
    lr, li, vr, vi = eig_device(torch.as_tensor(a))
    lam = _np(lr) + 1j * _np(li)
    ref = np.sort_complex(np.linalg.eigvals(a))
    np.testing.assert_allclose(
        np.sort_complex(lam) / (scale * max(n, 1)),
        ref / (scale * max(n, 1)), atol=1e-12,
    )
    v = _np(vr) + 1j * _np(vi)
    resid = np.abs(a @ v - v * lam[None, :]).max()
    assert resid < 1e-10 * scale * n, (n, scale, resid)


@pytest.mark.parametrize("seed", _seeds(4))
def test_era_random_stable_systems(seed):
    # random stable (A, B, C) of random sizes: ERA recovers the poles
    # from the Markov stack at f64 tolerance
    from corrla_rs_tpu_torch import era

    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(2, 6))
    p = int(rng.integers(1, 3))
    q = int(rng.integers(1, 3))
    qm, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = rng.uniform(-0.9, 0.9, n)
    a = qm @ np.diag(lam) @ qm.T
    b = rng.standard_normal((n, p))
    c = rng.standard_normal((q, n))
    hs = np.empty((30, q, p))
    ca = c.copy()
    for k in range(30):
        hs[k] = ca @ b
        ca = ca @ a
    fit = era(hs, rank=n)
    np.testing.assert_allclose(np.sort_complex(fit.lambdas),
                               np.sort_complex(lam.astype(complex)),
                               atol=1e-6)


@pytest.mark.parametrize("seed", _seeds(4))
def test_sketched_lstsq_random_shapes(seed):
    from corrla_rs_tpu_torch import sketched_lstsq

    rng = np.random.default_rng(200 + seed)
    n = int(rng.integers(4, 40))
    m = int(rng.integers(4 * n + 16, 2000))
    a = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    x, _ = sketched_lstsq(a, b, key=seed)
    x_ref, *_ = np.linalg.lstsq(a, b, rcond=None)
    np.testing.assert_allclose(_np(x), x_ref, atol=1e-8)


@pytest.mark.parametrize("seed", _seeds(3))
def test_pidmd_orthogonal_random_shapes(seed):
    from corrla_rs_tpu_torch import PiDmd

    rng = np.random.default_rng(300 + seed)
    n = int(rng.integers(4, 24))
    m = int(rng.integers(3 * n, 6 * n))
    qm, _ = np.linalg.qr(rng.standard_normal((n, n)))
    x = np.empty((n, m))
    x[:, 0] = rng.standard_normal(n)
    for k in range(1, m):
        x[:, k] = qm @ x[:, k - 1]
    fit = PiDmd(x + 0.01 * rng.standard_normal(x.shape), n_modes=n,
                family="orthogonal")
    np.testing.assert_allclose(np.abs(_np(fit.lambdas)), 1.0, atol=1e-9)


@pytest.mark.parametrize("seed", _seeds(3))
def test_spod_random_shapes_orthonormal(seed):
    from corrla_rs_tpu_torch import spod

    rng = np.random.default_rng(400 + seed)
    n_x = int(rng.integers(2, 20))
    n_fft = int(2 ** rng.integers(4, 7))
    n_t = n_fft * int(rng.integers(4, 9))
    fit = spod(rng.standard_normal((n_x, n_t)), n_fft=n_fft)
    e = _np(fit.energies)
    assert np.all(np.isfinite(e)) and np.all(e >= 0)
    assert np.all(np.isfinite(_np(fit.modes_re)))
    # energetic modes orthonormal at a random interior bin
    bin_i = int(rng.integers(1, n_fft // 2))
    phi = _np(fit.modes_re[bin_i]) + 1j * _np(fit.modes_im[bin_i])
    norms = np.linalg.norm(phi, axis=0)
    good = norms > 0.5
    if np.any(good):
        g = phi[:, good].conj().T @ phi[:, good]
        np.testing.assert_allclose(g, np.eye(int(good.sum())),
                                   atol=1e-7)


@pytest.mark.parametrize("seed", _seeds(3))
def test_cp_random_exact_rank(seed):
    from corrla_rs_tpu_torch import cp_als

    rng = np.random.default_rng(500 + seed)
    d = int(rng.integers(3, 5))
    shape = tuple(int(rng.integers(4, 12)) for _ in range(d))
    r = int(rng.integers(1, 4))
    factors = [rng.standard_normal((s, r)) for s in shape]
    subs = "abcdefgh"[:d]
    spec = ",".join(f"{s}r" for s in subs) + "->" + subs
    t = np.einsum(spec, *factors)
    _, _, fits = cp_als(t, r, n_sweeps=120, key=seed)
    assert float(fits[-1]) > 1 - 1e-6


# ---------------------------------------------------------------------------
# randomized invariants for the statistical families: enkf, smc, psis,
# quadrature (test_property.py's second half)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", _seeds(4))
def test_enkf_mean_is_sample_kalman_mean(seed):
    """Deterministic identity (stronger than the N->inf limit): with
    CENTERED perturbations and a linear h, both the stochastic EnKF and
    the ETKF analysis MEAN equal the exact Kalman update built from the
    SAMPLE covariances, for every random shape/fixture."""
    from corrla_rs_tpu_torch.ops.enkf import enkf_analysis, etkf_analysis

    rng = np.random.default_rng(300 + seed)
    n_ens = int(rng.integers(8, 64))
    n = int(rng.integers(2, 20))
    p = int(rng.integers(1, min(n, 6) + 1))
    x_ens = rng.standard_normal((n_ens, n))
    h = rng.standard_normal((p, n))
    y = rng.standard_normal(p)
    r_diag = rng.uniform(0.1, 1.0, p)

    xbar = x_ens.mean(0)
    xa = x_ens - xbar
    pb = xa.T @ xa / (n_ens - 1)
    s = h @ pb @ h.T + np.diag(r_diag)
    gain = pb @ h.T @ np.linalg.inv(s)
    mean_exact = xbar + gain @ (y - h @ xbar)

    a_sto = enkf_analysis(x_ens, y, h, r_diag, seed)
    a_det = etkf_analysis(x_ens, y, h, r_diag)
    np.testing.assert_allclose(_np(a_sto).mean(0), mean_exact, atol=1e-8)
    np.testing.assert_allclose(_np(a_det).mean(0), mean_exact, atol=1e-8)


@pytest.mark.parametrize("seed", _seeds(3))
def test_enkf_woodbury_random_shapes(seed):
    """The ensemble-space (Woodbury) kernel must agree with the
    obs-space kernel on random p > N problems with diagonal R (the port's
    kernels take the members' view, here without a mesh)."""
    from corrla_rs_tpu_torch.ops.enkf import _enkf_ens_space, _enkf_obs_space
    from corrla_rs_tpu_torch.parallel.mesh import _member_view

    rng = np.random.default_rng(330 + seed)
    n_ens = int(rng.integers(4, 16))
    n = int(rng.integers(2, 12))
    p = n_ens + int(rng.integers(1, 40))
    x_ens = torch.as_tensor(rng.standard_normal((n_ens, n)))
    y_ens = torch.as_tensor(rng.standard_normal((n_ens, p)))
    d_pert = torch.as_tensor(rng.standard_normal((n_ens, p)))
    r_diag = torch.as_tensor(rng.uniform(0.2, 2.0, p))
    sh = _member_view(x_ens, None, None, "the ensemble size")
    a1 = _enkf_obs_space(x_ens, y_ens, d_pert, torch.diag(r_diag), sh)
    a2 = _enkf_ens_space(x_ens, y_ens, d_pert, 1.0 / r_diag, sh)
    np.testing.assert_allclose(_np(a2), _np(a1), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("seed", _seeds(3))
def test_smc_evidence_random_gaussian(seed):
    """SMC log-evidence vs the analytic normalizer of a random
    linear-Gaussian model: prior N(0, a^2 I), unnormalized Gaussian
    likelihood exp(-|x-mu|^2 / (2 b^2)). The adaptive ladder differs
    per seed."""
    from corrla_rs_tpu_torch.ops.smc import smc_sample

    rng = np.random.default_rng(400 + seed)
    d = int(rng.integers(1, 4))
    a = float(rng.uniform(0.8, 2.0))
    b = float(rng.uniform(0.3, 1.0))
    mu = rng.uniform(-1.0, 1.0, d)
    mu_t = torch.as_tensor(mu)

    def ln_like(x):
        return -0.5 * torch.sum((x - mu_t) ** 2) / b**2

    def ln_prior(x):
        return (-0.5 * torch.sum(x**2) / a**2
                - 0.5 * d * np.log(2.0 * np.pi * a**2))

    logz_true = float(np.sum(
        np.log(b) - 0.5 * np.log(a**2 + b**2)
        - mu**2 / (2.0 * (a**2 + b**2))))
    init = rng.standard_normal((1024, d)) * a
    res = smc_sample(ln_like, ln_prior, init, n_mcmc=4, key=seed)
    assert abs(res.log_evidence - logz_true) < 0.15 + 0.05 * abs(logz_true)
    # posterior moments: N(mu * a^2/(a^2+b^2), (a^-2 + b^-2)^-1 I)
    post_mean = mu * a**2 / (a**2 + b**2)
    post_std = (1.0 / a**2 + 1.0 / b**2) ** -0.5
    parts = _np(res.particles)
    np.testing.assert_allclose(parts.mean(0), post_mean,
                               atol=5.0 * post_std / np.sqrt(1024) * 4)
    np.testing.assert_allclose(parts.std(0), post_std, rtol=0.25)


@pytest.mark.parametrize("seed", _seeds(3))
def test_psis_khat_regimes(seed):
    """k-hat must separate the importance-weight regimes: near-uniform
    (finite-variance) weights => k_hat < 0.5; Pareto(alpha<1.4) weights
    (infinite variance, tail index 1/alpha > 0.7) => k_hat > 0.6 and
    near the true index. Smoothed weights stay normalized and
    rank-ordered."""
    from corrla_rs_tpu_torch.ops.psis import psis

    rng = np.random.default_rng(500 + seed)
    n = 4000
    # light regime: lognormal weights, all moments finite
    lw_light = rng.normal(0.0, rng.uniform(0.2, 0.6), n)
    r_light = psis(lw_light)
    assert r_light.k_hat < 0.5
    # heavy regime: w = u^(-1/alpha) is Pareto with tail index 1/alpha
    alpha = float(rng.uniform(1.0, 1.4))
    lw_heavy = -np.log(rng.uniform(size=n)) / alpha
    r_heavy = psis(lw_heavy)
    assert r_heavy.k_hat > 0.6
    assert abs(r_heavy.k_hat - 1.0 / alpha) < 0.3
    for r in (r_light, r_heavy):
        w = np.exp(_np(r.log_weights))
        np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-10)
        assert 1.0 <= r.ess <= n + 1e-9
    assert r_heavy.ess < r_light.ess


@pytest.mark.parametrize("seed", _seeds(4))
def test_gauss_legendre_random_poly_exact(seed):
    """n-point Gauss-Legendre integrates random polynomials of degree
    2n-1 exactly on random intervals."""
    from corrla_rs_tpu_torch.ops.quadrature import gauss_legendre, integrate

    rng = np.random.default_rng(600 + seed)
    n = int(rng.integers(2, 12))
    deg = 2 * n - 1
    coeffs = rng.standard_normal(deg + 1)
    a = float(rng.uniform(-3.0, 0.0))
    b = a + float(rng.uniform(0.5, 4.0))
    rule = gauss_legendre(n, a, b)
    got = integrate(lambda x: _polyval(coeffs, x[0]), rule)
    k = np.arange(deg, -1, -1)
    exact = float(np.sum(coeffs * (b ** (k + 1) - a ** (k + 1)) / (k + 1)))
    scale = max(1.0, abs(exact))
    assert abs(got - exact) < 1e-9 * scale


@pytest.mark.parametrize("seed", _seeds(3))
def test_gauss_hermite_random_moments(seed):
    """n-point Gauss-Hermite (standard-normal weight) reproduces
    E[X^k] = 0 (odd) / (k-1)!! (even) for every k <= 2n-1."""
    from corrla_rs_tpu_torch.ops.quadrature import gauss_hermite, integrate

    rng = np.random.default_rng(650 + seed)
    n = int(rng.integers(3, 10))
    rule = gauss_hermite(n)
    for k in range(2 * n):
        got = integrate(lambda x, k=k: x[0] ** k, rule)
        exact = 0.0 if k % 2 else float(
            np.prod(np.arange(k - 1, 0, -2))) if k else 1.0
        assert abs(got - exact) < 1e-8 * max(1.0, abs(exact)), (n, k)


@pytest.mark.parametrize("seed", _seeds(3))
def test_clenshaw_curtis_random_poly_exact(seed):
    """n-point Clenshaw-Curtis is exact for degree <= n-1 on a random
    interval."""
    from corrla_rs_tpu_torch.ops.quadrature import clenshaw_curtis, integrate

    rng = np.random.default_rng(700 + seed)
    n = int(rng.integers(2, 16))
    deg = n - 1
    coeffs = rng.standard_normal(deg + 1)
    a = float(rng.uniform(-2.0, 0.0))
    b = a + float(rng.uniform(0.5, 3.0))
    rule = clenshaw_curtis(n, a, b)
    got = integrate(lambda x: _polyval(coeffs, x[0]), rule)
    k = np.arange(deg, -1, -1)
    exact = float(np.sum(coeffs * (b ** (k + 1) - a ** (k + 1)) / (k + 1)))
    assert abs(got - exact) < 1e-9 * max(1.0, abs(exact))


@pytest.mark.parametrize("seed", _seeds(3))
def test_smolyak_random_monomial_exact(seed):
    """Smolyak-CC at level L integrates random monomials of total
    degree <= 2L+1 exactly over [-1,1]^d (Novak-Ritter exactness)."""
    from corrla_rs_tpu_torch.ops.quadrature import integrate, \
        smolyak_quadrature

    rng = np.random.default_rng(750 + seed)
    d = int(rng.integers(2, 5))
    level = 2
    rule = smolyak_quadrature(d, level)
    max_total = 2 * level + 1
    for _ in range(4):
        # random exponents with total degree <= 2L+1
        e = np.zeros(d, np.int64)
        budget = max_total
        for i in rng.permutation(d):
            e[i] = rng.integers(0, budget + 1)
            budget -= e[i]
        got = integrate(
            lambda x, e=torch.as_tensor(e): torch.prod(x ** e), rule)
        exact = float(np.prod(
            [0.0 if k % 2 else 2.0 / (k + 1) for k in e]))
        assert abs(got - exact) < 1e-9, (d, e.tolist())


# ---------------------------------------------------------------------------
# test_f32_smoke.py's two lanes, in process
# ---------------------------------------------------------------------------


def _is_f32(*ts):
    return all(t.dtype == torch.float32 for t in ts)


def test_f32_end_to_end():
    """test_f32_smoke.py's main path in f32: the decaying-spectrum POD
    family (the f32 collapse fixture), the DMDc sine fixture, the RBF
    saddle solve and the rejection sampler."""
    from corrla_rs_tpu_torch import DMDc, PodI
    from corrla_rs_tpu_torch import RbfInterp as PortRbf

    out = {}
    # decaying-spectrum POD family
    nx, ns, sigma = 1000, 20, 2.0
    x = np.linspace(0, 10, nx)
    t = np.linspace(1, 9, ns)[:, None]
    p = ((0.5 * t) * np.exp(-((x[None, :] - t) ** 2) / sigma**2)).astype(
        np.float32)
    u, s, vt = random_svd(torch.as_tensor(p), 4, 10, 10, key=0)
    assert _is_f32(u, s, vt)
    s_exact = np.linalg.svd(p.astype(np.float64), compute_uv=False)[:4]
    out["pod_sigma_rel"] = float(np.max(
        np.abs(_np(s).astype(np.float64) - s_exact) / s_exact))

    pod = PodI(p, t.astype(np.float32), 4)
    pred = pod.predict(np.asarray([[5.2]], dtype=np.float32))
    assert _is_f32(pred)
    truth = (0.5 * 5.2) * np.exp(-((x - 5.2) ** 2) / sigma**2)
    out["pod_field_rel"] = float(
        np.linalg.norm(_np(pred)[:, 0] - truth) / np.linalg.norm(truth))

    # DMDc sine fixture
    xp = np.linspace(0, 10, 200)
    tp = np.linspace(0, 10, 40)
    useq = np.exp(0.2 * tp)[None, :].astype(np.float32)
    snaps = (np.sin(xp[:, None] + 0.2 * tp[None, :]) * useq).astype(
        np.float32)
    m = DMDc(snaps, useq, 12, 20)
    pm = m.predict_multiple(snaps[:, :1], useq)
    assert _is_f32(pm)
    out["dmd_err"] = float(np.abs(_np(pm)[:, 19] - snaps[:, 20]).max())

    # RBF saddle solve
    xi = np.random.default_rng(0).standard_normal((40, 2)).astype(np.float32)
    yi = (np.sin(xi[:, :1]) + np.sin(xi[:, 1:2])).astype(np.float32)
    rbf = PortRbf(2, 1.0, 2, 1).fit(xi, yi)
    got = rbf.predict(xi)
    assert _is_f32(got)
    out["rbf_support_err"] = float(np.abs(_np(got) - yi).max())

    # rejection sampler in f32
    bounds = np.array([[0.0, 0.0026], [0.1955, 0.1995], [0.80, 0.825]],
                      dtype=np.float32)
    smp = constr_dirichlet_sample(torch.as_tensor(bounds), 16, 500, 50000,
                                  1.0, key=0)
    assert _is_f32(smp)
    out["sampler_sum_err"] = float(np.abs(_np(smp).sum(1) - 1.0).max())

    assert out["pod_sigma_rel"] < 1e-4, out
    assert out["pod_field_rel"] < 0.1, out
    assert out["dmd_err"] < 5e-2, out
    assert out["rbf_support_err"] < 1e-2, out
    assert out["sampler_sum_err"] < 1e-5, out


def test_f32_wave3_end_to_end():
    """test_f32_smoke.py's wave 3 in f32: an on-bin tone through SPOD, a
    two-tone scalar through HankelDmd, OptDmd's alphas, ERA's poles,
    sketched least squares and robust PCA."""
    from corrla_rs_tpu_torch import HankelDmd, OptDmd, era, robust_pca, \
        sketched_lstsq, spod

    out = {}
    rng = np.random.default_rng(0)

    # spod: on-bin tone in f32 snapshots
    n_fft = 128
    t = np.arange(4096.0)
    s = np.linspace(0, 1, 16)
    xs = (np.outer(np.sin(np.pi * s), np.cos(2 * np.pi * (16 / n_fft) * t))
          + 0.01 * rng.standard_normal((16, 4096))).astype(np.float32)
    fit = spod(xs, n_fft=n_fft, overlap=0.5, n_modes=4)
    assert _is_f32(fit.modes_re)
    out["spod_peak"] = float(fit.peak_frequencies(1)[0])
    out["spod_finite"] = bool(np.all(np.isfinite(_np(fit.modes_re))))

    # HankelDmd: scalar two-tone in f32
    dt = 0.1
    tt = dt * np.arange(400)
    sig = (np.sin(0.5 * tt) + 0.7 * np.sin(1.3 * tt)).astype(np.float32)
    h = HankelDmd(sig, n_delays=16, n_modes=4)
    assert _is_f32(h.modes_re)
    freqs = np.sort(np.abs(np.imag(h.eigs_continuous(dt))))
    out["hankel_freq_err"] = float(np.max(np.abs(freqs
                                                 - [0.5, 0.5, 1.3, 1.3])))

    # OptDmd: f32 snapshots (host varpro itself runs f64)
    alphas = np.array([-0.05 + 1.1j, -0.05 - 1.1j])
    phi = rng.standard_normal((12, 2)) + 1j * rng.standard_normal((12, 2))
    phi[:, 1] = np.conj(phi[:, 0])
    ts = 0.1 * np.arange(120)
    xo = np.real(phi @ np.exp(np.outer(alphas, ts))).astype(np.float32)
    o = OptDmd(xo, 2, dt=0.1)
    out["optdmd_alpha_err"] = float(
        np.max(np.abs(np.sort(o.alphas.imag) - [-1.1, 1.1])))

    # era: f32 Markov stack
    a = np.array([[0.9, 0.2, 0.0], [0.0, 0.7, 0.3], [0.0, 0.0, 0.5]])
    b = np.array([[1.0], [0.5], [-0.3]])
    c = np.array([[1.0, -0.4, 0.2]])
    hs = np.empty((40, 1, 1), np.float32)
    ca = c.copy()
    for k in range(40):
        hs[k] = ca @ b
        ca = ca @ a
    e = era(hs, rank=3)
    out["era_pole_err"] = float(
        np.max(np.abs(np.sort(e.lambdas.real) - [0.5, 0.7, 0.9])))

    # sketched least squares at f32 (modest conditioning)
    m, n = 3000, 32
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    af = ((u * np.logspace(0, -3, n)) @ v.T).astype(np.float32)
    bf = rng.standard_normal(m).astype(np.float32)
    x32, _ = sketched_lstsq(af, bf, n_iters=40, key=1)
    assert _is_f32(x32)
    a64, b64 = af.astype(np.float64), bf.astype(np.float64)
    r32 = np.linalg.norm(a64 @ _np(x32).astype(np.float64) - b64)
    r_ref = np.linalg.norm(
        a64 @ np.linalg.lstsq(a64, b64, rcond=None)[0] - b64)
    out["lstsq_rel_excess"] = float(r32 / r_ref - 1.0)

    # robust PCA in f32
    lr = rng.standard_normal((60, 3)) @ rng.standard_normal((3, 40))
    msk = rng.random((60, 40)) < 0.05
    mm32 = (lr + np.where(msk, 8.0, 0.0)).astype(np.float32)
    l32, s32, info32 = robust_pca(mm32, tol=1e-5)
    assert _is_f32(l32, s32)
    out["rpca_l_rel"] = float(np.linalg.norm(_np(l32).astype(np.float64) - lr)
                              / np.linalg.norm(lr))

    assert abs(out["spod_peak"] - 16 / 128) < 1e-9, out
    assert out["spod_finite"], out
    assert out["hankel_freq_err"] < 1e-2, out
    assert out["optdmd_alpha_err"] < 1e-3, out
    assert out["era_pole_err"] < 1e-3, out
    assert out["lstsq_rel_excess"] < 1e-4, out
    assert out["rpca_l_rel"] < 1e-2, out
