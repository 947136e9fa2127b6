"""Port parity: the pair-copula families, Kendall's tau, the Gaussian and
bivariate copulas, and the C- and R-vines against the JAX package.

Both packages run on the CPU in f64 on samples made with numpy from a
seed. Uniform draws go through ``ops.vine._draw_uniform`` and normal ones
through ``ops.random_svd._draw_sketch``; the tests fill both with the JAX
package's draws for the same key. Family functions agree to 1e-12 of their
scale (the t families through the port's own incomplete beta, 4e-14 off
JAX's), fitted parameters from tau inversion to 1e-10, and the
golden-section refinements to 1e-7 (its last comparisons are between
log-likelihoods that differ by rounding, so the two packages may take the
other half of a bracket 4e-9 wide). The batched family scorer equals the
per-family scores to 1e-12. JAX-saved checkpoints of the four copula
classes load into the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrla_rs_tpu as crt
import corrla_rs_tpu_torch as port
from _torch_parity import cpu_device, same_sketch  # noqa: F401 (fixtures)
from corrla_rs_tpu.ops import vine as jv
from corrla_rs_tpu.utils import checkpoint as jck
from corrla_rs_tpu.utils.prng import as_key
from corrla_rs_tpu_torch.ops import rvine as prv
from corrla_rs_tpu_torch.ops import vine as pv
from corrla_rs_tpu_torch.utils import checkpoint as pck
from corrla_rs_tpu_torch.utils.convert import from_jax_state

torch.set_num_threads(1)

N = 500          # samples of every fit here: one shape, one JAX compile


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, rtol=1e-12):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, err


def _jax_uniform(key, shape, dtype, device, low=pv._EPS, high=1.0 - pv._EPS):
    draw = jax.random.uniform(as_key(key), shape, minval=low, maxval=high)
    return torch.as_tensor(np.asarray(draw), device=device)


@pytest.fixture
def jax_draws(same_sketch, monkeypatch):
    monkeypatch.setattr(pv, "_draw_uniform", _jax_uniform)


def _theta(fam, tau=0.5):
    _base, rot = jv._split_rotation(fam)
    return jv._theta_from_tau(fam, -tau if rot in (90, 270) else tau)


def _planted_pair(fam, n=N, seed=0, tau=0.5):
    """(n, 2) uniforms of a pair copula of family ``fam`` at Kendall's tau
    ``tau`` (negated for the 90/270 rotations)."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(1e-6, 1 - 1e-6, (n, 2))
    th = _theta(fam, tau)
    u = pv._HINV[fam](torch.as_tensor(w[:, 1]), torch.as_tensor(w[:, 0]), th)
    return np.stack([_np(u), w[:, 0]], axis=1)


def _planted_vine(n=N, seed=1):
    """4-D data: a Gaussian block, a clayton pair on its first variable,
    monotone marginal transforms (which leave the copula as it is)."""
    rng = np.random.default_rng(seed)
    c = np.array([[1.0, 0.6, 0.3], [0.6, 1.0, 0.4], [0.3, 0.4, 1.0]])
    z = rng.standard_normal((n, 3)) @ np.linalg.cholesky(c).T
    u0 = _np(pv._norm_cdf(torch.as_tensor(z[:, 0])))
    w = rng.uniform(1e-6, 1 - 1e-6, n)
    u3 = _np(pv._HINV["clayton"](torch.as_tensor(w), torch.as_tensor(u0),
                                 2.0))
    return np.stack([np.exp(z[:, 0]), z[:, 1] ** 3, z[:, 2], u3], axis=1)


# ---------------------------------------------------------------- families


FAMS = [f for f in jv.FAMILIES if f != "independent"]
# the family set of the vine tests that check structure, not the t grid:
# a t quantile costs ~1 s of small operations on the CPU a pair
NO_T = tuple(f for f in jv.FAMILIES if f not in jv._T_NU)


# t5 and t8 meet the same code as t3 and t15 (and the scorer's test below)
@pytest.mark.parametrize("fam", [f for f in FAMS if f not in ("t5", "t8")])
def test_family_functions_match_jax(cpu_device, rng, fam):
    u, v = rng.uniform(0.001, 0.999, (2, 300))
    th = _theta(fam, 0.45)
    for name in ("_LOGPDF", "_H", "_HINV"):
        want = getattr(jv, name)[fam](jnp.asarray(u), jnp.asarray(v), th)
        got = getattr(pv, name)[fam](torch.as_tensor(u), torch.as_tensor(v),
                                     th)
        _close(got, want, 1e-12)


def test_t_cdf_ppf_match_jax_and_scipy(cpu_device):
    from scipy import stats

    u = np.linspace(0.001, 0.999, 57)
    x_far = np.linspace(-40.0, 40.0, 81)
    for nu in (3.0, 16.0):      # 16: the nu + 1 of t15's h-function
        x = _np(pv._t_ppf(torch.as_tensor(u), nu))
        np.testing.assert_allclose(x, stats.t.ppf(u, nu), rtol=1e-8,
                                   atol=1e-10)
        _close(x, jv._t_ppf(jnp.asarray(u), nu), 1e-12)
        assert np.abs(_np(pv._t_cdf(torch.as_tensor(x), nu)) - u).max() \
            <= 1e-12
        _close(pv._t_cdf(torch.as_tensor(x_far), nu),
               jv._t_cdf(jnp.asarray(x_far), nu), 1e-13)


def test_t_ppf_gradient_is_implicit_derivative(cpu_device):
    # the autograd Function's backward is 1/pdf(ppf(u)), as the JAX
    # package's custom JVP: against central differences and JAX's grad
    u = torch.tensor([0.1, 0.37, 0.5, 0.92], dtype=torch.float64,
                     requires_grad=True)
    x = pv._t_ppf(u, 5.0)
    (g,) = torch.autograd.grad(x.sum(), u)
    eps = 1e-6
    with torch.no_grad():
        fd = (pv._t_ppf(u + eps, 5.0) - pv._t_ppf(u - eps, 5.0)) / (2 * eps)
        pdf = torch.exp(pv._t_logpdf_uni(x, 5.0))
    assert float((g - fd).abs().max()) < 1e-4 * max(float(fd.abs().max()), 1)
    assert float((g - 1.0 / pdf).abs().max()) <= 1e-12 * float(g.max())
    jgrad = jax.vmap(jax.grad(lambda s: jv._t_ppf(s, 5.0)))(
        jnp.asarray(_np(u)))
    _close(g, jgrad, 1e-12)


def test_frank_tau_inversion_matches_jax():
    for tau in (-0.7, -0.2, 0.05, 0.4, 0.8):
        want = float(jv._frank_theta_from_tau(jnp.asarray(tau)))
        assert abs(pv._frank_theta_from_tau(tau) - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("tau", [0.5, -0.45])
def test_batched_scorer_equals_each_family(cpu_device, tau):
    # the t grid as one quantile computation, the rotations as one, each
    # equal to the family's own log-density sum
    uv = _planted_pair("gaussian" if tau > 0 else "clayton90", tau=tau)
    u, v = torch.as_tensor(uv[:, 0]), torch.as_tensor(uv[:, 1])
    fams = [f for f in FAMS if pv._family_admissible(f, tau)]
    thetas = [_theta(f, 0.4) for f in fams]
    got = pv._PairScorer(u, v, fams).loglik(
        torch.tensor(thetas, dtype=torch.float64))
    want = [float(pv._LOGPDF[f](u, v, th).sum()) for f, th in
            zip(fams, thetas)]
    _close(got, want, 1e-12)


# ---------------------------------------------------------------- tau


def test_kendall_tau_routes_agree(cpu_device, monkeypatch):
    rng = np.random.default_rng(3)
    n = 3000
    x = rng.standard_normal(n)
    y = 0.6 * x + rng.standard_normal(n)
    dev = pv.kendall_tau(x, y, method="device")
    host = pv.kendall_tau(x, y, method="host")
    assert isinstance(dev, torch.Tensor) and isinstance(host, float)
    assert abs(float(dev) - host) <= 1e-12
    assert abs(float(dev) - float(jv.kendall_tau(x, y, method="device"))) \
        <= 1e-12
    # auto: the device up to _TAU_DEVICE_MAX_N points (8,192), the host
    # beyond; the device sum in row blocks equals the one-block sum
    assert pv._TAU_DEVICE_MAX_N == 8192
    monkeypatch.setattr(pv, "_TAU_DEVICE_MAX_N", n)
    assert isinstance(pv.kendall_tau(x, y), torch.Tensor)
    assert isinstance(pv.kendall_tau(np.append(x, 9.0), np.append(y, 9.0)),
                      float)
    ranks = np.argsort(np.argsort(x)), np.argsort(np.argsort(y))
    on_ints = pv.kendall_tau(*ranks, method="device")
    assert on_ints.dtype == torch.float64 and float(on_ints) == float(dev)
    monkeypatch.setattr(pv, "_TAU_BLOCK_ELEMS", n * 7)
    assert float(pv.kendall_tau(x, y, method="device")) == float(dev)
    assert abs(float(pv.kendall_tau(x[:50], y[:50])) - float(
        jv.kendall_tau(x[:50], y[:50]))) <= 1e-15


# ---------------------------------------------------------------- pair fits


@pytest.mark.parametrize("fam", ["gaussian", "frank", "clayton90",
                                 "gumbel180", "t3"])
@pytest.mark.parametrize("refine", [False, True])
def test_fit_pair_matches_jax(cpu_device, fam, refine):
    uv = _planted_pair(fam, tau=0.55, seed=7)
    jfam, jth, jtau = jv._fit_pair(jnp.asarray(uv[:, 0]),
                                   jnp.asarray(uv[:, 1]), refine=refine)
    pfam, pth, ptau = pv._fit_pair(torch.as_tensor(uv[:, 0]),
                                   torch.as_tensor(uv[:, 1]), refine=refine)
    assert pfam == jfam and abs(ptau - jtau) <= 1e-12
    assert abs(pth - jth) <= (1e-7 if refine else 1e-10) * abs(jth)


def test_fit_pair_declares_noise_independent(cpu_device, rng):
    u, v = rng.uniform(0, 1, (2, N))
    fam, th, _tau = pv._fit_pair(torch.as_tensor(u), torch.as_tensor(v))
    assert (fam, th) == jv._fit_pair(jnp.asarray(u), jnp.asarray(v))[:2]
    with pytest.raises(ValueError, match="at least 2"):
        pv._fit_pair(torch.zeros(1, dtype=torch.float64),
                     torch.zeros(1, dtype=torch.float64))


# ---------------------------------------------------------------- copulas


def test_gaussian_copula_matches_jax(jax_draws):
    x = _planted_vine()
    jg, pg = crt.GaussianCopula().fit(x), port.GaussianCopula().fit(x)
    _close(pg.corr, jg.corr, 1e-12)
    _close(pg._marginals, jg._marginals, 0.0)
    _close(pg.sample(400, key=3), jg.sample(400, key=3), 1e-12)


@pytest.mark.parametrize("family,refine", [("auto", False), ("auto", True),
                                           ("clayton", True),
                                           ("gumbel270", False)])
def test_bivariate_copula_matches_jax(jax_draws, family, refine):
    fam = "gumbel270" if family == "gumbel270" else "clayton"
    uv = _planted_pair(fam, tau=0.5, seed=11)
    x = np.stack([np.log(uv[:, 0] / (1 - uv[:, 0])), uv[:, 1] ** 2], axis=1)
    jb = crt.BivariateCopula(family, refine=refine).fit(x)
    pb = port.BivariateCopula(family, refine=refine).fit(x)
    assert pb.fitted_family == jb.fitted_family == fam
    assert abs(pb.theta - jb.theta) <= (1e-7 if refine else 1e-10) \
        * abs(jb.theta)
    grid = np.linspace(0.05, 0.95, 19)
    _close(pb.logpdf_uniform(grid, grid[::-1]),
           jb.logpdf_uniform(grid, grid[::-1]), 1e-6 if refine else 1e-12)
    _close(pb.sample(300, key=4), jb.sample(300, key=4),
           1e-6 if refine else 1e-12)


def test_bivariate_copula_validates(cpu_device):
    with pytest.raises(ValueError, match="family"):
        port.BivariateCopula("nope")
    uv = _planted_pair("clayton", tau=0.5)
    with pytest.raises(ValueError, match="cannot represent"):
        port.BivariateCopula("clayton90").fit(uv)
    with pytest.raises(ValueError, match=r"\(n, 2\)"):
        port.BivariateCopula().fit(np.zeros((10, 3)))


# ---------------------------------------------------------------- vines


@pytest.mark.parametrize("refine", [False, True])
def test_cvine_matches_jax(jax_draws, refine):
    # refined over every family; by tau inversion over all but the t grid
    fams = jv.FAMILIES if refine else NO_T
    x = _planted_vine()
    jc = crt.CVineCopula(fams, refine=refine).fit(x)
    pc = port.CVineCopula(fams, refine=refine).fit(x)
    assert pc.var_order == [int(i) for i in jc.var_order]
    tol = 1e-7 if refine else 1e-10
    for prow, jrow in zip(pc.pairs, jc.pairs):
        for (pf, pt), (jf, jt) in zip(prow, jrow):
            assert pf == jf and abs(pt - jt) <= tol * max(abs(jt), 1.0)
    _close(pc.sample_uniform(300, key=5), jc.sample_uniform(300, key=5),
           1e-5 if refine else 1e-12)
    _close(pc.sample(300, key=5), jc.sample(300, key=5),
           1e-5 if refine else 1e-12)


def test_rvine_matches_jax(jax_draws):
    x = _planted_vine(seed=2)
    jr = crt.RVineCopula(NO_T).fit(x)
    pr = port.RVineCopula(NO_T).fit(x)
    for plvl, jlvl in zip(pr.trees, jr.trees):
        for (a, b, c, f, t), (ja, jb_, jc_, jf, jt) in zip(plvl, jlvl):
            assert (a, b, c, f) == (ja, jb_, jc_, jf)
            assert abs(t - jt) <= 1e-10 * max(abs(jt), 1.0)
    u = np.random.default_rng(5).uniform(0.01, 0.99, (200, 4))
    _close(pr.logpdf_uniform(u), jr.logpdf_uniform(jnp.asarray(u)), 1e-11)
    assert abs(pr.aic(u) - jr.aic(jnp.asarray(u))) <= 1e-9 * abs(jr.aic(u))
    _close(pr.sample(300, key=6), jr.sample(300, key=6), 1e-11)
    assert prv._swap("clayton90") == "clayton270"
    trunc = port.RVineCopula(NO_T, truncate_level=1).fit(x)
    assert all(e[3] == "independent" for lvl in trunc.trees[1:] for e in lvl)
    with pytest.raises(ValueError, match="at least 2"):
        port.RVineCopula().fit(np.zeros((10, 1)))


def test_copula_checkpoints_from_jax(jax_draws, tmp_path):
    x = _planted_vine(seed=3)
    uv = _planted_pair("gumbel", tau=0.5, seed=12)
    fits = [crt.GaussianCopula().fit(x), crt.BivariateCopula().fit(uv),
            crt.CVineCopula(NO_T).fit(x), crt.RVineCopula(NO_T).fit(x)]
    for i, jfit in enumerate(fits):
        path = str(tmp_path / f"c{i}.npz")
        jck.save_model(path, jfit)
        name = type(jfit).__name__
        loaded = pck.load_model(path, device="cpu")
        crossed = from_jax_state(name, vars(jfit), device="cpu")
        for pfit in (loaded, crossed):
            assert type(pfit).__name__ == name
            _close(pfit.sample(200, key=8), jfit.sample(200, key=8), 1e-12)
        if name == "RVineCopula":
            u = np.random.default_rng(6).uniform(0.02, 0.98, (50, 4))
            _close(loaded.logpdf_uniform(u), jfit.logpdf_uniform(u), 1e-11)
        pck.save_model(path, loaded)
        again = pck.load_model(path, device="cpu")
        _close(again.sample(50, key=9), loaded.sample(50, key=9), 0.0)
