"""Port parity: ops.optimize and ops.univariate_rv against the JAX package.

The two packages minimize by different iterates (the port's BFGS has a
backtracking line search, JAX's a Wolfe one), so fits are held to the JAX
minimum, not to its path. Draws differ too: the particle swarm's uniforms and
``build_kde``'s permutations are injected through their seams, and samplers
are held to their distribution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps
import scipy.stats as spst
import torch

from _torch_parity import cpu_device  # noqa: F401 (fixture)
from corrla_rs_tpu.ops import optimize as jax_opt
from corrla_rs_tpu.ops import univariate_rv as jax_rv
from corrla_rs_tpu.utils.prng import as_key
from corrla_rs_tpu_torch.ops import optimize as port_opt
from corrla_rs_tpu_torch.ops import univariate_rv as port_rv

torch.set_num_threads(1)

# a fit against the JAX minimum, f64: both stop at max |grad| <= 1e-5 of a
# cost whose curvature is >= n_samples / scale**2, so each is within 1e-8
# of the minimum; 1e-6 stated
FIT_ATOL = 1e-6


def test_betainc_matches_scipy():
    # a, b below 1 and up to the fits' bound of 200; x at and near 0 and 1
    a = np.array([0.05, 0.3, 0.5, 1.0, 2.0, 5.0, 20.0, 100.0, 200.0])
    b = np.array([0.05, 0.4, 1.0, 3.0, 17.0, 150.0, 200.0])
    x = np.concatenate([[0.0, 1e-300, 1e-12, 1e-6, 1e-3],
                        np.linspace(0.01, 0.99, 37),
                        [1 - 1e-3, 1 - 1e-6, 1 - 1e-12, 1.0]])
    aa, bb, xx = np.meshgrid(a, b, x, indexing="ij")
    got = port_rv.betainc(torch.tensor(aa), torch.tensor(bb),
                          torch.tensor(xx)).numpy()
    np.testing.assert_allclose(got, sps.betainc(aa, bb, xx), atol=1e-10,
                               rtol=0)
    # scalars broadcast against a tensor, as BetaRv.cdf calls it
    got = port_rv.betainc(2.0, 5.0, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, sps.betainc(2.0, 5.0, x), atol=1e-10)


def test_betainc_matches_jax():
    x = np.linspace(0.0, 1.0, 101)
    for a, b in ((0.5, 0.5), (2.0, 5.0), (30.0, 4.0)):
        want = np.asarray(jax.scipy.special.betainc(a, b, jnp.asarray(x)))
        got = port_rv.betainc(a, b, torch.tensor(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-10)


def test_penalized_cost_matches_jax(cpu_device, rng):
    bounds = [[-1.0, 0.5], [2.0, 3.0]]
    cj = jax_opt.penalized_cost(lambda p: jnp.sum(p ** 2), bounds)
    ct = port_opt.penalized_cost(lambda p: torch.sum(p ** 2), bounds)
    for p in rng.uniform(-4, 6, (8, 2)):
        np.testing.assert_allclose(float(ct(torch.tensor(p))),
                                   float(cj(jnp.asarray(p))), rtol=1e-14)


def _bowl(p):
    """A smooth skewed bowl with its minimum inside the box; the same
    expression serves jnp and torch. (On Rosenbrock's valley JAX's BFGS
    stops at (-0.28, 0.04) while the port's reaches (1, 1): a test of the
    same minimum needs a cost both minimize.)"""
    return ((p[0] - 1.0) ** 2 + 10.0 * (p[1] + 0.5) ** 2
            + 0.5 * (p[0] * p[1]) ** 2 + 0.1 * p[0] ** 4)


@pytest.mark.parametrize("method,atol", [(2, FIT_ATOL), (0, 1e-9)],
                         ids=["bfgs", "steepest"])
def test_mlefit_matches_jax(cpu_device, method, atol):
    # BFGS: the same minimum. Steepest descent: the same fixed 40 x 20
    # loop, so the same iterates to rounding
    bounds = [[-5.0, -5.0], [5.0, 5.0]]
    pj = jax_opt.mlefit(_bowl, [-1.2, 1.0], bounds, method=method)
    pt = port_opt.mlefit(_bowl, [-1.2, 1.0], bounds, method=method)
    assert pt.dtype == torch.float64
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=atol)
    if method == 2:
        grad = torch.func.grad(_bowl)(pt)
        assert float(grad.abs().max()) <= 1e-5


def _jax_swarm_draws(key, n_particles, d, n_iters):
    """The uniforms of the JAX particle_swarm, by its own key splits."""
    k_init, _k_vel, k_loop = jax.random.split(as_key(key), 3)
    x0 = jax.random.uniform(k_init, (n_particles, d), jnp.float64)
    r1, r2 = [], []
    for _ in range(n_iters):
        k_loop, k1, k2 = jax.random.split(k_loop, 3)
        r1.append(jax.random.uniform(k1, (n_particles, d), jnp.float64))
        r2.append(jax.random.uniform(k2, (n_particles, d), jnp.float64))
    to_t = lambda v: torch.from_numpy(np.array(v))
    return to_t(x0), to_t(jnp.stack(r1)), to_t(jnp.stack(r2))


@pytest.mark.parametrize("polish,atol", [(False, 1e-9), (True, FIT_ATOL)])
def test_particle_swarm_matches_jax_from_the_same_draws(cpu_device,
                                                        monkeypatch, polish,
                                                        atol):
    # the swarm alone is the same arithmetic on the same uniforms; the
    # polish ends in the same minimum
    bounds = [[-3.0, -3.0], [3.0, 3.0]]
    monkeypatch.setattr(
        port_opt, "_draw_swarm",
        lambda key, n, d, iters, dtype, device: _jax_swarm_draws(key, n, d,
                                                                 iters))
    pj = jax_opt.particle_swarm(_bowl, bounds, 5, n_particles=12,
                                n_iters=30, polish=polish)
    pt = port_opt.particle_swarm(_bowl, bounds, 5, n_particles=12,
                                 n_iters=30, polish=polish)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=atol)


def test_fallback_retries_numeric_failures_only(cpu_device):
    bounds = [[-2.0], [2.0]]

    def inf_at_start(p):   # infinite around the start, a bowl elsewhere
        return torch.where(p[0].abs() < 0.1, torch.full_like(p[0], np.inf),
                           (p[0] - 1.0) ** 2)

    # BFGS stands still at the start (no finite trial point), its cost is
    # not finite, so the swarm takes over and finds the bowl
    assert not torch.isfinite(inf_at_start(port_opt.mlefit(
        inf_at_start, [0.0], bounds, method=2)))
    p = port_opt.mlefit_ps_fallback(inf_at_start, [0.0], bounds, method=2,
                                    key=3)
    assert abs(float(p[0]) - 1.0) < 1e-4

    def arithmetic(p):
        raise ArithmeticError("overflow")

    with pytest.raises(ArithmeticError):
        # raised again by the swarm: the fallback ran, and it does not hide
        # a cost that always fails
        port_opt.mlefit_ps_fallback(arithmetic, [0.0], bounds)

    def typo(p):
        raise TypeError("not numeric")

    with pytest.raises(TypeError):
        port_opt.mlefit_ps_fallback(typo, [0.0], bounds)
    with pytest.raises(ValueError, match="valid method"):
        port_opt.mlefit_ps_fallback(lambda p: p[0], [0.0], bounds, method=7)
    with pytest.raises(ValueError, match="valid method"):
        port_opt.mlefit(lambda p: p[0], [0.0], bounds, method=7)


X = np.linspace(-7.0, 9.0, 41)


def test_pdf_cdf_nll_match_jax(cpu_device):
    # elementwise special functions: 1e-12 relative
    pairs = [
        (jax_rv.NormalRv(2.0, 3.0), port_rv.NormalRv(2.0, 3.0), X),
        (jax_rv.BetaRv(2.5, 4.0, 1.0, 3.0), port_rv.BetaRv(2.5, 4.0, 1.0, 3.0),
         np.linspace(1.01, 2.99, 41)),
        (jax_rv.ExponentialRv(2.0), port_rv.ExponentialRv(2.0),
         np.linspace(0.0, 5.0, 41)),
        (jax_rv.KdeRv(0.4, jnp.asarray(X[::4])),
         port_rv.KdeRv(0.4, torch.tensor(X[::4])), X),
    ]
    for rj, rt, x in pairs:
        for fn in ("pdf", "cdf"):
            np.testing.assert_allclose(
                getattr(rt, fn)(torch.tensor(x)).numpy(),
                np.asarray(getattr(rj, fn)(jnp.asarray(x))), rtol=1e-12,
                atol=1e-300, err_msg=f"{type(rt).__name__}.{fn}")
        np.testing.assert_allclose(float(rt.nll(torch.tensor(x))),
                                   float(rj.nll(jnp.asarray(x))), rtol=1e-12)
    # the params override, and a scalar KDE query
    np.testing.assert_allclose(
        port_rv.NormalRv(0.0, 1.0).pdf(torch.tensor(X),
                                       torch.tensor([2.0, -3.0],
                                                    dtype=torch.float64)
                                       ).numpy(),
        np.asarray(jax_rv.NormalRv(2.0, 3.0).pdf(jnp.asarray(X))), rtol=1e-12)
    assert pairs[3][1].pdf(0.5).ndim == 0


@pytest.mark.parametrize("method", [2, 0, 1])
def test_normal_mlfit_matches_jax(cpu_device, rng, method):
    s = rng.normal(2.0, 3.0, 4000)
    rj = jax_rv.NormalRv(0.0, 1.0).mlfit(jnp.asarray(s), method=method, key=1)
    rt = port_rv.NormalRv(0.0, 1.0).mlfit(torch.tensor(s), method=method,
                                          key=1)
    assert isinstance(rt.mu, float) and isinstance(rt.std, float)
    if method == 0:
        # 40 steepest-descent steps do not converge (the JAX test allows
        # 0.2); the same loop gives the same point
        assert abs(rt.mu - rj.mu) < 1e-6 and abs(rt.std - rj.std) < 1e-6
    else:
        # the MLE is the sample mean and the biased std; both packages
        # reach it (the swarm through its polish)
        assert abs(rt.mu - s.mean()) < FIT_ATOL
        assert abs(rt.std - s.std()) < FIT_ATOL
        assert abs(rt.mu - rj.mu) < FIT_ATOL and abs(rt.std - rj.std) < FIT_ATOL


def test_beta_and_exponential_mlfit_match_jax(cpu_device, rng):
    s = rng.beta(2.0, 5.0, 4000) * 2.0 + 1.0
    rj = jax_rv.BetaRv(1.0, 1.0, 1.0, 3.0).mlfit(jnp.asarray(s), method=2)
    rt = port_rv.BetaRv(1.0, 1.0, 1.0, 3.0).mlfit(torch.tensor(s), method=2)
    assert abs(rt.alpha - rj.alpha) < FIT_ATOL
    assert abs(rt.beta - rj.beta) < FIT_ATOL
    # the closed-form moment fit is the same arithmetic
    rj = jax_rv.BetaRv(1.0, 1.0, 1.0, 3.0).mlfit(jnp.asarray(s))
    rt = port_rv.BetaRv(1.0, 1.0, 1.0, 3.0).mlfit(torch.tensor(s))
    np.testing.assert_allclose([rt.alpha, rt.beta], [rj.alpha, rj.beta],
                               rtol=1e-10)
    e = rng.exponential(0.5, 4000)
    rj = jax_rv.ExponentialRv(1.0).mlfit(jnp.asarray(e))
    rt = port_rv.ExponentialRv(1.0).mlfit(torch.tensor(e))
    assert abs(rt.lam - rj.lam) < FIT_ATOL
    assert abs(rt.lam - 1.0 / e.mean()) < FIT_ATOL


def _jax_permutations(key, n, n_iter, device):
    key = as_key(key)
    out = []
    for _ in range(n_iter):
        key, k_perm, k_fit = jax.random.split(key, 3)
        out.append((torch.from_numpy(np.array(
            jax.random.permutation(k_perm, n))), k_fit))
    return out


def test_build_kde_matches_jax_from_the_same_splits(cpu_device, rng,
                                                    monkeypatch):
    monkeypatch.setattr(port_rv, "_draw_permutations", _jax_permutations)
    s = np.concatenate([rng.normal(0.0, 1.0, 120), rng.normal(5.0, 0.5, 60)])
    kj = jax_rv.build_kde(0.5, jnp.asarray(s), n_iter=3, key=2)
    kt = port_rv.build_kde(0.5, torch.tensor(s), n_iter=3, key=2)
    # each bandwidth is a 1-d minimum on 54 held-out points, flatter than a
    # fit's: 1e-5
    assert abs(kt.bandwidth - kj.bandwidth) < 1e-5
    assert kt.supports.shape == (180,)


@pytest.mark.parametrize("make,dist", [
    (lambda: port_rv.NormalRv(2.0, 3.0), spst.norm(2.0, 3.0)),
    (lambda: port_rv.BetaRv(2.0, 5.0, 1.0, 3.0), spst.beta(2.0, 5.0, 1.0, 2.0)),
    (lambda: port_rv.ExponentialRv(2.0), spst.expon(scale=0.5)),
], ids=["normal", "beta", "exponential"])
def test_samples_follow_their_distribution(cpu_device, make, dist):
    s = make().sample(20000, key=4)
    assert s.shape == (20000,) and s.dtype == torch.float64
    # Kolmogorov-Smirnov at 20,000 draws: the 0.1% critical value is 0.0138
    assert spst.kstest(s.numpy(), dist.cdf).statistic < 0.0138
    assert torch.equal(s, make().sample(20000, key=4))
    assert not torch.equal(s, make().sample(20000, key=5))


def test_kde_samples_and_own_splits(cpu_device, rng):
    sup = rng.normal(1.0, 2.0, 300)
    kde = port_rv.build_kde(1.0, torch.tensor(sup), n_iter=3, key=0)
    assert 0.1 < kde.bandwidth < 3.0
    s = kde.sample(20000, key=1)
    assert abs(float(s.mean()) - sup.mean()) < 0.1
    assert abs(float(s.std()) - np.hypot(sup.std(), kde.bandwidth)) < 0.1
    grid = torch.linspace(-12.0, 14.0, 2001, dtype=torch.float64)
    assert abs(float(torch.trapezoid(kde.pdf(grid), grid)) - 1.0) < 1e-3
