"""Port parity: the routed distances with their gradient, Gaussian processes,
the space-filling designs and Bayesian optimisation against the JAX package.

Both run on the CPU in f64 on inputs made with numpy. The port's BFGS
reaches a minimum by other iterates than ``jax.scipy.optimize.minimize``
(ROADMAP, Differences by design), so fits are compared on the objective
both minimise and posteriors at equal hyperparameters. The draws (the
posterior normals, the inducing set, the LHS permutations and uniforms, the
Sobol seed and the key splits) go to both packages from JAX through the
port's seams.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from _torch_parity import (cpu_device, jax_sketch, jax_split,  # noqa: F401
                           same_sketch)
from corrla_rs_tpu.ops import bayes_opt as jbo
from corrla_rs_tpu.ops import design as jdesign
from corrla_rs_tpu.ops import gp as jgp
from corrla_rs_tpu.ops import interp as jinterp
from corrla_rs_tpu.utils.prng import as_key
from corrla_rs_tpu_torch.ops import bayes_opt as pbo
from corrla_rs_tpu_torch.ops import design as pdesign
from corrla_rs_tpu_torch.ops import gp as pgp
from corrla_rs_tpu_torch.ops import interp as pinterp
from corrla_rs_tpu_torch.ops import rbf_kernels

torch.set_num_threads(1)

KERNELS = ["rbf", "matern52", "matern32"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _data(seed, n=23, d=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d))
    y = np.sin(3 * x[:, 0]) + 0.5 * x[:, -1] + 0.1 * rng.standard_normal(n)
    xq = rng.uniform(-1, 1, (40, d))
    return x, y, xq


# ---------------------------------------------------------------------------
# the routed distances and their gradient

def _jax_dists_grad(xa, xb, w):
    f = lambda a, b: jnp.sum(jinterp.pairwise_dists(a, b) * w)
    return jax.grad(f, argnums=(0, 1))(jnp.asarray(xa), jnp.asarray(xb))


@pytest.mark.parametrize("na,nb,d", [(7, 5, 1), (13, 9, 3), (4, 30, 8)])
def test_pairwise_dists_value_and_gradient_match_jax(na, nb, d):
    rng = np.random.default_rng(na + nb + d)
    xa, xb = rng.standard_normal((na, d)), rng.standard_normal((nb, d))
    w = rng.standard_normal((na, nb))
    want = np.asarray(jinterp.pairwise_dists(jnp.asarray(xa),
                                             jnp.asarray(xb)))
    ta = _t(xa).requires_grad_(True)
    tb = _t(xb).requires_grad_(True)
    got = pinterp.pairwise_dists(ta, tb)
    np.testing.assert_allclose(_np(got), want, rtol=1e-12, atol=1e-12)
    ga, gb = torch.autograd.grad(torch.sum(got * _t(w)), (ta, tb))
    ja, jb = _jax_dists_grad(xa, xb, jnp.asarray(w))
    np.testing.assert_allclose(_np(ga), np.asarray(ja), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(_np(gb), np.asarray(jb), rtol=1e-12,
                               atol=1e-12)
    # torch.func takes the Function too, and batches it
    fa = torch.func.grad(lambda a: torch.sum(pinterp.pairwise_dists(
        a, _t(xb)) * _t(w)))(_t(xa))
    np.testing.assert_allclose(_np(fa), np.asarray(ja), rtol=1e-12,
                               atol=1e-12)
    batch = torch.func.vmap(pinterp.pairwise_dists, in_dims=(0, None))(
        torch.stack([_t(xa), 2.0 * _t(xa)]), _t(xb))
    np.testing.assert_allclose(_np(batch[1]), np.asarray(
        jinterp.pairwise_dists(2.0 * jnp.asarray(xa), jnp.asarray(xb))),
        rtol=1e-12, atol=1e-12)


def test_pairwise_dists_gradient_at_zero_distance_is_zero_not_nan():
    # JAX's sqrt'(0) * 0 gives NaN where a query meets a point; the port
    # gives 0 there (the subgradient at a distance's minimum) and JAX's
    # value everywhere else (ROADMAP, Differences by design)
    rng = np.random.default_rng(1)
    xb = rng.standard_normal((6, 3))
    xa = np.concatenate([xb[2:3], rng.standard_normal((4, 3))])
    w = rng.standard_normal((5, 6))
    ja, jb = _jax_dists_grad(xa, xb, jnp.asarray(w))
    ja, jb = np.asarray(ja), np.asarray(jb)
    assert np.isnan(ja[0]).all() and np.isnan(jb[2]).all()
    ta = _t(xa).requires_grad_(True)
    tb = _t(xb).requires_grad_(True)
    ga, gb = torch.autograd.grad(
        torch.sum(pinterp.pairwise_dists(ta, tb) * _t(w)), (ta, tb))
    ga, gb = _np(ga), _np(gb)
    # the pair at R = 0 contributes nothing; the rest is JAX's gradient,
    # taken without that pair: rows 1.. against every column, and row 0
    # against the columns but 2
    rest_a, rest_b = _jax_dists_grad(xa[1:], xb, jnp.asarray(w[1:]))
    cols = [0, 1, 3, 4, 5]
    row_a, row_b = _jax_dists_grad(xa[:1], xb[cols],
                                   jnp.asarray(w[:1, cols]))
    want_b = np.array(rest_b)
    want_b[cols] += np.asarray(row_b)
    np.testing.assert_allclose(ga[0], np.asarray(row_a)[0], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(ga[1:], np.asarray(rest_a), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(gb, want_b, rtol=1e-12, atol=1e-12)
    # x against itself: the diagonal is R = 0, the gradient finite
    x = _t(xb).requires_grad_(True)
    (g,) = torch.autograd.grad(pinterp.pairwise_dists(x, x).sum(), x)
    assert bool(torch.isfinite(g).all())
    assert torch.autograd.gradcheck(pinterp.pairwise_dists,
                                    (_t(xa[1:]).requires_grad_(True),
                                     _t(xb).requires_grad_(True)))


def test_pairwise_dists_runs_the_plain_version_on_the_cpu(monkeypatch):
    calls = []
    real = rbf_kernels.pairwise_dists
    monkeypatch.setattr(rbf_kernels, "pairwise_dists",
                        lambda a, b: calls.append(1) or real(a, b))
    before = rbf_kernels.pairwise_kernel_matrix.launches
    pinterp.pairwise_dists(torch.zeros(3, 2, dtype=torch.float64),
                           torch.ones(4, 2, dtype=torch.float64))
    assert calls == [1]
    assert rbf_kernels.pairwise_kernel_matrix.launches == before


# ---------------------------------------------------------------------------
# GpRegressor

def _gp_pair(kernel, x, y, hypers, pad_to=None):
    j = jgp.GpRegressor(kernel, *hypers).fit(
        jnp.asarray(x), jnp.asarray(y), optimize_hypers=False, pad_to=pad_to)
    p = pgp.GpRegressor(kernel, *hypers, device="cpu").fit(
        x, y, optimize_hypers=False, pad_to=pad_to)
    return j, p


@pytest.mark.parametrize("pad_to", [None, 32])
@pytest.mark.parametrize("kernel", KERNELS)
def test_gp_posterior_at_equal_hyperparameters_matches_jax(kernel, pad_to):
    x, y, xq = _data(3)
    j, p = _gp_pair(kernel, x, y, (0.6, 0.7, 1e-3), pad_to)
    jm, jv = j.predict(jnp.asarray(xq))
    pm, pv = p.predict(xq)
    np.testing.assert_allclose(_np(pm), np.asarray(jm), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(_np(pv), np.asarray(jv), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(_np(p.predict_cov(xq)),
                               np.asarray(j.predict_cov(jnp.asarray(xq))),
                               rtol=1e-10, atol=1e-10)
    assert p.log_marginal_likelihood() == pytest.approx(
        j.log_marginal_likelihood(), rel=1e-10, abs=1e-10)


@pytest.mark.parametrize("block_rows", [1, 7, 40])
def test_gp_predict_in_query_blocks_matches_jax(monkeypatch, block_rows):
    # predict walks the queries in blocks of _QUERY_BLOCK_ELEMS // n rows;
    # a block of one row, ragged blocks and one block give JAX's posterior
    x, y, xq = _data(5)
    j, p = _gp_pair("matern32", x, y, (0.6, 0.7, 1e-3), 32)
    monkeypatch.setattr(pgp, "_QUERY_BLOCK_ELEMS", block_rows * 32)
    jm, jv = j.predict(jnp.asarray(xq))
    pm, pv = p.predict(xq)
    assert pm.shape == pv.shape == (xq.shape[0],)
    np.testing.assert_allclose(_np(pm), np.asarray(jm), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(_np(pv), np.asarray(jv), rtol=1e-10,
                               atol=1e-10)
    assert torch.equal(p.predict(xq, return_var=False), pm)


@pytest.mark.parametrize("kernel", KERNELS)
def test_gp_nlml_at_equal_parameters_matches_jax(kernel):
    x, y, _ = _data(4)
    yc = y - y.mean()
    r = pinterp.pairwise_dists(_t(x), _t(x))
    mask = np.r_[np.ones(20), np.zeros(3)]
    for lp in ([0.1, -0.3, -5.0], [-0.5, 0.4, -2.0]):
        for m in (None, mask):
            want = float(jgp._nlml(jnp.asarray(lp), jnp.asarray(x),
                                   jnp.asarray(yc), kernel,
                                   None if m is None else jnp.asarray(m)))
            got = float(pgp._nlml(_t(np.asarray(lp)), r, _t(yc), kernel,
                                  None if m is None else _t(m)))
            assert got == pytest.approx(want, rel=1e-10, abs=1e-12)


@pytest.mark.parametrize("kernel", KERNELS)
def test_gp_fit_reaches_the_nlml_minimum_jax_reaches(kernel):
    # both packages' fits land on the NLML's minimum: the port's value is
    # no worse than JAX's, and its gradient is below the BFGS tolerance
    x, y, _ = _data(11)
    j = jgp.GpRegressor(kernel).fit(jnp.asarray(x), jnp.asarray(y))
    p = pgp.GpRegressor(kernel, device="cpu").fit(x, y)
    assert p.log_marginal_likelihood() >= \
        j.log_marginal_likelihood() - 1e-8
    r = pinterp.pairwise_dists(p.x_train, p.x_train)
    g = torch.func.grad(lambda lp: pgp._nlml(lp, r, p._yc, kernel))(
        p._log_params())
    assert float(g.abs().max()) <= 1e-5


def test_padded_fit_equals_unpadded():
    x, y, xq = _data(11)
    g1 = pgp.GpRegressor(device="cpu").fit(x, y)
    g2 = pgp.GpRegressor(device="cpu").fit(x, y, pad_to=32)
    m1, v1 = g1.predict(xq)
    m2, v2 = g2.predict(xq)
    np.testing.assert_allclose(_np(m2), _np(m1), atol=1e-8)
    np.testing.assert_allclose(_np(v2), _np(v1), atol=1e-8)
    assert g2.log_marginal_likelihood() == pytest.approx(
        g1.log_marginal_likelihood(), abs=1e-7)
    with pytest.raises(ValueError, match="pad_to"):
        pgp.GpRegressor(device="cpu").fit(x, y, pad_to=10)


def test_sample_posterior_with_the_jax_draws(same_sketch):
    # a noise level that keeps the posterior covariance's Cholesky well
    # conditioned: its factor amplifies the rounding of the covariance
    x = np.linspace(0, 6, 25)[:, None]
    y = np.sin(x[:, 0])
    xq = np.linspace(0.1, 5.9, 20)[:, None]
    j = jgp.GpRegressor(noise_var=1e-2).fit(jnp.asarray(x), jnp.asarray(y),
                                             optimize_hypers=False)
    p = pgp.GpRegressor(noise_var=1e-2).fit(x, y, optimize_hypers=False)
    want = np.asarray(j.sample_posterior(jnp.asarray(xq), 50, key=5))
    got = _np(p.sample_posterior(xq, 50, key=5))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_gp_jitter_floors_by_dtype():
    assert pgp._jitter(torch.float32) == 1e-4
    assert pgp._jitter(torch.float64) == 1e-6
    # a near noise-free f32 fit factors with the 1e-4 floor
    x, y, xq = _data(5, n=60)
    p = pgp.GpRegressor(noise_var=1e-12, device="cpu").fit(
        x.astype(np.float32), y.astype(np.float32), optimize_hypers=False)
    m, v = p.predict(xq.astype(np.float32))
    assert m.dtype == torch.float32
    assert bool(torch.isfinite(m).all() and torch.isfinite(v).all())


# ---------------------------------------------------------------------------
# SparseGpRegressor

def test_sparse_gp_at_equal_hyperparameters_matches_jax():
    x, y, xq = _data(7, n=60)
    y = 3.0 * y + 2.0
    ind = x[::6]
    j = jgp.SparseGpRegressor(inducing=jnp.asarray(ind), length_scale=0.5,
                              signal_var=2.0, noise_var=0.05).fit(
        jnp.asarray(x), jnp.asarray(y), optimize_hypers=False)
    p = pgp.SparseGpRegressor(inducing=ind, length_scale=0.5, signal_var=2.0,
                              noise_var=0.05, device="cpu").fit(
        x, y, optimize_hypers=False)
    assert p.elbo() == pytest.approx(j.elbo(), rel=1e-10)
    jm, jv = j.predict(jnp.asarray(xq))
    pm, pv = p.predict(xq)
    np.testing.assert_allclose(_np(pm), np.asarray(jm), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(_np(pv), np.asarray(jv), rtol=1e-10,
                               atol=1e-10)


def test_sparse_gp_fit_with_the_jax_inducing_draw(monkeypatch):
    # the inducing set from JAX's choice; both fits reach the ELBO's
    # maximum (the port's no lower than JAX's)
    def jax_choice(key, n, m, device):
        idx = jax.random.choice(as_key(key), n, (m,), replace=False)
        return torch.from_numpy(np.asarray(idx)).to(device)

    monkeypatch.setattr(pgp, "_draw_inducing", jax_choice)
    x, y, xq = _data(8, n=80)
    j = jgp.SparseGpRegressor(inducing=12, key=3).fit(jnp.asarray(x),
                                                      jnp.asarray(y))
    p = pgp.SparseGpRegressor(inducing=12, key=3, device="cpu").fit(x, y)
    np.testing.assert_array_equal(_np(p.x_ind), np.asarray(j.x_ind))
    assert p.elbo() >= j.elbo() - 1e-8
    # at JAX's hyperparameters, the port's posterior is JAX's
    q = pgp.SparseGpRegressor(inducing=np.asarray(j.x_ind),
                              length_scale=j.length_scale,
                              signal_var=j.signal_var,
                              noise_var=j.noise_var, device="cpu").fit(
        x, y, optimize_hypers=False)
    np.testing.assert_allclose(_np(q.predict(xq, return_var=False)),
                               np.asarray(j.predict(jnp.asarray(xq),
                                                    return_var=False)),
                               rtol=1e-8, atol=1e-8)


# ---------------------------------------------------------------------------
# designs

@pytest.mark.parametrize("seed", [0, 1, 7, 123456, 2**40 + 3])
def test_seed_from_an_int_key_is_jax_s(seed):
    assert pdesign._seed_from_key(seed) == jdesign._seed_from_key(seed)


@pytest.mark.parametrize("kind", ["sobol_sample", "halton_sample"])
def test_qmc_designs_match_jax(cpu_device, kind):
    bounds = [[-1.0, 2.0], [0.0, 5.0], [3.0, 3.5]]
    for key in (0, 4):
        want = np.asarray(getattr(jdesign, kind)(bounds, 64, key=key))
        got = _np(getattr(pdesign, kind)(bounds, 64, key=key))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _jax_lhs_draw(key, n_candidates, n, d, device):
    """JAX's permutations and uniforms of latin_hypercube's designs."""
    def one(k):
        kp, ku = jax.random.split(k)
        perms = jax.vmap(lambda kk: jax.random.permutation(kk, n))(
            jax.random.split(kp, d))
        return perms, jax.random.uniform(ku, (d, n))

    key = as_key(key)
    keys = [key] if n_candidates <= 1 else list(
        jax.random.split(key, int(n_candidates)))
    perms, u = zip(*(one(k) for k in keys))
    return (torch.from_numpy(np.stack(perms).astype(np.int64)),
            torch.from_numpy(np.stack(u)))


@pytest.mark.parametrize("n_candidates", [1, 5])
def test_latin_hypercube_with_the_jax_draws(cpu_device, monkeypatch,
                                            n_candidates):
    monkeypatch.setattr(pdesign, "_draw_lhs", _jax_lhs_draw)
    bounds = [[-5.0, 10.0], [0.0, 15.0], [0.0, 1.0]]
    want = np.asarray(jdesign.latin_hypercube(bounds, 12, key=3,
                                              n_candidates=n_candidates))
    got = _np(pdesign.latin_hypercube(bounds, 12, key=3,
                                      n_candidates=n_candidates))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_latin_hypercube_hits_every_stratum(cpu_device):
    pts = _np(pdesign.latin_hypercube([[0, 1]] * 3, 20, key=9,
                                      n_candidates=4))
    for col in pts.T:
        assert sorted(np.floor(col * 20).astype(int)) == list(range(20))


# ---------------------------------------------------------------------------
# acquisitions and the optimiser

def test_acquisitions_match_jax_and_closed_forms():
    rng = np.random.default_rng(5)
    mean = rng.standard_normal(50)
    var = rng.uniform(1e-20, 2.0, 50)
    for name, args in (("expected_improvement", (0.2, 0.03)),
                       ("probability_of_improvement", (0.2, 0.01)),
                       ("lower_confidence_bound", (1.5,))):
        want = np.asarray(getattr(jbo, name)(jnp.asarray(mean),
                                             jnp.asarray(var), *args))
        got = _np(getattr(pbo, name)(_t(mean), _t(var), *args))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    sd, z = 0.5, (0.5 - 0.3) / 0.5
    ei = float(pbo.expected_improvement(_t(0.3), _t(0.25), 0.5, 0.0))
    assert ei == pytest.approx((0.5 - 0.3) * stats.norm.cdf(z)
                               + sd * stats.norm.pdf(z), rel=1e-10)


def _frozen_hypers(monkeypatch):
    """Both packages' GP fits keep their initial hyperparameters, so the
    two asks run on one GP."""
    monkeypatch.setattr(jgp, "_jsp_minimize",
                        lambda fun, x0, method: types.SimpleNamespace(x=x0))
    monkeypatch.setattr(pgp, "_minimize", lambda cost, init: init)


def _jax_seed(key):
    return jdesign._seed_from_key(key)


@pytest.mark.parametrize("acquisition", ["ei", "lcb", "pi", "variance"])
def test_ask_with_the_jax_draws_matches_jax(same_sketch, monkeypatch,
                                            acquisition):
    _frozen_hypers(monkeypatch)
    monkeypatch.setattr(pdesign, "_seed_from_key", _jax_seed)
    rng = np.random.default_rng(6)
    x0 = rng.uniform([-5, 0], [10, 15], (9, 2))
    y0 = np.sin(x0[:, 0]) + 0.1 * x0[:, 1] ** 2
    kw = dict(acquisition=acquisition, n_candidates=256, n_grad_steps=5,
              key=4)
    jb = jbo.BayesOpt([[-5.0, 10.0], [0.0, 15.0]], **kw).tell(x0, y0)
    pb = pbo.BayesOpt([[-5.0, 10.0], [0.0, 15.0]], **kw).tell(x0, y0)
    for n_points in (1, 3):
        want = np.asarray(jb.ask(n_points))
        got = _np(pb.ask(n_points))
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_bayes_opt_minimize_with_the_jax_draws_matches_jax(
        same_sketch, monkeypatch):
    _frozen_hypers(monkeypatch)
    monkeypatch.setattr(pdesign, "_seed_from_key", _jax_seed)
    monkeypatch.setattr(pdesign, "_draw_lhs", _jax_lhs_draw)
    f = lambda v: float((v[0] - 0.3) ** 2 + 2.0 * (v[1] + 0.4) ** 2) - 1.0
    kw = dict(n_init=6, n_iters=3, key=2, n_candidates=128, n_grad_steps=4)
    want = jbo.bayes_opt_minimize(f, [[-1, 1], [-1, 1]], **kw)
    got = pbo.bayes_opt_minimize(f, [[-1, 1], [-1, 1]], **kw)
    np.testing.assert_allclose(_np(got.x_hist), np.asarray(want.x_hist),
                               rtol=1e-9, atol=1e-9)
    assert got.n_evals == want.n_evals == 9
    assert got.y_best == pytest.approx(want.y_best, rel=1e-9)


def test_ask_tell_interface_and_validation(cpu_device):
    bo = pbo.BayesOpt([[0, 1]], acquisition="lcb", key=3)
    with pytest.raises(ValueError, match="observations"):
        bo.ask()
    bo.tell(np.array([[0.1], [0.9]]), [1.0, 2.0])
    x = bo.ask()
    assert x.shape == (1,) and 0.0 <= float(x[0]) <= 1.0
    xs = bo.ask(n_points=3)
    assert xs.shape == (3, 1)
    assert len({round(float(v), 6) for v in xs[:, 0]}) == 3
    with pytest.raises(ValueError, match="bounds"):
        pbo.BayesOpt([[0, 1, 2]])
    with pytest.raises(ValueError, match="acquisition"):
        pbo.BayesOpt([[0, 1]], acquisition="nope")
    with pytest.raises(ValueError, match="matching"):
        bo.tell(np.zeros((2, 1)), [1.0])


def test_minimize_quadratic_finds_the_minimum(cpu_device):
    f = lambda v: float((v[0] - 0.3) ** 2 + 2.0 * (v[1] + 0.4) ** 2) - 1.0
    res = pbo.bayes_opt_minimize(f, [[-1, 1], [-1, 1]], n_init=8,
                                 n_iters=10, key=0, n_candidates=512)
    assert res.n_evals == 18 and res.y_best < -0.95


class _BiasedGrad(torch.autograd.Function):
    """sum(p^2) whose gradient is reported as that of sum((p - 0.5)^2):
    between 0 and 0.5 the search direction climbs, and the line search
    ends on steps whose cost rounds to the current one."""

    @staticmethod
    def forward(p):
        return torch.sum(p * p)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        return g * 2.0 * (p - 0.5)


def test_bfgs_stops_when_no_step_lowers_the_cost():
    # a step shrunk until its cost rounds to the current one is no
    # decrease: accepting it repeated the same search up to max_iters
    # (an f32 GP fit spent 12,112 evaluations so, 104 with the stop)
    from corrla_rs_tpu_torch.ops import optimize

    calls = []

    def cost(p):
        calls.append(1)
        return _BiasedGrad.apply(p)

    p, f = optimize._bfgs(cost, torch.full((2,), 0.2,
                                           dtype=torch.float64))
    assert len(calls) <= 62, len(calls)
    assert torch.equal(p, torch.full((2,), 0.2, dtype=torch.float64))
    assert float(f) == pytest.approx(0.08, rel=1e-15)
