"""Port parity: the sensitivity and UQ estimators (quadrature, polynomial
chaos, Sobol', Morris, Shapley, multilevel and multi-fidelity Monte Carlo)
against the JAX package.

Both packages run on the CPU in f64 on inputs made with numpy from a seed.
Each module's seam is patched with the JAX package's own draws for the
same key, its key arithmetic replayed (``jax.random.split`` and the draw
the JAX function makes), so whole estimates agree to 1e-12 of their scale
where the algebra is the same; a looser tolerance is stated with its
reason. The user callables of each package are the same function written
once for torch tensors and once for JAX arrays.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrla_rs_tpu as crt
import corrla_rs_tpu_torch as port
from _torch_parity import cpu_device, same_sketch  # noqa: F401 (fixtures)
from corrla_rs_tpu.ops import quadrature as jquad
from corrla_rs_tpu.ops import shapley as jshapley
from corrla_rs_tpu.utils.prng import as_key
from corrla_rs_tpu_torch.ops import morris as pmorris
from corrla_rs_tpu_torch.ops.mlmc import MlmcResult
from corrla_rs_tpu_torch.ops import pce as ppce
from corrla_rs_tpu_torch.ops import quadrature as pquad
from corrla_rs_tpu_torch.ops import shapley as pshapley
from corrla_rs_tpu_torch.ops import sobol as psobol
from corrla_rs_tpu_torch.utils.convert import from_jax_state

torch.set_num_threads(1)

TOL = 1e-12


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _close(got, want, tol=TOL):
    """Equal to ``tol`` of the larger magnitude of ``want``."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= tol * scale


def _t(a):
    return torch.from_numpy(np.array(a))


ISHI_BOUNDS = np.array([[-np.pi, np.pi]] * 3)


def _ishigami_t(x, a=7.0, b=0.1):
    return (torch.sin(x[:, 0]) + a * torch.sin(x[:, 1]) ** 2
            + b * x[:, 2] ** 4 * torch.sin(x[:, 0]))


def _ishigami_j(x, a=7.0, b=0.1):
    return (jnp.sin(x[:, 0]) + a * jnp.sin(x[:, 1]) ** 2
            + b * x[:, 2] ** 4 * jnp.sin(x[:, 0]))


# ---------------------------------------------------------------------------
# quadrature

@pytest.mark.parametrize("name,args", [
    ("gauss_legendre", (7, -2.0, 3.0)), ("gauss_hermite", (9,)),
    ("clenshaw_curtis", (9, 0.0, 2.0)), ("clenshaw_curtis", (1,)),
])
def test_one_dimensional_rules_match_jax(name, args):
    got = getattr(pquad, name)(*args)
    want = getattr(jquad, name)(*args)
    np.testing.assert_array_equal(got.nodes, want.nodes)
    np.testing.assert_array_equal(got.weights, want.weights)


@pytest.mark.parametrize("d,level,rule", [(3, 3, "clenshaw_curtis"),
                                          (2, 4, "gauss_legendre"),
                                          (3, 2, "gauss_hermite")])
def test_smolyak_and_tensor_rules_match_jax(d, level, rule):
    got = pquad.smolyak_quadrature(d, level, rule=rule)
    want = jquad.smolyak_quadrature(d, level, rule=rule)
    np.testing.assert_array_equal(got.nodes, want.nodes)
    np.testing.assert_array_equal(got.weights, want.weights)
    rules = [pquad.gauss_legendre(3), pquad.clenshaw_curtis(5)]
    tq = pquad.tensor_quadrature(rules)
    tj = jquad.tensor_quadrature([jquad.gauss_legendre(3),
                                  jquad.clenshaw_curtis(5)])
    np.testing.assert_array_equal(tq.nodes, tj.nodes)
    np.testing.assert_array_equal(tq.weights, tj.weights)
    with pytest.raises(ValueError, match="unknown rule"):
        pquad.smolyak_quadrature(2, 1, rule="trapezoid")


def test_integrate_traceable_callable_runs_under_vmap(cpu_device,
                                                      monkeypatch):
    rule = pquad.smolyak_quadrature(4, 4)
    got = pquad.integrate(lambda p: torch.exp(0.3 * p.sum())
                          * torch.cos(p[0]), rule)
    want = jquad.integrate(lambda p: jnp.exp(0.3 * p.sum())
                           * jnp.cos(p[0]), rule)
    assert abs(got - want) <= TOL * abs(want)
    # the vmap route: one call on the batch of every node, no loop
    calls = []

    def counted(p):
        calls.append(p.shape)
        return p.sum() ** 2

    pquad.integrate(counted, rule)
    assert len(calls) == 1


@pytest.mark.parametrize("fn", [
    lambda p: float(np.exp(np.sum(np.asarray(p)))),     # numpy on the data
    lambda p: math.exp(float(p[0]) + float(p[1])),        # Python floats
    lambda p: p[0] if p[0] > 0 else -p[0] + p[1],         # data-dependent if
])
def test_integrate_falls_back_for_untraceable_callables(cpu_device, fn):
    # the JAX package's per-node loop, for exactly the callables vmap
    # cannot trace; both packages give the same sum
    rule = pquad.smolyak_quadrature(2, 3)
    got = pquad.integrate(fn, rule)
    want = jquad.integrate(fn, rule)
    assert abs(got - want) <= TOL * max(abs(want), 1.0)


def test_integrate_other_errors_propagate(cpu_device):
    rule = pquad.gauss_legendre(4)

    def broken(p):
        raise RuntimeError("CUDA error: an illegal memory access")

    with pytest.raises(RuntimeError, match="illegal memory"):
        pquad.integrate(broken, rule)
    assert pquad._untraceable(TypeError("x"))
    assert not pquad._untraceable(RuntimeError("CUDA out of memory"))


# ---------------------------------------------------------------------------
# polynomial chaos

def _pce_pair(order, dist, **kw):
    return (ppce.PolynomialChaos(order, dist=dist, **kw),
            crt.PolynomialChaos(order, dist=dist, **kw))


def _agree(p, j, xq, tol=1e-10):
    _close(p.coeffs, j.coeffs, tol)
    _close(p.predict(xq), j.predict(jnp.asarray(xq)), tol)
    assert abs(p.mean - j.mean) <= tol * max(abs(j.mean), 1.0)
    assert abs(p.var - j.var) <= tol * max(abs(j.var), 1.0)
    sp, sj = p.sobol_indices(), j.sobol_indices()
    _close(sp["s1"], sj["s1"], tol)
    _close(sp["st"], sj["st"], tol)
    assert abs(p.r2 - j.r2) <= 1e-9


@pytest.mark.parametrize("dist", ["uniform", "gaussian", "data"])
def test_pce_regression_fit_matches_jax(cpu_device, dist):
    rng = np.random.default_rng(20)
    if dist == "uniform":
        x = rng.uniform(-np.pi, np.pi, (600, 3))
        kw = dict(bounds=ISHI_BOUNDS)
    else:
        x = rng.standard_normal((600, 3)) * [1.0, 0.5, 2.0] + [0.2, 0, -1]
        kw = {}
    if dist == "data":
        x = np.exp(0.4 * x)
    y = _np(_ishigami_t(_t(x)))
    p, j = _pce_pair(5, dist, **kw)
    p.fit(x, y)
    j.fit(x, y)
    # the lstsq: LAPACK's QR route here, JAX's SVD there, on a basis
    # of condition ~1e2: 1e-10 of the coefficients' scale
    _agree(p, j, x[:50])
    if dist != "uniform":
        np.testing.assert_allclose(p._mean, j._mean, rtol=1e-14)
        np.testing.assert_allclose(p._std, j._std, rtol=1e-14)


@pytest.mark.parametrize("dist", ["uniform", "gaussian"])
def test_pce_fit_quadrature_matches_jax(cpu_device, dist):
    if dist == "uniform":
        kw = dict(bounds=ISHI_BOUNDS)
        ft, fj = (lambda v: _ishigami_t(v[None])[0],
                  lambda v: _ishigami_j(v[None])[0])
    else:
        kw = dict(mean=np.array([0.5, -0.2]), std=np.array([1.0, 0.3]))
        ft = lambda v: torch.exp(0.3 * v[0]) * v[1] ** 2    # noqa: E731
        fj = lambda v: jnp.exp(0.3 * v[0]) * v[1] ** 2      # noqa: E731
    p, j = _pce_pair(6, dist, **kw)
    p.fit_quadrature(ft, level=5)
    j.fit_quadrature(fj, level=5)
    xq = np.random.default_rng(21).uniform(-1, 1, (20, len(kw.get(
        "bounds", kw.get("mean")))))
    _agree(p, j, xq)


def test_pce_fit_sparse_matches_jax(cpu_device):
    # the greedy selection is host numpy in both packages: on equal bases
    # it picks the same support
    rng = np.random.default_rng(22)
    d = 8
    x = rng.uniform(-1, 1, (120, d))
    y = (1.0 + 2.0 * x[:, 0] + 0.5 * x[:, 1] * x[:, 2]
         - 0.8 * (1.5 * x[:, 3] ** 2 - 0.5) + 0.01 * rng.standard_normal(120))
    bounds = np.array([[-1.0, 1.0]] * d)
    p, j = _pce_pair(1, "uniform", bounds=bounds)
    p.fit_sparse(x, y, max_order=3)
    j.fit_sparse(x, y, max_order=3)
    np.testing.assert_array_equal(p._alpha, j._alpha)
    assert abs(p.loo_error - j.loo_error) <= 1e-10 * j.loo_error
    _agree(p, j, x[:10])
    np.testing.assert_array_equal(ppce.total_degree_multi_indices(4, 3),
                                  __import__(
                                      "corrla_rs_tpu.ops.pce",
                                      fromlist=["x"]
                                  ).total_degree_multi_indices(4, 3))


def test_pce_from_jax_state_predicts_what_jax_predicts(cpu_device):
    rng = np.random.default_rng(23)
    x = np.exp(0.3 * rng.standard_normal((400, 3)))
    y = _np(_ishigami_t(_t(x)))
    for dist, kw in (("uniform", dict(bounds=[[0, 4]] * 3)),
                     ("gaussian", {}), ("data", {})):
        j = crt.PolynomialChaos(4, dist=dist, **kw).fit(x, y)
        p = from_jax_state("PolynomialChaos", dict(vars(j)), device="cpu")
        assert isinstance(p, port.PolynomialChaos)
        assert isinstance(p.coeffs, torch.Tensor)
        _close(p.predict(x[:30]), j.predict(jnp.asarray(x[:30])), 1e-12)
        _close(p.sobol_indices()["st"], j.sobol_indices()["st"], 1e-12)


def test_pce_validation(cpu_device):
    with pytest.raises(ValueError, match="bounds"):
        ppce.PolynomialChaos(2)
    with pytest.raises(ValueError, match="samples cannot determine"):
        ppce.PolynomialChaos(4, bounds=ISHI_BOUNDS).fit(
            np.zeros((5, 3)), np.zeros(5))
    with pytest.raises(ValueError, match="closed-form"):
        ppce.PolynomialChaos(2, dist="data").fit_quadrature(lambda v: v[0])


# ---------------------------------------------------------------------------
# Sobol'

def _jax_uniform(key, n, d, device):
    k1, k2 = jax.random.split(as_key(key))
    return (_t(jax.random.uniform(k1, (n, d))).to(device),
            _t(jax.random.uniform(k2, (n, d))).to(device))


def _jax_boot(key, n_boot, n, device):
    keys = jax.random.split(as_key(key), int(n_boot))
    idx = jax.vmap(lambda k: jax.random.randint(k, (n,), 0, n))(keys)
    return _t(np.asarray(idx, np.int64)).to(device)


@pytest.fixture
def jax_sobol_draws(cpu_device, monkeypatch):
    monkeypatch.setattr(psobol, "_draw_uniform", _jax_uniform)
    monkeypatch.setattr(psobol, "_draw_boot_indices", _jax_boot)


@pytest.mark.parametrize("plan", ["uniform", "sobol"])
def test_sobol_indices_match_jax(jax_sobol_draws, plan):
    kw = dict(key=3, plan=plan, n_boot=40, boot_key=5)
    got = port.sobol_indices(_ishigami_t, ISHI_BOUNDS, 512, **kw)
    want = crt.sobol_indices(_ishigami_j, ISHI_BOUNDS, 512, **kw)
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name])
    a, b, ab = port.saltelli_plan(ISHI_BOUNDS, 16, key=1, plan=plan)
    for g, w in zip((a, b, ab), crt.saltelli_plan(ISHI_BOUNDS, 16, key=1,
                                                  plan=plan)):
        _close(g, w)


def test_sobol_bootstrap_blocks_equal_one_batch(jax_sobol_draws,
                                                monkeypatch):
    kw = dict(key=2, n_boot=30)
    whole = port.sobol_indices(_ishigami_t, ISHI_BOUNDS, 256, **kw)
    monkeypatch.setattr(psobol, "_BOOT_BLOCK_ELEMS", 7 * 256)
    blocked = port.sobol_indices(_ishigami_t, ISHI_BOUNDS, 256, **kw)
    for name in whole:
        _close(blocked[name], whole[name], 1e-14)
    with pytest.raises(ValueError, match="vectorized"):
        port.sobol_indices(lambda x: x[:5, 0], ISHI_BOUNDS, 16)
    with pytest.raises(ValueError, match="plan"):
        port.saltelli_plan(ISHI_BOUNDS, 16, plan="halton")


# ---------------------------------------------------------------------------
# Morris

def _jax_morris(key, n_traj, d, p, device):
    k_start, k_perm, k_sign = jax.random.split(as_key(key), 3)
    levels = jax.random.randint(k_start, (n_traj, d), 0, p // 2)
    signs = jnp.where(jax.random.bernoulli(k_sign, 0.5, (n_traj, d)),
                      1.0, -1.0)
    order = jax.vmap(lambda k: jax.random.permutation(k, d))(
        jax.random.split(k_perm, n_traj))
    return (_t(np.asarray(levels, np.int64)).to(device),
            _t(np.asarray(order, np.int64)).to(device),
            _t(np.asarray(signs, np.float64)).to(device))


@pytest.mark.parametrize("n_levels", [4, 6])
def test_morris_matches_jax(cpu_device, monkeypatch, n_levels):
    monkeypatch.setattr(pmorris, "_draw_morris", _jax_morris)
    bounds = np.array([[-np.pi, np.pi], [0.0, 2.0], [-1.0, 3.0]])
    pts, signs, order = port.morris_trajectories(bounds, 9, key=4,
                                                 n_levels=n_levels)
    jp, js, jo = crt.morris_trajectories(bounds, 9, key=4,
                                         n_levels=n_levels)
    _close(pts, jp)
    _close(signs, js)
    np.testing.assert_array_equal(_np(order), np.asarray(jo))
    got = port.morris_screening(_ishigami_t, bounds, 32, key=6,
                                n_levels=n_levels)
    want = crt.morris_screening(_ishigami_j, bounds, 32, key=6,
                                n_levels=n_levels)
    for name in want:
        _close(got[name], want[name])
    with pytest.raises(ValueError, match="even"):
        port.morris_trajectories(bounds, 4, n_levels=3)
    with pytest.raises(ValueError, match="n_traj"):
        port.morris_screening(_ishigami_t, bounds, 1)


# ---------------------------------------------------------------------------
# Shapley

def _jax_shapley(key, n_outer, n_inner, d, device):
    k_outer, k_inner = jax.random.split(as_key(key))
    return (_t(jax.random.normal(k_outer, (n_outer, d))).to(device),
            _t(jax.random.normal(k_inner, (n_outer, n_inner, d))).to(device))


def _corr_cov(d, rho=0.5):
    idx = np.arange(d)
    return rho ** np.abs(idx[:, None] - idx[None, :]) * np.outer(
        np.linspace(1.0, 2.0, d), np.linspace(1.0, 2.0, d))


def test_shapley_effects_match_jax(cpu_device, monkeypatch):
    monkeypatch.setattr(pshapley, "_draw_shapley", _jax_shapley)
    d = 4
    beta = np.array([1.0, -0.5, 2.0, 0.3])
    mean, cov = np.linspace(-1, 1, d), _corr_cov(d)

    def model_t(x):
        return x @ torch.from_numpy(beta) + 0.2 * x[:, 0] * x[:, 1]

    def model_j(x):
        return x @ jnp.asarray(beta) + 0.2 * x[:, 0] * x[:, 1]

    got = port.shapley_effects(model_t, mean, cov, n_outer=64, n_inner=16,
                               key=3)
    want = crt.shapley_effects(model_j, mean, cov, n_outer=64, n_inner=16,
                               key=3)
    # the same numbers through another order of operations (the
    # conditional draws on the device, JAX's in host numpy), differenced
    # down to variances: 1e-10 of the largest effect
    _close(got, want, 1e-10)
    _close(port.shapley_effects_linear(beta, cov),
           crt.shapley_effects_linear(beta, cov), 1e-14)
    with pytest.raises(ValueError, match="too large"):
        port.shapley_effects(model_t, np.zeros(16), np.eye(16))


@pytest.mark.parametrize("rules", [False, True])
def test_shapley_quadrature_matches_jax(cpu_device, rules):
    def model_t(x):
        return torch.exp(0.3 * x[:, 0]) * (1 + x[:, 1]) + x[:, 2] ** 2

    def model_j(x):
        return jnp.exp(0.3 * x[:, 0]) * (1 + x[:, 1]) + x[:, 2] ** 2

    if rules:
        gl = [np.polynomial.legendre.leggauss(6)] * 3
        kw = dict(rules=[(0.5 * (n + 1), w) for n, w in gl])
    else:
        kw = dict(mean=np.array([0.1, -0.2, 0.0]),
                  std=np.array([1.0, 0.5, 0.8]), n_quad=8)
    got = pshapley.shapley_effects_quadrature(model_t, **kw)
    want = jshapley.shapley_effects_quadrature(model_j, **kw)
    for name in ("shapley", "s1", "st"):
        _close(got[name], want[name], 1e-12)
    for name in ("var", "mean"):
        assert abs(got[name] - want[name]) <= 1e-12 * abs(want[name])


# ---------------------------------------------------------------------------
# MLMC and MFMC: sample_inputs gets a generator (here: the JAX key the
# replayed split hands out) where the JAX package passes a key

def _normal_t(key, n):
    return _t(jax.random.normal(key, (n, 1), jnp.float64))


def _normal_j(key, n):
    return jax.random.normal(key, (n, 1), jnp.float64)


def _level_t(lvl):
    return lambda x: x[:, 0] ** 2 + 0.5 ** lvl * torch.sin(7.0 * x[:, 0])


def _level_j(lvl):
    return lambda x: x[:, 0] ** 2 + 0.5 ** lvl * jnp.sin(7.0 * x[:, 0])


@pytest.mark.parametrize("kw", [dict(target_se=0.02), dict(n_max=4000),
                                dict(target_se=0.02, bucket_sizes=False)])
def test_mlmc_matches_jax(same_sketch, kw):
    costs = np.array([1.0, 2.0, 4.0, 8.0])
    got = port.mlmc_estimate([_level_t(l) for l in range(4)], _normal_t,
                             costs, key=7, **kw)
    want = crt.mlmc_estimate([_level_j(l) for l in range(4)], _normal_j,
                             costs, key=7, **kw)
    np.testing.assert_array_equal(got.n_per_level, want.n_per_level)
    assert abs(got.mean - want.mean) <= TOL * abs(want.mean)
    assert abs(got.std_error - want.std_error) <= 1e-10 * want.std_error
    _close(got.level_means, want.level_means)
    _close(got.level_vars, want.level_vars, 1e-10)
    assert got.total_cost == want.total_cost
    assert isinstance(got, MlmcResult)


F_T = (lambda x: x[:, 0] ** 2, lambda x: x[:, 0] ** 2 + 0.5 * x[:, 0],
       lambda x: 0.8 * x[:, 0] ** 2 + x[:, 0])
F_J = F_T     # the same arithmetic on either package's arrays
SIG = np.sqrt([2.0, 2.25, 2.28])
RHO = np.array([1.0, 2.0 / np.sqrt(2 * 2.25), 1.6 / np.sqrt(2 * 2.28)])
COSTS = np.array([1.0, 0.05, 0.001])


def test_mfmc_matches_jax(same_sketch):
    d_p = port.mfmc_design(SIG, RHO, COSTS, budget=400.0)
    d_j = crt.mfmc_design(SIG, RHO, COSTS, budget=400.0)
    for name in d_j._fields:
        np.testing.assert_array_equal(getattr(d_p, name), getattr(d_j, name))
    got = port.mfmc_estimate(F_T, _normal_t, COSTS, 400.0, n_pilot=60, key=5)
    want = crt.mfmc_estimate(F_J, _normal_j, COSTS, 400.0, n_pilot=60, key=5)
    assert abs(got.mean - want.mean) <= TOL * abs(want.mean)
    np.testing.assert_array_equal(got.n_evals, want.n_evals)
    _close(got.design.rhos, want.design.rhos)
    _close(got.design.alpha, want.design.alpha)
    fixed = port.mfmc_estimate(F_T, _normal_t, COSTS, 400.0, key=5,
                               design=d_p)
    assert abs(fixed.mean - crt.mfmc_estimate(
        F_J, _normal_j, COSTS, 400.0, key=5, design=d_j).mean) <= TOL
    with pytest.raises(ValueError, match="ordered"):
        port.mfmc_design(SIG, RHO[[0, 2, 1]], COSTS, 100.0)


def test_control_variate_estimate_matches_jax(cpu_device):
    rng = np.random.default_rng(30)
    x = rng.standard_normal(500)
    y_hi, y_lo = x ** 2 + 0.1 * x, x ** 2
    got = port.control_variate_estimate(y_hi, y_lo, 1.0)
    want = crt.control_variate_estimate(y_hi, y_lo, 1.0)
    assert abs(got[0] - want[0]) <= TOL * abs(want[0])
    assert abs(got[1] - want[1]) <= 1e-10 * abs(want[1])
    with pytest.raises(ValueError, match="paired"):
        port.control_variate_estimate(y_hi, y_lo[:-1], 1.0)
