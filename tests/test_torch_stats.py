"""Port parity: Gaussian mixtures, CMA-ES, CCA and PLS against the JAX
package.

Both packages run on the CPU in f64 on inputs made with numpy from a seed.
The port's draw seams are filled with the JAX package's own draws, its key
arithmetic replayed: ``gmm._draw_kmeanspp`` (the first centre's
``randint`` and each round's ``categorical`` as Gumbel noise from
``split(key, k)``), ``gmm._draw_sample`` (``split_key(key, 2)``: Gumbel
noise for the components, normals for the offsets) and
``cma._draw_normals`` (one ``normal`` a generation from ``split(key,
n_gens)``). Where the algebra is the same the results agree to 1e-10 of
their scale; looser limits are stated beside the comparison with their
reason. JAX-saved checkpoints of ``Cca`` and ``PlsRegressor`` load into the
port, and a JAX ``GmmFit`` crosses through ``from_jax_state``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrla_rs_tpu as crt
import corrla_rs_tpu_torch as port
from _torch_parity import cpu_device  # noqa: F401 (fixture)
from corrla_rs_tpu.utils import checkpoint as jck
from corrla_rs_tpu.utils.prng import as_key, split_key
from corrla_rs_tpu_torch.ops import cma as pcma
from corrla_rs_tpu_torch.ops import gmm as pgmm
from corrla_rs_tpu_torch.utils import checkpoint as pck
from corrla_rs_tpu_torch.utils.convert import from_jax_state

torch.set_num_threads(1)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, rtol=1e-10):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, \
        np.abs(got - want).max() / scale


def _jax_kmeanspp(key, n, k, dtype, device):
    keys = jax.random.split(as_key(key), k)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    first = int(jax.random.randint(keys[0], (), 0, n))
    rows = [np.zeros(n)] + [np.asarray(jax.random.gumbel(keys[j], (n,), jdt))
                            for j in range(1, k)]
    return first, torch.as_tensor(np.stack(rows), dtype=dtype, device=device)


def _jax_sample_draws(key, n, k, d, dtype, device):
    k_comp, k_norm = split_key(key, 2)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    gumbel = np.asarray(jax.random.gumbel(k_comp, (n, k), jdt))
    z = np.asarray(jax.random.normal(k_norm, (n, d), jdt))
    return (torch.as_tensor(gumbel, device=device),
            torch.as_tensor(z, device=device))


def _jax_normals(key, n_gens, pop, d, dtype, device):
    keys = jax.random.split(as_key(key), n_gens)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return torch.as_tensor(np.stack([np.asarray(jax.random.normal(
        keys[g], (pop, d), jdt)) for g in range(n_gens)]), device=device)


def _jax_eigh(a):
    w, v = jnp.linalg.eigh(np.asarray(a))
    return torch.as_tensor(np.asarray(w)), torch.as_tensor(np.asarray(v))


@pytest.fixture
def jax_draws(cpu_device, monkeypatch):
    monkeypatch.setattr(pgmm, "_draw_kmeanspp", _jax_kmeanspp)
    monkeypatch.setattr(pgmm, "_draw_sample", _jax_sample_draws)
    monkeypatch.setattr(pcma, "_draw_normals", _jax_normals)


@pytest.fixture
def jax_eigh(jax_draws, monkeypatch):
    # a candidate is z diag(sqrt(lambda)) V^T: its value depends on the
    # signs of C's eigenvectors, which LAPACK's drivers in torch and in
    # XLA choose apart, so whole runs are compared with JAX's eigh
    monkeypatch.setattr(torch.linalg, "eigh", _jax_eigh)


def _blobs(n_per=150, seed=0, d=2):
    rng = np.random.default_rng(seed)
    mus = np.array([[0.0, 0.0], [6.0, 1.0], [-1.0, 7.0]])
    if d > 2:
        mus = np.hstack([mus, rng.standard_normal((3, d - 2)) * 4])
    xs = [rng.multivariate_normal(mu, np.diag(rng.uniform(0.4, 1.2, d)),
                                  size=n_per) for mu in mus]
    x = np.concatenate(xs)
    return x[rng.permutation(len(x))]


# ---------------------------------------------------------------- GMM


@pytest.mark.parametrize("cov_type", ["full", "diag"])
@pytest.mark.parametrize("n_iter", [200, 5])
def test_gmm_fit_matches_jax(jax_draws, cov_type, n_iter):
    # n_iter 200: frozen early, and the port's early stop returns what
    # JAX's full scan returns; n_iter 5: cut before the freeze
    x = _blobs(d=3)
    want = crt.gmm_fit(x, 3, key=1, n_iter=n_iter, cov_type=cov_type)
    got = port.gmm_fit(x, 3, key=1, n_iter=n_iter, cov_type=cov_type)
    assert int(got.n_iter) == int(want.n_iter)
    if n_iter == 200:
        assert int(want.n_iter) < 50
    for field in ("weights", "means", "covs", "responsibilities"):
        _close(getattr(got, field), getattr(want, field))
    _close(got.log_likelihood, want.log_likelihood, 1e-12)
    assert got.cov_type == cov_type and got.n_components == 3
    assert abs(got.bic() - want.bic()) <= 1e-10 * abs(want.bic())
    assert abs(got.aic() - want.aic()) <= 1e-10 * abs(want.aic())


def test_gmm_early_stop_reads_the_flag_every_few_steps(jax_draws,
                                                       monkeypatch):
    # how often the flag is read changes nothing
    x = _blobs(seed=2)
    ref = port.gmm_fit(x, 3, key=0)
    monkeypatch.setattr(pgmm, "_FROZEN_EVERY", 1)
    every = port.gmm_fit(x, 3, key=0)
    monkeypatch.setattr(pgmm, "_FROZEN_EVERY", 10_000)
    never = port.gmm_fit(x, 3, key=0)
    for other in (every, never):
        assert int(other.n_iter) == int(ref.n_iter)
        assert torch.equal(other.means, ref.means)
        assert torch.equal(other.covs, ref.covs)


def test_gmm_logpdf_in_point_chunks(cpu_device, monkeypatch, rng):
    # the triangular solves go _SOLVE_POINTS points at a time; any chunk
    # gives the one-solve values
    x = torch.as_tensor(_blobs(seed=8))
    means = torch.as_tensor(rng.standard_normal((3, 2)))
    a = torch.as_tensor(rng.standard_normal((3, 2, 2)))
    chols = torch.linalg.cholesky(a @ a.mT + 0.5 * torch.eye(2))
    whole = pgmm._component_logpdf(x, means, chols)
    monkeypatch.setattr(pgmm, "_SOLVE_POINTS", 7)
    assert torch.allclose(pgmm._component_logpdf(x, means, chols), whole,
                          rtol=1e-14, atol=0.0)


def test_gmm_logpdf_sample_select_match_jax(jax_draws):
    x = _blobs(seed=4)
    jfit = crt.gmm_fit(x, 3, key=0)
    pfit = port.gmm_fit(x, 3, key=0)
    grid = np.random.default_rng(1).standard_normal((50, 2)) * 4
    _close(port.gmm_logpdf(pfit, grid), crt.gmm_logpdf(jfit, grid))
    _close(port.gmm_sample(pfit, 5, 300), crt.gmm_sample(jfit, 5, 300))
    fit, best_k, scores = port.gmm_select(x, range(1, 5), key=0)
    jbest, jk, jscores = crt.gmm_select(x, range(1, 5), key=0)
    assert best_k == jk == 3 and fit.n_components == 3
    for k in scores:
        assert abs(scores[k] - jscores[k]) <= 1e-10 * abs(jscores[k])
    with pytest.raises(ValueError, match="criterion"):
        port.gmm_select(x, [1], criterion="waic")


def test_gmm_validates_and_mesh_type(cpu_device):
    with pytest.raises(ValueError, match="n_components"):
        port.gmm_fit(np.zeros((5, 2)), 9)
    with pytest.raises(ValueError, match="cov_type"):
        port.gmm_fit(np.zeros((5, 2)), 2, cov_type="spherical")
    with pytest.raises(TypeError, match="DeviceMesh"):
        port.gmm_fit(np.zeros((8, 2)), 2, mesh=object(), axis_name="rows")


def test_gmm_fit_crosses_from_jax(cpu_device):
    x = _blobs(seed=6)
    jfit = crt.gmm_fit(x, 3, key=3, cov_type="diag")
    pfit = from_jax_state("GmmFit", jfit._asdict(), device="cpu")
    assert isinstance(pfit, port.GmmFit) and pfit.cov_type == "diag"
    assert int(pfit.n_iter) == int(jfit.n_iter)
    grid = np.random.default_rng(2).standard_normal((40, 2)) * 3
    _close(port.gmm_logpdf(pfit, grid), crt.gmm_logpdf(jfit, grid), 1e-12)
    assert abs(pfit.bic() - jfit.bic()) <= 1e-12 * abs(jfit.bic())


# ---------------------------------------------------------------- CMA-ES


def _sphere_t(x):
    return torch.sum((x - 1.5) ** 2)


def _sphere_j(x):
    return jnp.sum((x - 1.5) ** 2)


def _rosen_t(x):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                     + (1.0 - x[:-1]) ** 2)


def _rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _same_cma(got, want, rtol=1e-9):
    _close(got.history, want.history, rtol)
    _close(got.mean, want.mean, rtol)
    _close(got.x_best, want.x_best, rtol)
    assert abs(got.sigma - want.sigma) <= rtol * abs(want.sigma)
    assert abs(got.f_best - want.f_best) <= rtol * max(abs(want.f_best),
                                                       1e-300)
    assert got.n_evals == want.n_evals


def test_cma_es_matches_jax_on_the_sphere(jax_eigh):
    # 60 generations in lockstep: the same candidates, the same ranks
    want = crt.cma_es(_sphere_j, jnp.zeros(6), sigma0=0.5, n_gens=60, key=0)
    got = port.cma_es(_sphere_t, np.zeros(6), sigma0=0.5, n_gens=60, key=0)
    _same_cma(got, want)
    assert isinstance(got.history, torch.Tensor) and got.history.shape == (60,)


def test_cma_es_matches_jax_on_rosenbrock_with_bounds(jax_eigh):
    kw = dict(sigma0=0.3, n_gens=40, pop_size=16, key=1,
              bounds=[[-2.0, 2.0]] * 5)
    want = crt.cma_es(_rosen_j, jnp.full(5, -1.0), **kw)
    got = port.cma_es(_rosen_t, np.full(5, -1.0), **kw)
    _same_cma(got, want)


def test_cma_es_numpy_objective_goes_point_by_point(jax_eigh):
    calls = []

    def f(x):   # a plain numpy black box: vmap cannot trace it
        calls.append(np.asarray(x).dtype)
        return float(np.sum((np.asarray(x) - 0.8) ** 2))

    kw = dict(sigma0=0.3, n_gens=25, bounds=[[0.0, 1.0], [0.0, 1.0]], key=4)
    want = crt.cma_es(f, jnp.zeros(2), **kw)
    calls.clear()
    got = port.cma_es(f, np.zeros(2), **kw)
    assert len(calls) == got.n_evals
    assert set(calls) == {np.dtype(np.float64)}
    _same_cma(got, want)

    def item(x):    # .item() under vmap: the per-point route too
        return (x ** 2).sum().item()

    res = port.cma_es(item, np.ones(3), n_gens=5, key=0)
    assert np.isfinite(res.f_best)


def test_cma_es_other_errors_propagate_and_mesh_raises(cpu_device):
    def broken(x):
        raise RuntimeError("a failure that is not about tracing")

    with pytest.raises(RuntimeError, match="not about tracing"):
        port.cma_es(broken, np.zeros(2), n_gens=2)
    with pytest.raises(TypeError, match="DeviceMesh"):
        port.cma_es(_sphere_t, np.zeros(2), mesh=object())


def test_cma_es_converges_like_the_jax_tests(cpu_device):
    res = port.cma_es(_sphere_t, np.zeros(6), sigma0=0.5, n_gens=250, key=0)
    assert res.f_best < 1e-10
    assert float(res.history[-1]) < 1e-8 * float(res.history[0])
    res = port.cma_es(_rosen_t, np.full(5, -1.0), sigma0=0.3, n_gens=800,
                      pop_size=16, key=1)
    assert res.f_best < 1e-8
    assert np.abs(_np(res.x_best) - 1.0).max() < 1e-3


# ---------------------------------------------------------------- CCA, PLS


def _two_block(rng, n=800, p=5, q=4, rhos=(0.9, 0.5)):
    k = len(rhos)
    zx = rng.standard_normal((n, k))
    zy = np.array(rhos)[None, :] * zx + np.sqrt(
        1 - np.array(rhos)[None, :] ** 2) * rng.standard_normal((n, k))
    x = np.hstack([zx, rng.standard_normal((n, p - k))])
    y = np.hstack([zy, rng.standard_normal((n, q - k))])
    return x @ rng.standard_normal((p, p)), y @ rng.standard_normal((q, q))


def _same_up_to_sign(got, want, rtol=1e-9):
    got, want = _np(got), np.asarray(want)
    signs = np.sign(np.sum(got * want, axis=0))
    _close(got * signs[None, :], want, rtol)


@pytest.mark.parametrize("n_components,reg", [(None, 0.0), (2, 0.1)])
def test_cca_matches_jax(cpu_device, rng, n_components, reg):
    x, y = _two_block(rng)
    want = crt.cca(x, y, n_components=n_components, reg=reg)
    got = port.cca(x, y, n_components=n_components, reg=reg)
    assert isinstance(got.corrs, np.ndarray)
    _close(got.corrs, want.corrs)
    _same_up_to_sign(got.x_weights, want.x_weights)
    _same_up_to_sign(got.y_weights, want.y_weights)
    x2, y2 = _two_block(np.random.default_rng(9))
    _close(got.score(x2, y2), want.score(x2, y2), 1e-9)
    u, v = got.transform(x2[:20])
    assert v is None and u.shape == (20, got.n_components)


def test_cca_and_pls_validate(cpu_device, rng):
    x, y = _two_block(rng, n=50)
    with pytest.raises(ValueError, match="equal rows"):
        port.cca(x, y[:-1])
    with pytest.raises(ValueError, match="n_components"):
        port.cca(x, y, n_components=99)
    with pytest.raises(ValueError, match="reg"):
        port.cca(x, y, reg=-1.0)
    with pytest.raises(ValueError, match=">= 3 rows"):
        port.cca(x[:2], y[:2])
    with pytest.raises(ValueError, match="equal rows"):
        port.pls_fit(x, y[:-1], 2)
    with pytest.raises(ValueError, match="n_components"):
        port.pls_fit(x, y, 0)


@pytest.mark.parametrize("q,k", [(1, 3), (3, 4), (2, 6)])
def test_pls_matches_jax(cpu_device, rng, q, k):
    x = rng.standard_normal((120, 6)) @ rng.standard_normal((6, 6))
    y = x @ rng.standard_normal((6, q)) + 0.3 * rng.standard_normal((120, q))
    y = y[:, 0] if q == 1 else y
    want = crt.pls_fit(x, y, k)
    got = port.pls_fit(x, y, k)
    _close(got.coef, want.coef)
    _same_up_to_sign(got.x_weights, want.x_weights)
    x2 = rng.standard_normal((30, 6))
    _close(got.predict(x2), want.predict(x2))
    _same_up_to_sign(got.transform(x2), want.transform(x2))
    y2 = x2 @ np.ones((6, q)) if q > 1 else x2 @ np.ones(6)
    assert abs(got.score(x2, y2) - want.score(x2, y2)) <= 1e-10
    if k == 6:   # full rank: ordinary least squares
        xc, yc = x - x.mean(0), y - y.mean(0)
        _close(got.coef, np.linalg.lstsq(xc, yc, rcond=None)[0], 1e-9)


def test_cca_and_pls_checkpoints_from_jax(cpu_device, rng, tmp_path):
    x, y = _two_block(rng, n=300)
    path = str(tmp_path / "cca.npz")
    jfit = crt.cca(x, y, n_components=2)
    jck.save_model(path, jfit)
    for fit in (pck.load_model(path, device="cpu"),
                from_jax_state("Cca", vars(jfit), device="cpu")):
        assert isinstance(fit, port.Cca)
        _close(fit.corrs, jfit.corrs, 0.0)
        _close(fit.transform(x[:10], y[:10])[1], jfit.transform(
            x[:10], y[:10])[1], 1e-14)
        _close(fit.score(x, y), jfit.score(x, y), 1e-12)
    path = str(tmp_path / "pls.npz")
    jpls = crt.pls_fit(x, y, 3)
    jck.save_model(path, jpls)
    pls = pck.load_model(path, device="cpu")
    assert isinstance(pls, port.PlsRegressor)
    _close(pls.predict(x[:10]), jpls.predict(x[:10]), 1e-14)
    _close(pls.transform(x[:10]), jpls.transform(x[:10]), 1e-14)
    # and the port's own file round-trips
    pck.save_model(path, pls)
    again = pck.load_model(path, device="cpu")
    _close(again.predict(x[:10]), pls.predict(x[:10]), 0.0)
