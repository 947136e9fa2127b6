"""Parity of the port's row-sharded paths with the JAX package's.

The functions JAX's GSPMD partitions when their data arrives row-sharded
(pearson_corr / mat_cov_centered, the univariate nll, single_pass_svd,
SparseGpRegressor.fit: here a DTensor with Shard(0)), the ``mesh=`` of
sketched_lstsq, matrix_complete, spod, cp_als, nmf, robust_pca and gmm_fit,
and streaming's ``devices=`` with more than one device. The port runs in
spawned gloo worlds of 2 and 4 ranks on the CPU (tests/_torch_dist.py, one
world a size for the module); the JAX package runs here on a mesh of the
same size from the 8 virtual CPU devices, and its random draws are handed
to the port's seams. Tolerances are those of the JAX tests each path is
held to (tests/test_parallel.py, test_sketch_solve.py, test_completion.py,
test_spod.py, test_sharded_factorizations.py, test_streaming.py). Every
replicated result is bitwise equal across the ranks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_dist import World
from _torch_parity import cpu_device  # noqa: F401 (fixture)
from corrla_rs_tpu.parallel.mesh import make_mesh, shard_rows
from corrla_rs_tpu.utils.prng import as_key

torch.set_num_threads(1)

SIZES = (2, 4)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    made = {n: World(n, str(tmp_path_factory.mktemp(f"world{n}")))
            for n in SIZES}
    yield made
    for world in made.values():
        world.close()


def normal(key, shape):
    """``jax.random.normal(key, shape, f64)`` for an int seed or a key."""
    return np.asarray(jax.random.normal(as_key(key), shape, jnp.float64))


def split(key, n):
    return jax.random.split(as_key(key), n)


def replicated(out):
    """The ranks' digests of their replicated results are one."""
    assert len({r["digest"] for r in out}) == 1


def rows(a, n):
    """``a`` row-sharded on the JAX mesh of n devices."""
    return jax.device_put(jnp.asarray(a),
                          NamedSharding(make_mesh(n), P("rows")))


# ---------------------------------------------------------------------------
# the functions without mesh=: a row-sharded DTensor


@pytest.mark.parametrize("n", SIZES)
def test_pearson_and_cov_on_a_row_sharded_dtensor(n, worlds, rng):
    from corrla_rs_tpu.ops.stats_corr import mat_cov_centered, pearson_corr

    x = rng.standard_normal((4000, 6)) + np.arange(6)
    p_j = np.asarray(jax.jit(pearson_corr)(shard_rows(jnp.asarray(x),
                                                      make_mesh(n))))
    c_j = np.asarray(jax.jit(mat_cov_centered)(shard_rows(jnp.asarray(x),
                                                          make_mesh(n))))
    out = worlds[n].run("stats_rows", x)
    replicated(out)
    for r in out:
        np.testing.assert_allclose(r["pearson"], p_j, atol=1e-10)
        np.testing.assert_allclose(r["cov"], c_j, atol=1e-10)
        assert "Shard(0)" in r["error"] and "Replicate()" in r["error"]


@pytest.mark.parametrize("n", SIZES)
def test_nll_on_a_row_sharded_dtensor(n, worlds, rng):
    from corrla_rs_tpu import BetaRv, ExponentialRv, KdeRv, NormalRv

    x = rng.normal(2.0, 3.0, (4000,))
    support = rng.normal(2.0, 3.0, (50,))
    jax_rvs = {"normal": NormalRv(2.0, 3.0), "exponential": ExponentialRv(0.5),
               "beta": BetaRv(2.0, 3.0, -20.0, 20.0),
               "kde": KdeRv(0.7, jnp.asarray(support))}
    want = {name: float(jax.jit(rv.nll)(rows(np.abs(x) if name ==
                                             "exponential" else x, n)))
            for name, rv in jax_rvs.items()}
    out = worlds[n].run("nll_rows", x, torch.as_tensor(support))
    replicated(out)
    for r in out:
        for name, w in want.items():
            assert float(r[name]) == pytest.approx(w, rel=1e-12), name
            assert float(r[name]) == pytest.approx(float(r["single"][name]),
                                                   rel=1e-12), name
        # the whole gradient on every rank: not a rank's share of it, nor
        # n times it
        np.testing.assert_allclose(r["grad"], r["grad_single"], rtol=1e-12)


@pytest.mark.parametrize("n", SIZES)
def test_single_pass_svd_on_a_row_sharded_dtensor(n, worlds, rng):
    from corrla_rs_tpu.ops.random_svd import single_pass_svd

    b = rng.standard_normal((640, 9)) @ rng.standard_normal((9, 120))
    u_j, s_j, vt_j = (np.asarray(v) for v in single_pass_svd(
        shard_rows(jnp.asarray(b), make_mesh(n)), 9, 8, key=5))
    k_om, k_psi = split(5, 2)
    table = {"5/0": normal(k_om, (120, 17)), "5/1": normal(k_psi, (35, 640))}
    out = worlds[n].run("single_pass_rows", b, table)
    replicated(out)
    for r in out:
        assert r["placements"] == ["S(0)"] and r["local"] == (640 // n, 9)
        np.testing.assert_allclose(r["s"], s_j, rtol=1e-9)
        np.testing.assert_allclose(r["s"], r["single"][1], rtol=1e-9)
        rec = r["u"] @ np.diag(r["s"]) @ r["vt"]
        np.testing.assert_allclose(rec, b, atol=1e-8)
        np.testing.assert_allclose(rec, u_j @ np.diag(s_j) @ vt_j, atol=1e-8)


def _gp_data(rng, n=512):
    x = np.sort(rng.uniform(0, 6, n))[:, None]
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    return x, y, np.linspace(0.3, 5.7, 21)[:, None]


@pytest.mark.parametrize("n", SIZES)
def test_sparse_gp_fit_on_row_sharded_data(n, worlds, rng):
    from corrla_rs_tpu.ops.gp import SparseGpRegressor

    x, y, xq = _gp_data(rng)
    idx = np.asarray(jax.random.choice(as_key(3), x.shape[0], (24,),
                                       replace=False))
    fixed = {"length_scale": 0.8, "signal_var": 0.6, "noise_var": 0.02}
    # JAX's sharded fit at fixed hyperparameters (its BFGS and the port's
    # stop at different iterates, so the optimized fits are held to the
    # port's own single-device fit)
    jfit = SparseGpRegressor("rbf", inducing=24, key=3, **fixed).fit(
        shard_rows(jnp.asarray(x), make_mesh(n)), rows(y, n),
        optimize_hypers=False)
    m_j, v_j = (np.asarray(v) for v in jfit.predict(jnp.asarray(xq)))
    out = worlds[n].run("sparse_gp_rows", x, y, xq, idx, fixed)
    replicated(out)
    for r in out:
        np.testing.assert_array_equal(r["x_ind"], x[idx])
        m, v = r["fixed"]["pred"]
        np.testing.assert_allclose(m, m_j, atol=1e-7)
        np.testing.assert_allclose(v, v_j, atol=1e-9)
        for name in ("fixed", "opt"):
            m, v = r[name]["pred"]
            m1, v1 = r[name]["single"]
            np.testing.assert_allclose(m, m1, atol=1e-7)
            np.testing.assert_allclose(v, v1, atol=1e-9)
            assert r[name]["elbo"] == pytest.approx(r[name]["elbo_single"],
                                                    rel=1e-10)
        assert r["fixed"]["elbo"] == pytest.approx(jfit.elbo(), rel=1e-10)
        # the ELBO's gradient equals the single-device one: the psums'
        # backward does not scale it by the world size, and the shares of
        # the ranks' rows are summed where the replicated values meet them
        np.testing.assert_allclose(r["grad"], r["grad_single"], rtol=1e-10,
                                   atol=1e-10)


# ---------------------------------------------------------------------------
# mesh=


def _tall(rng, m, n, cond):
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (u * np.logspace(0, -np.log10(cond), n)) @ v.T


@pytest.mark.parametrize("n", SIZES)
def test_sketched_lstsq_on_a_mesh(n, worlds, rng):
    from corrla_rs_tpu.ops.sketch_solve import sketched_lstsq

    a = _tall(rng, 1600, 24, 1e4)
    b = rng.standard_normal(1600)
    x_j, _ = sketched_lstsq(a, b, key=7, mesh=make_mesh(n))
    x_j = np.asarray(x_j)
    out = worlds[n].run("lstsq_rows", a, b, {7: normal(7, (96, 1600))})
    replicated(out)
    r_j = np.linalg.norm(a @ x_j - b)
    for r in out:
        np.testing.assert_allclose(r["x"], x_j, rtol=1e-4)
        assert abs(np.linalg.norm(a @ r["x"] - b) - r_j) < 1e-10 * r_j
        np.testing.assert_array_equal(r["x_dt"], r["x"])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("shape", [(160, 48), (48, 160)])
def test_matrix_complete_on_a_mesh(n, shape, worlds, rng):
    # tall: the init's SVD is row-sharded; fat: it factors the transpose,
    # whose columns are sharded
    from corrla_rs_tpu.ops.completion import matrix_complete

    l_true = rng.standard_normal((shape[0], 4)) @ rng.standard_normal(
        (4, shape[1]))
    mask = rng.random(shape) < 0.45
    m_in = np.where(mask, l_true, 0.0)
    h_j, *_ = matrix_complete(m_in, mask, 4, n_sweeps=25, key=2,
                              mesh=make_mesh(n))
    out = worlds[n].run("completion_rows", m_in, mask, 25,
                        {2: normal(2, (min(shape), 12))})
    replicated(out)
    for r in out:
        assert r["placements"] == ["S(0)"]
        np.testing.assert_allclose(r["m_hat"], np.asarray(h_j), rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(r["m_hat"], r["single"], rtol=1e-8,
                                   atol=1e-10)


@pytest.mark.parametrize("n", SIZES)
def test_spod_on_a_mesh(n, worlds, rng):
    from corrla_rs_tpu.models.spod import spod

    n_x, n_t, n_fft = 32, 2048, 128
    s = np.linspace(0, 1, n_x)
    t = np.arange(n_t, dtype=float)
    x = (np.outer(np.sin(np.pi * s), np.cos(2 * np.pi * (16 / n_fft) * t))
         + 0.01 * rng.standard_normal((n_x, n_t)))
    weights = rng.uniform(0.5, 2.0, n_x)
    jfit = spod(x, n_fft=n_fft, overlap=0.5, n_modes=4, mesh=make_mesh(n))
    p_j = (np.asarray(jfit.modes_re[16, :, 0])
           + 1j * np.asarray(jfit.modes_im[16, :, 0]))
    out = worlds[n].run("spod_rows", x, weights)
    replicated(out)
    for r in out:
        for name in ("plain", "weighted"):
            f = r[name]
            assert f["placements"] == ["S(1)"]
            np.testing.assert_allclose(f["energies"], f["single_energies"],
                                       rtol=1e-9, atol=1e-12)
            p = f["re"][16, :, 0] + 1j * f["im"][16, :, 0]
            p1 = f["single_re"][16, :, 0] + 1j * f["single_im"][16, :, 0]
            w = weights if name == "weighted" else 1.0
            assert np.abs(np.vdot(p1, w * p)) > 1 - 1e-9
        f = r["plain"]
        np.testing.assert_allclose(f["energies"], np.asarray(jfit.energies),
                                   rtol=1e-9, atol=1e-12)
        assert np.abs(np.vdot(p_j, f["re"][16, :, 0]
                              + 1j * f["im"][16, :, 0])) > 1 - 1e-9


def _cp_tensor(rng):
    a = rng.standard_normal((64, 3))
    b = rng.standard_normal((6, 3))
    c = rng.standard_normal((5, 3))
    return np.einsum("ir,jr,kr->ijk", a, b, c)


@pytest.mark.parametrize("n", SIZES)
def test_cp_als_on_a_mesh(n, worlds):
    from corrla_rs_tpu.ops.cp import cp_als, cp_reconstruct

    t = _cp_tensor(np.random.default_rng(0))
    w_j, f_j, _ = cp_als(t, 3, n_sweeps=30, key=1, mesh=make_mesh(n))
    rec_j = np.asarray(cp_reconstruct(w_j, f_j))
    keys = split(1, 3)
    # each unfolding's sketch: (columns, rank 3 + oversamples), fat ones
    # through their transpose
    table = {"1/0": normal(keys[0], (30, 11)), "1/1": normal(keys[1], (6, 6)),
             "1/2": normal(keys[2], (5, 5))}
    out = worlds[n].run("cp_rows", t, table, "svd")
    replicated(out)
    for r in out:
        assert r["placements"] == ["S(0)"]
        np.testing.assert_allclose(r["w"], np.asarray(w_j), rtol=1e-9)
        np.testing.assert_allclose(r["rec"], rec_j,
                                   atol=1e-9 * np.abs(t).max())
        np.testing.assert_allclose(r["rec"], r["rec1"],
                                   atol=1e-9 * np.abs(t).max())
        assert float(r["fits"][-1]) > 0.9999


def test_cp_als_random_init_on_a_mesh(worlds):
    # the random init draws mode 0's factor whole and keeps each rank's rows
    t = _cp_tensor(np.random.default_rng(0))
    keys = split(1, 3)
    table = {"1/0": normal(keys[0], (64, 3)), "1/1": normal(keys[1], (6, 3)),
             "1/2": normal(keys[2], (5, 3))}
    for r in worlds[4].run("cp_rows", t, table, "random"):
        np.testing.assert_allclose(r["w"], r["w1"], rtol=1e-9)
        np.testing.assert_allclose(r["rec"], r["rec1"],
                                   atol=1e-9 * np.abs(t).max())


@pytest.mark.parametrize("n", SIZES)
def test_nmf_on_a_mesh(n, worlds):
    from corrla_rs_tpu.ops.nmf import nmf

    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (80, 4)) @ rng.uniform(0, 1, (4, 10))
    w_j, h_j, _ = nmf(x, 4, n_sweeps=100, key=2, mesh=make_mesh(n))
    wh_j = np.asarray(w_j @ h_j)
    out = worlds[n].run("nmf_rows", x, {2: normal(2, (10, 10))})
    replicated(out)
    for r in out:
        np.testing.assert_allclose(r["wh"], wh_j, atol=1e-8)
        np.testing.assert_allclose(r["wh"], r["wh1"], atol=1e-8)
        assert float(r["errs"][-1]) < 1e-2
        assert float(r["errs"][-1]) <= float(r["errs"][0])
        assert np.all(r["w"] >= 0) and np.all(r["h"] >= 0)


@pytest.mark.parametrize("n", SIZES)
def test_robust_pca_on_a_mesh(n, worlds):
    from corrla_rs_tpu.ops.robust_pca import robust_pca

    rng = np.random.default_rng(2)
    l_true = rng.standard_normal((96, 2)) @ rng.standard_normal((2, 12))
    s_true = np.zeros_like(l_true)
    idx = rng.choice(l_true.size, size=l_true.size // 20, replace=False)
    s_true.flat[idx] = rng.standard_normal(idx.size) * 5.0
    m = l_true + s_true
    l_j, s_j, info_j = robust_pca(m, max_iter=120, mesh=make_mesh(n))
    scale = np.abs(l_true).max()
    out = worlds[n].run("rpca_rows", m)
    replicated(out)
    for r in out:
        assert r["placements"] == ["S(0)"]
        np.testing.assert_allclose(r["l"], np.asarray(l_j), atol=1e-9 * scale)
        np.testing.assert_allclose(r["s"], np.asarray(s_j), atol=1e-9 * scale)
        assert r["info"]["iterations"] == info_j["iterations"]
        assert r["info"]["rank"] == info_j["rank"] == 2
        resid = np.linalg.norm(m - r["l"] - r["s"])
        assert resid / np.linalg.norm(m) < 1e-6


@pytest.mark.parametrize("n", SIZES)
def test_gmm_fit_on_a_mesh(n, worlds):
    from corrla_rs_tpu.ops.gmm import gmm_fit

    rng = np.random.default_rng(6)
    centers = np.array([[-3.0, 0.0], [3.0, 0.0], [0.0, 4.0]])
    x = np.concatenate([rng.standard_normal((80, 2)) * 0.5 + c
                        for c in centers])
    f_j = gmm_fit(x, 3, key=2, n_iter=60, mesh=make_mesh(n))
    keys = split(2, 3)
    first = int(jax.random.randint(keys[0], (), 0, x.shape[0]))
    gumbel = np.stack([np.zeros(x.shape[0])] + [
        np.asarray(jax.random.gumbel(keys[j], (x.shape[0],), jnp.float64))
        for j in range(1, 3)])
    out = worlds[n].run("gmm_rows", x, first, gumbel)
    replicated(out)
    for r in out:
        w, means, covs, ll, it = r["fit"]
        np.testing.assert_allclose(means, np.asarray(f_j.means), rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(w, np.asarray(f_j.weights), rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(covs, np.asarray(f_j.covs), rtol=1e-7,
                                   atol=1e-9)
        assert float(ll) == pytest.approx(float(f_j.log_likelihood),
                                          rel=1e-9)
        assert int(it) == int(f_j.n_iter)
        for got, want in zip(r["fit"], r["single"]):
            np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)
        assert r["resp"].shape == (240, 3)
        assert r["bic"] == pytest.approx(f_j.bic(), rel=1e-9)
        assert "divide" in r["error"]


# ---------------------------------------------------------------------------
# the sharded factorizations never gather the matrix


def test_sharded_factorizations_never_gather(worlds, rng):
    """The counterpart of test_sharded_factorizations.py's never-gathers
    contract: every collective of the sharded RSVD, the PcaRsvd cov path,
    cp_als, nmf and robust_pca moves less than one rank's shard of the
    matrix, and within the O(k m) budget of that test (8x headroom)."""
    n_dev = 4
    n, m_cols, k = 512, 48, 4
    a = rng.standard_normal((n, m_cols))
    t = np.einsum("ir,jr,kr->ijk", rng.standard_normal((512, 3)),
                  rng.standard_normal((6, 3)), rng.standard_normal((5, 3)))
    x = rng.uniform(0, 1, (512, 4)) @ rng.uniform(0, 1, (4, 48))
    m = rng.standard_normal((512, 2)) @ rng.standard_normal((2, 12))
    out = worlds[n_dev].run("traffic", a, t, x, m, k)[0]
    kk = k + 4
    shards = {"rsvd": a.nbytes, "pca": a.nbytes, "cp": t.nbytes,
              "nmf": x.nbytes, "robust_pca": m.nbytes}
    # the legal largest: the rsvd's gathered R stack / psummed B, O(k m);
    # cp's init (the mode-0 unfolding's, 30 columns at a sketch of 11) and
    # its (I_k, R) MTTKRP partials; nmf's (r, n + r) Gram; robust PCA's
    # (n, n) Gram
    legal = {"rsvd": max(kk * m_cols, 8 * kk * kk), "pca": m_cols * m_cols,
             "cp": max(11 * 30, 8 * 11 * 11), "nmf": 4 * (48 + 4),
             "robust_pca": 12 * 12}
    for name, (largest, count) in out.items():
        assert count > 0, name
        assert largest < shards[name] // n_dev, (name, largest)
        assert largest <= 8 * legal[name] * 8, (name, largest)


# ---------------------------------------------------------------------------
# streaming over several devices (no world: slots in this process)


def test_streamed_multi_device_matches_single(cpu_device, rng):
    """test_streaming.py's multi-device tests: two and four slots on the
    CPU against one, and the covariance against mat_cov_centered."""
    from corrla_rs_tpu.ops.stats_corr import mat_cov_centered
    from corrla_rs_tpu.ops.streaming import streamed_random_svd as j_rsvd
    from corrla_rs_tpu_torch.ops import random_svd as port_rsvd
    from corrla_rs_tpu_torch.ops import streaming as pst

    a = rng.standard_normal((200, 16)) * 0.7 ** np.arange(16)
    omega = normal(3, (16, 14))
    u_j, s_j, _ = j_rsvd(a, 6, 6, 8, key=3, block_rows=50,
                         devices=jax.devices()[:2])
    orig = port_rsvd._draw_sketch
    port_rsvd._draw_sketch = lambda seed, shape, dtype, device: \
        torch.tensor(omega if tuple(shape) == (16, 14)
                     else normal(seed, shape), dtype=dtype)
    try:
        two = ["cpu", "cpu"]
        u0, s0, _ = pst.streamed_random_svd(a, 6, 6, 8, key=3, block_rows=50)
        u1, s1, _ = pst.streamed_random_svd(a, 6, 6, 8, key=3, block_rows=50,
                                            devices=two)
        sp0, _ = pst.streamed_pca(a, 4, block_rows=50)
        sp1, _ = pst.streamed_pca(a, 4, block_rows=50, devices=two)
    finally:
        port_rsvd._draw_sketch = orig
    np.testing.assert_allclose(s1.numpy(), s0.numpy(), rtol=1e-9)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s_j), rtol=1e-9)
    p0, p1 = u0.numpy() @ u0.numpy().T, u1.numpy() @ u1.numpy().T
    np.testing.assert_allclose(p1, p0, atol=1e-8)
    np.testing.assert_allclose(p1, np.asarray(u_j) @ np.asarray(u_j).T,
                               atol=1e-8)
    np.testing.assert_allclose(sp1.numpy(), sp0.numpy(), rtol=1e-9)
    with pytest.raises(ValueError, match="gram"):
        pst.streamed_random_svd(a, 4, 4, 4, method="power", devices=two)
    x = rng.standard_normal((800, 5)) + 2.0
    want = np.asarray(mat_cov_centered(jnp.asarray(x)))
    got = pst.streamed_cov(x, block_rows=128, devices=["cpu"] * 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10)
