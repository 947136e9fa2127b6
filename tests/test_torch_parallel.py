"""Parity of the port's multi-device layer with the JAX package's.

Mirrors tests/test_parallel.py for parallel.mesh, sharded_rsvd,
sharded_hosvd, sharded_samplers and the ``mesh=`` of PcaRsvd, PodI, DMDc
and the active-subspace fits. The port runs in spawned gloo worlds of 2
and 4 ranks on the CPU (tests/_torch_dist.py, one world per size for the
module); the JAX package runs here on a mesh of the same size from the 8
virtual CPU devices, and its random draws are handed to the port's seams.
Same sketch, f64: sigma/U/Vt, PCA, POD and HOSVD within 1e-10; DMDc at
test_parallel.py's own tolerances; the samplers within 1e-10 on shared
draws, and at the JAX tests' statistical limits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import World
from _torch_parity import cpu_device  # noqa: F401 (fixture)
from corrla_rs_tpu.parallel.mesh import CHAINS_AXIS, make_mesh
from corrla_rs_tpu.utils.prng import as_key

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    world = World(2, str(tmp_path_factory.mktemp("world2")))
    yield world
    world.close()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    world = World(4, str(tmp_path_factory.mktemp("world4")))
    yield world
    world.close()


def normal(key, shape, dtype=np.float64):
    """The JAX package's ``jax.random.normal(as_key(key), shape, dtype)``."""
    jdt = jnp.float32 if dtype == np.float32 else jnp.float64
    return np.asarray(jax.random.normal(as_key(key), shape, jdt))


def signed(a, b):
    """``a`` with each column's sign turned to agree with ``b``'s."""
    s = np.sign(np.sum(np.asarray(a) * np.asarray(b), axis=0))
    return np.asarray(a) * np.where(s == 0, 1.0, s)


# ---------------------------------------------------------------------------
# mesh


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_and_sharding(n, world2, world4):
    world = {2: world2, 4: world4}[n]
    out = world.run("mesh", n)
    for r in out:
        assert r["size"] == n and r["names"] == ("rows",)
        assert r["placements_ok"] and r["full_ok"] and r["local_rows"] == 2
        assert r["replicated"] == ["R"]
        assert r["mesh2d"] == ((n // 2, 2), ("rows", "chains"))
        assert r["errors"][0] == f"mesh {n}x2 needs {2 * n} devices, have {n}"
        assert r["over"] == n
        assert "must divide the mesh axis size" in r["errors"][1]


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_helpers_faults(n, world2, world4):
    # make_mesh(9) is the mesh over every device, as the JAX package's on
    # its 8 virtual ones; an axis the mesh lacks is a ValueError that names
    # the mesh's axes, from _axis and from row_sharding (which returned a
    # replicated "row sharding" for one)
    assert make_mesh(9).devices.size == len(jax.devices())
    for r in {2: world2, 4: world4}[n].run("mesh_faults"):
        assert r["big"] == n
        for name in ("axis", "row_sharding"):
            assert r[name] == ("mesh has no axis 'bogus'; its axes are "
                               "('rows',)")


def test_mesh_needs_a_process_group():
    # no fallback to one process: without a process group it raises
    from corrla_rs_tpu_torch.parallel.mesh import make_mesh as port_make_mesh

    with pytest.raises(RuntimeError, match="init_distributed"):
        port_make_mesh(device_type="cpu")


def test_mesh_config_matches_jax():
    from corrla_rs_tpu.utils.config import MeshConfig as JaxMeshConfig
    from corrla_rs_tpu_torch.utils.config import MeshConfig

    assert vars(MeshConfig()) == vars(JaxMeshConfig())


# ---------------------------------------------------------------------------
# sharded randomized SVD


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_rsvd_matches_single_device(n, world2, world4, rng):
    from corrla_rs_tpu.ops.random_svd import random_svd
    from corrla_rs_tpu.parallel.sharded_rsvd import sharded_random_svd

    world = {2: world2, 4: world4}[n]
    a = rng.standard_normal((240, 32))
    u_j, s_j, vt_j = (np.asarray(v) for v in sharded_random_svd(
        jnp.asarray(a), 5, 10, 8, key=0, mesh=make_mesh(n)))
    out = world.run("rsvd", a, 5, 10, 8, {0: normal(0, (32, 13))},
                    "always")
    for r in out:
        u, s, vt = r["usv"]
        # same sketch: the JAX package's sharded result to 1e-10
        np.testing.assert_allclose(s, s_j, rtol=1e-10)
        np.testing.assert_allclose(signed(u, u_j), u_j, atol=1e-10)
        np.testing.assert_allclose(signed(vt.T, vt_j.T), vt_j.T, atol=1e-10)
        # U comes back sharded along its rows
        assert r["local"] == (240 // n, 5) and r["placements"] == ["S(0)"]
        # the JAX test's bars: LAPACK and the single-device rsvd
        s_exact = np.linalg.svd(a, compute_uv=False)[:5]
        np.testing.assert_allclose(s, s_exact, rtol=1e-3)
        _u1, s_1, _vt1 = random_svd(jnp.asarray(a), 5, 10, 8, key=0,
                                    stabilize="always")
        np.testing.assert_allclose(s, np.asarray(s_1), rtol=1e-3)
        # and the port's single-device random_svd on the same sketch
        np.testing.assert_allclose(s, r["single"][1], rtol=1e-10)


def test_sharded_rsvd_takes_a_dtensor(world2, rng):
    a = rng.standard_normal((240, 32))
    table = {0: normal(0, (32, 13))}
    full = world2.run("rsvd", a, 5, 10, 8, table, "always")[0]["usv"]
    for u, s, vt in world2.run("rsvd_dtensor", a, table):
        np.testing.assert_array_equal(s, full[1])
        np.testing.assert_array_equal(u, full[0])


def test_sharded_rsvd_on_a_2d_mesh(world2, world4, rng):
    # rows over the "rows" axis of a 2 x 2 mesh, replicated over "chains":
    # every rank holds the 2-rank 1-D mesh's answer
    a = rng.standard_normal((240, 32))
    table = {0: normal(0, (32, 13))}
    want = world2.run("rsvd", a, 5, 10, 8, table, "always")[0]["usv"]
    for r in world4.run("rsvd_2d", a, table):
        assert r["local"] == (120, 5)
        assert r["placements"] == ["S(0)", "R"]
        for got, ref in zip(r["usv"], want):
            np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13)


def test_sharded_rsvd_f32_sigma_parity(world4, rng):
    # an exactly rank-16 matrix whose spectrum fits the sketch: the sigma
    # error isolates the final TSQR's rounding (same bar as test_parallel)
    n, m, r = 800, 64, 16
    uu = np.linalg.qr(rng.standard_normal((n, r)))[0]
    vv = np.linalg.qr(rng.standard_normal((m, r)))[0]
    sig = 10.0 * 0.7 ** np.arange(r)
    a64 = (uu * sig) @ vv.T
    table = {0: normal(0, (m, 16), np.float32)}
    out = world4.run("rsvd", a64.astype(np.float32), 8, 10, 8, table,
                     "always")
    s_exact = np.linalg.svd(a64, compute_uv=False)[:8]
    for res in out:
        s32 = res["usv"][1]
        assert s32.dtype == np.float32
        err = np.max(np.abs(s32.astype(np.float64) - s_exact) / s_exact)
        assert err < 1e-6, err


def test_sharded_rsvd_reconstruction_lowrank(world4, rng):
    b = rng.standard_normal((160, 6)) @ rng.standard_normal((6, 40))
    out = world4.run("rsvd", b, 6, 10, 8, {0: normal(1, (40, 14))},
                     "always")
    for res in out:
        u, s, vt = res["usv"]
        np.testing.assert_allclose(u @ np.diag(s) @ vt, b, atol=1e-7)


def test_sharded_rsvd_validates_shapes(world2):
    for fat, nondiv in world2.run("rsvd_validates"):
        assert "tall" in fat
        assert "must divide the mesh axis size" in nondiv


def test_sharded_power_iter_qr(world4, rng):
    from corrla_rs_tpu_torch.ops.random_svd import _cholesky_qr2

    a = rng.standard_normal((160, 24)) * 0.8 ** np.arange(24)
    omega = rng.standard_normal((24, 8))
    q = world4.run("power_iter_qr", a, omega)[0]
    np.testing.assert_allclose(q.T @ q, np.eye(8), atol=1e-12)
    # the single-device range finder on the same sketch spans the same
    at = torch.as_tensor(a)
    y = at @ torch.as_tensor(omega)
    for _ in range(6):
        y = _cholesky_qr2(y)
        y = at @ (at.mT @ y)
        y = y / torch.linalg.vector_norm(y)
    q1 = torch.linalg.qr(y).Q.numpy()
    np.testing.assert_allclose(q @ q.T, q1 @ q1.T, atol=1e-10)


# ---------------------------------------------------------------------------
# the models' mesh=


def test_sharded_pca_matches_single(world2, rng):
    from corrla_rs_tpu import PcaRsvd

    x = rng.standard_normal((800, 16))
    p1 = PcaRsvd(jnp.asarray(x), 4)
    p2 = PcaRsvd(jnp.asarray(x), 4, mesh=make_mesh(2))
    out = world2.run("pca", x, 4, {0: normal(0, (16, 14))})
    for r in out:
        np.testing.assert_allclose(r["s"], np.asarray(p2.singular_values),
                                   rtol=1e-10)
        comps = np.asarray(p2.components)
        np.testing.assert_allclose(signed(r["comps"].T, comps.T), comps.T,
                                   atol=1e-10)
        np.testing.assert_allclose(r["means"], np.asarray(p2.means),
                                   atol=1e-12)
        np.testing.assert_allclose(r["ev"], np.asarray(p2.explained_var()),
                                   rtol=1e-10)
        tr = np.asarray(p2.apply_tr(jnp.asarray(x[:7])))
        np.testing.assert_allclose(signed(r["tr"], tr), tr, atol=1e-10)
        # the JAX test's bar against the single-device fit
        np.testing.assert_allclose(r["s"], np.asarray(p1.singular_values),
                                   rtol=1e-6)


def _pod_family():
    nx, ns = 400, 12
    xg = np.linspace(0, 10, nx)
    tg = np.linspace(1, 9, ns)[:, None]
    return (0.5 * tg) * np.exp(-((xg[None, :] - tg) ** 2) / 4.0), tg


def test_sharded_pod_matches_single(world2):
    from corrla_rs_tpu import PodI

    p, t = _pod_family()
    pod1 = PodI(jnp.asarray(p), jnp.asarray(t), 4)
    pod2 = PodI(jnp.asarray(p), jnp.asarray(t), 4, mesh=make_mesh(2))
    tq = np.array([[5.0], [2.5], [7.25]])
    want = np.asarray(pod2.predict(jnp.asarray(tq)))
    out = world2.run("pod", p, t, 4, {0: normal(0, (12, 12))}, tq)
    for r in out:
        # modes have sign freedom; predictions and the projector do not
        np.testing.assert_allclose(r["pred"], want, rtol=1e-10, atol=1e-12)
        m2 = np.asarray(pod2.modes)
        np.testing.assert_allclose(r["modes"] @ r["modes"].T, m2 @ m2.T,
                                   atol=1e-10)
        assert r["modes_local"] == (200, 4)
        assert r["pred_placements"] == ["S(0)"]
        np.testing.assert_allclose(
            r["pred"], np.asarray(pod1.predict(jnp.asarray(tq))),
            rtol=1e-5, atol=1e-8)


def test_sharded_active_subspace_matches_single(world2, rng):
    from corrla_rs_tpu.models.active_subspaces import (
        ActiveSsRsvd,
        PolyGradientEstimator,
    )

    n, k = 160, 3
    x = rng.uniform(-1.0, 1.0, (n, k))
    y = 0.1 * x[:, 0] + 5.0 * x[:, 1] + 0.3 * x[:, 2] + 2.0 * x[:, 1] ** 2
    mesh = make_mesh(2)
    est = ActiveSsRsvd(PolyGradientEstimator(jnp.asarray(x), jnp.asarray(y),
                                             2, 16), 2)
    f1 = est.fit(jnp.asarray(x))
    f2 = est.fit(jnp.asarray(x), mesh=mesh)
    s2 = est.fit_svd(jnp.asarray(x), key=2, mesh=mesh)
    n_boot = 20
    boot_j = est.fit_bootstrap(jnp.asarray(x), n_boot=n_boot, key=1,
                               mesh=mesh)
    idx = np.asarray(jax.random.randint(as_key(1), (n_boot, n), 0, n))
    out = world2.run("active_ss", x, y, {2: normal(2, (3, 3))}, idx)
    for r in out:
        np.testing.assert_allclose(r["vals"], np.asarray(f2.singular_vals),
                                   rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(np.abs(r["comps"]),
                                   np.abs(np.asarray(f2.components)),
                                   atol=1e-10)
        np.testing.assert_allclose(r["sensi"],
                                   np.asarray(f2.var_diag_evd_sensi()),
                                   rtol=1e-10)
        # the JAX test's bars against the single-device fit
        np.testing.assert_allclose(r["vals"], np.asarray(f1.singular_vals),
                                   rtol=1e-8)
        assert int(np.abs(r["comps"][:, 0]).argmax()) == 1
        np.testing.assert_allclose(np.diagonal(r["svd_vals"]),
                                   np.diagonal(np.asarray(s2.singular_vals_)),
                                   rtol=1e-10)
        np.testing.assert_allclose(
            np.abs(r["svd_comps"]), np.abs(np.asarray(s2.components_)),
            atol=1e-10)
        for key in ("eigs", "eig_lo", "eig_hi", "subspace_dist"):
            np.testing.assert_allclose(r["boot"][key],
                                       np.asarray(boot_j[key]),
                                       rtol=1e-9, atol=1e-12)
        assert "divide the mesh" in r["error"]


def _dmdc_fixture():
    nx, nt = 160, 30
    xg = np.linspace(0, 10, nx)
    tg = np.linspace(0, 10, nt)
    u = np.exp(0.2 * tg)[None, :].astype(np.float32)
    snaps = (np.sin(xg[:, None] + 0.2 * tg[None, :]) * u).astype(np.float32)
    return snaps, u


def _dmdc_table(key, n_t, sketch, dtype):
    k1, k2 = jax.random.split(as_key(key))
    return {f"{key}/0": normal(k1, (n_t - 1, sketch), dtype),
            f"{key}/1": normal(k2, (n_t - 1, sketch), dtype)}


def test_sharded_dmdc_matches_single(world2):
    from corrla_rs_tpu import DMDc

    snaps, u = _dmdc_fixture()
    m1 = DMDc(jnp.asarray(snaps), jnp.asarray(u), 8, 20, key=3)
    m2 = DMDc(jnp.asarray(snaps), jnp.asarray(u), 8, 20, key=3,
              mesh=make_mesh(2))
    out = world2.run("dmdc", snaps, u, 8, 20,
                     _dmdc_table(3, 30, 20, np.float32), 12)
    top = {}
    for name, lam in (("jax", m1.lambdas), ("jax_mesh", m2.lambdas)):
        lam = np.asarray(lam)
        top[name] = np.sort_complex(lam[np.argsort(-np.abs(lam))][:2])
    v, w = jnp.asarray(snaps[:, 12:13]), jnp.asarray(u[:, 12:13])
    one1 = np.asarray(m1.predict(v, w))
    scale = np.abs(one1).max()
    p1 = np.asarray(m1.predict_multiple(jnp.asarray(snaps[:, 0:1]),
                                        jnp.asarray(u)))
    for r in out:
        assert r["placements"] == ["S(0)"]
        lam = r["lambdas"]
        mine = np.sort_complex(lam[np.argsort(-np.abs(lam))][:2])
        # (a) the dominant DMD eigenvalues, basis-invariant
        for name in ("jax", "jax_mesh"):
            np.testing.assert_allclose(mine, top[name], rtol=1e-4)
        # (b) one step of the full-state operators on the data manifold
        np.testing.assert_allclose(r["one"], one1, atol=2e-3 * scale)
        np.testing.assert_allclose(r["one"][:, 0], snaps[:, 13], atol=5e-2)
        # the rollouts against the JAX package's and the truth
        for method in ("dense", "modes", "reduced"):
            np.testing.assert_allclose(r[method], p1, rtol=1e-2, atol=1e-2)
            np.testing.assert_allclose(r[method][:, 19], snaps[:, 20],
                                       atol=5e-2)
        np.testing.assert_array_equal(r["reduced_dt"], r["reduced"])
        # B and the dense A come back whole from their shards
        assert r["b"].shape == (160, 1) and r["a"].shape == (160, 160)


def test_sharded_dmdc_rejects_nondivisible(world2):
    snaps = np.random.default_rng(0).standard_normal((31, 10))
    for err in world2.run("dmdc_rejects", snaps.astype(np.float32),
                          np.ones((1, 10), np.float32)):
        assert "divide the mesh" in err


# ---------------------------------------------------------------------------
# sharded HOSVD


def _tucker_tensor(rng):
    g = rng.standard_normal((3, 2, 2))
    u0 = np.linalg.qr(rng.standard_normal((160, 3)))[0]
    u1 = np.linalg.qr(rng.standard_normal((6, 2)))[0]
    u2 = np.linalg.qr(rng.standard_normal((5, 2)))[0]
    t = np.einsum("abc,ia,jb,kc->ijk", g, u0, u1, u2)
    return t + 1e-9 * rng.standard_normal(t.shape)


def test_sharded_hosvd_matches_single_device(world2, rng):
    from corrla_rs_tpu.ops.hosvd import hosvd, tucker_reconstruct
    from corrla_rs_tpu.parallel.sharded_hosvd import sharded_hosvd

    t = _tucker_tensor(rng)
    core_j, fac_j = sharded_hosvd(t, (3, 2, 2), mesh=make_mesh(2))
    rec_j = np.asarray(tucker_reconstruct(core_j, fac_j))
    core_m, fac_m = hosvd(jnp.asarray(t), (3, 2, 2))
    rec_m = np.asarray(tucker_reconstruct(core_m, fac_m))
    out = world2.run("hosvd", t, (3, 2, 2), {0: normal(0, (30, 11))})
    for r in out:
        assert r["core"].shape == (3, 2, 2) and r["local"] == (80, 3)
        for f, fj, rank in zip(r["factors"], fac_j, (3, 2, 2)):
            fj = np.asarray(fj)
            np.testing.assert_allclose(f.T @ f, np.eye(rank), atol=1e-8)
            np.testing.assert_allclose(f @ f.T, fj @ fj.T, atol=1e-10)
        np.testing.assert_allclose(np.abs(r["core"]),
                                   np.abs(np.asarray(core_j)), atol=1e-10)
        np.testing.assert_allclose(r["rec"], rec_j, atol=1e-10)
        np.testing.assert_allclose(r["rec"], rec_m, atol=1e-7)
        np.testing.assert_allclose(r["rec"], t, atol=1e-7)


def test_sharded_hosvd_validates(world2):
    cases = [((43, 3, 2), (2, 2, 2)), ((16, 30, 2), (2, 2, 2)),
             ((160, 2, 2), (8, 2, 2))]
    for div, long, prod in world2.run("hosvd_validates", cases):
        assert "divide" in div
        assert "long" in long
        assert "prod" in prod


# ---------------------------------------------------------------------------
# sharded samplers


def _jax_demc_draws(key, n_steps, n_chains, ndim, var_eps):
    """The per-generation draws of the JAX package's demc_run_sharded:
    per-chain keys of each step key, split three ways."""
    from corrla_rs_tpu.ops.samplers import _pick_two_others

    def per_step(step_key):
        def one(c, ck):
            k_pick, k_jit, k_acc = jax.random.split(ck, 3)
            a, b = _pick_two_others(k_pick, c, n_chains)
            jit = jax.random.uniform(k_jit, (ndim,), jnp.float64, 0.0,
                                     var_eps)
            return (jnp.stack([a, b]), jit,
                    jax.random.uniform(k_acc, (), jnp.float64))
        return jax.vmap(one)(jnp.arange(n_chains),
                             jax.random.split(step_key, n_chains))

    pairs, jit, u = jax.vmap(per_step)(
        jax.random.split(as_key(key), n_steps))
    return np.asarray(pairs).astype(np.int64), np.asarray(jit), np.asarray(u)


def test_sharded_demc_gaussian(world4):
    from corrla_rs_tpu.ops.samplers import ln_like_sum, ln_prior_uniform
    from corrla_rs_tpu.parallel.sharded_samplers import demc_run_sharded

    mu, std = 2.0, 3.0

    def lnp_like(x):
        return -0.5 * ((x[0] - mu) / std) ** 2 - jnp.log(std)

    lnp = ln_like_sum(lnp_like, ln_prior_uniform(np.array([[-20.0, 20.0]])))
    heads0 = np.zeros((16, 1))
    hist_j, heads_j, ar_j = demc_run_sharded(
        jnp.asarray(heads0), lnp, 1600, gamma=0.8, var_epsilon=1e-10, key=0,
        mesh=make_mesh(4, axis_name=CHAINS_AXIS))
    draws = _jax_demc_draws(0, 1600, 16, 1, 1e-10)
    for r in world4.run("demc", heads0, 1600, draws, 4):
        assert r["hist"].shape == (1600, 16, 1)
        assert r["heads"].shape == (16, 1)
        assert r["placements"] == ["S(1)"]
        # the same draws: the JAX package's run. DEMC amplifies a last-bit
        # difference between XLA's and ATen's rounding about tenfold every
        # ten generations (the port's single-device run on these draws
        # departs from JAX's alike), so the trajectories are held together
        # for the first 100 generations and the whole run statistically;
        # sharded against single-device, same arithmetic, the whole run is
        # held in test_sharded_demc_is_the_single_device_run
        np.testing.assert_allclose(r["hist"][:100], np.asarray(hist_j)[:100],
                                   rtol=1e-10, atol=1e-10)
        # and the JAX test's statistical bars
        tail = r["hist"][-800:].reshape(-1)
        assert abs(tail.mean() - mu) < 5e-1
        assert abs(tail.std(ddof=1) - std) < 5e-1
        assert r["ar"] > 0.2


def test_sharded_demc_is_the_single_device_run(world2):
    heads0 = np.linspace(-1.0, 1.0, 12)[:, None]
    for r in world2.run("demc_same_draws", heads0, 300, 7):
        np.testing.assert_allclose(r["hist"], r["single"], rtol=1e-10,
                                   atol=1e-12)
        assert r["ar"] == r["ar_single"]


def test_sharded_dream_gaussian(world2):
    mu, std = 2.0, 3.0
    heads0 = np.linspace(-1, 1, 16)[:, None]
    for r in world2.run("dream", heads0, 1600, 0, 300):
        assert r["hist"].shape == (1600, 16, 1)
        # the single-device run on the same draws, adaptation included
        np.testing.assert_allclose(r["hist"], r["single"], rtol=1e-10,
                                   atol=1e-12)
        assert r["ar"] == r["ar_single"]
        # the JAX test's statistical bars
        tail = r["hist"][-800:].reshape(-1)
        assert abs(tail.mean() - mu) < 5e-1
        assert abs(tail.std(ddof=1) - std) < 5e-1
        assert r["ar"] > 0.15
        assert "must divide n_chains" in r["errors"]


def _jax_stretch_draws(key, n_steps, half):
    """The per-generation draws of the JAX package's stretch_run_sharded,
    as (partners, u_z, u_acc), each (n_steps, 2, half)."""
    def per_step(step_key):
        ks = jax.random.split(step_key, 6)
        return tuple(
            jnp.stack([draw(ks[3 * g + i]) for g in range(2)])
            for i, draw in enumerate((
                lambda k: jax.random.randint(k, (half,), 0, half),
                lambda k: jax.random.uniform(k, (half,), jnp.float64),
                lambda k: jax.random.uniform(k, (half,), jnp.float64))))

    p, z, u = jax.vmap(per_step)(jax.random.split(as_key(key), n_steps))
    return np.asarray(p).astype(np.int64), np.asarray(z), np.asarray(u)


def test_sharded_stretch_invariance(world2):
    from corrla_rs_tpu.parallel.sharded_samplers import stretch_run_sharded

    w0 = np.asarray(jax.random.normal(jax.random.key(0), (32, 2),
                                      jnp.float64))

    def lnp_iso(x):
        return -0.5 * jnp.sum(x ** 2)

    h_j, w_j, ar_j = stretch_run_sharded(
        jnp.asarray(w0), lnp_iso, 100, key=2,
        mesh=make_mesh(2, axis_name=CHAINS_AXIS))
    draws = _jax_stretch_draws(2, 100, 16)
    scale = np.array([4.0, 0.5])
    for r in world2.run("stretch", w0, 100, draws):
        h1, final1, ar1 = r["iso"]
        h2, _, _ = r["skew"]
        # the JAX package's sharded run on its own draws
        np.testing.assert_allclose(h1, np.asarray(h_j), rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_allclose(final1, np.asarray(w_j), rtol=1e-10,
                                   atol=1e-10)
        assert ar1 == pytest.approx(ar_j, abs=1e-12)
        # bit-exact diagonal affine equivariance survives the sharding
        np.testing.assert_array_equal(h2, h1 * scale)
        assert "divide" in r["error"]


def test_sharded_stretch_is_the_single_device_run(world2):
    w0 = np.random.default_rng(3).standard_normal((24, 2))
    for r in world2.run("stretch_same_draws", w0, 200, 5):
        np.testing.assert_allclose(r["hist"], r["single"], rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_array_equal(r["heads"], r["hist"][-1])
        assert r["ar"] == r["ar_single"]


# ---------------------------------------------------------------------------
# checkpoints of sharded models


def test_sharded_models_checkpoint_to_single_device(world2, tmp_path, rng,
                                                    cpu_device):
    from corrla_rs_tpu_torch.utils.checkpoint import load_model

    x = rng.standard_normal((64, 8))
    p, t = _pod_family()
    snaps, u = (v.astype(np.float64) for v in _dmdc_fixture())
    # PcaRsvd and PodI both draw from key 0, each at its own shape
    table = {(0, (8, 8)): normal(0, (8, 8)),
             (0, (12, 12)): normal(0, (12, 12)),
             **_dmdc_table(3, 30, 16, np.float64)}
    prefix = str(tmp_path / "sharded")
    out = world2.run("checkpoint", prefix, x, p, t, snaps, u, table)
    assert [r["wrote"] for r in out] == [True, True]
    pca = load_model(prefix + "_pca.npz", device="cpu")
    pod = load_model(prefix + "_pod.npz", device="cpu")
    dmdc = load_model(prefix + "_dmdc.npz", device="cpu")
    assert pca._mesh is None and pod._mesh is None
    np.testing.assert_allclose(pca.apply_tr(torch.as_tensor(x[:5])).numpy(),
                               out[0]["pca_tr"], atol=1e-12)
    np.testing.assert_allclose(pod.predict(torch.as_tensor(t[:3])).numpy(),
                               out[0]["pod_pred"], atol=1e-12)
    np.testing.assert_allclose(out[0]["pod_conv_pred"], out[0]["pod_pred"],
                               atol=1e-12)
    assert out[0]["pod_conv_mesh"] is None
    roll = dmdc.predict_multiple(torch.as_tensor(snaps[:, :1]),
                                 torch.as_tensor(u[:, :6]), method="modes")
    np.testing.assert_allclose(roll.numpy(), out[0]["dmdc_roll"], rtol=1e-9,
                               atol=1e-12)
