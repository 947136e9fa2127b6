"""Port parity: ops.incremental and ops.robust_pca against the JAX package.

Neither draws random numbers, so the same input goes through both and the
results are held at 1e-9 (f64): Brand updates, IALM sweeps. State carried
across from the JAX package (``utils.convert``) updates as the JAX object
does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cpu_device, subspace_gap  # noqa: F401 (fixture)
from corrla_rs_tpu.ops import incremental as jax_inc
from corrla_rs_tpu.ops import robust_pca as jax_rpca
from corrla_rs_tpu_torch.ops import incremental as port_inc
from corrla_rs_tpu_torch.ops import robust_pca as port_rpca
from corrla_rs_tpu_torch.utils.convert import from_jax_state

torch.set_num_threads(1)

TOL = 1e-9


def spectrum_matrix(rng, n, m, s):
    u, _ = np.linalg.qr(rng.standard_normal((n, len(s))))
    v, _ = np.linalg.qr(rng.standard_normal((m, len(s))))
    return (u * s) @ v.T


@pytest.mark.parametrize("track_v", [True, False])
@pytest.mark.parametrize("kind", ["low-rank", "truncating"])
def test_incremental_svd_matches_jax(cpu_device, rng, kind, track_v):
    s = (np.array([9.0, 6.0, 4.0, 2.0, 1.0]) if kind == "low-rank"
         else 0.8 ** np.arange(20) * 10)
    a = spectrum_matrix(rng, 60, 48, s)
    ij = jax_inc.IncrementalSvd(5, track_v=track_v)
    it = port_inc.IncrementalSvd(5, track_v=track_v)
    for lo in range(0, 48, 12):
        ij.update(jnp.asarray(a[:, lo:lo + 12]))
        it.update(torch.tensor(a[:, lo:lo + 12]))
        np.testing.assert_allclose(it.s.numpy(), np.asarray(ij.s), rtol=TOL)
        assert subspace_gap(ij.u, it.u) <= TOL
    assert it.n_cols == ij.n_cols == 48
    if track_v:
        np.testing.assert_allclose(it.reconstruct().numpy(),
                                   np.asarray(ij.reconstruct()), atol=TOL)
        if kind == "low-rank":
            np.testing.assert_allclose(it.reconstruct().numpy(), a,
                                       atol=1e-8)
    else:
        assert it.v is None
        with pytest.raises(ValueError, match="track_v"):
            it.reconstruct()


def test_incremental_svd_single_columns_and_validation(cpu_device, rng):
    a = spectrum_matrix(rng, 30, 8, np.array([3.0, 2.0, 1.0]))
    ij, it = jax_inc.IncrementalSvd(3), port_inc.IncrementalSvd(3)
    for j in range(8):
        ij.update(jnp.asarray(a[:, j]))
        it.update(torch.tensor(a[:, j]))
    np.testing.assert_allclose(it.s.numpy(), np.asarray(ij.s), rtol=TOL)
    np.testing.assert_allclose(it.s.numpy(), [3.0, 2.0, 1.0], rtol=1e-9)
    with pytest.raises(ValueError, match="rows"):
        it.update(torch.zeros(7, 2, dtype=torch.float64))


def test_incremental_pca_matches_jax(cpu_device, rng):
    x = rng.standard_normal((90, 4)) @ rng.standard_normal((4, 12)) \
        + 0.05 * rng.standard_normal((90, 12)) + rng.standard_normal(12)
    pj, pt = jax_inc.IncrementalPca(4), port_inc.IncrementalPca(4)
    for lo in range(0, 90, 30):
        pj.partial_fit(jnp.asarray(x[lo:lo + 30]))
        pt.partial_fit(torch.tensor(x[lo:lo + 30]))
        np.testing.assert_allclose(pt.singular_values_.numpy(),
                                   np.asarray(pj.singular_values_), rtol=TOL)
        np.testing.assert_allclose(pt.mean_.numpy(), np.asarray(pj.mean_),
                                   atol=1e-12)
        assert subspace_gap(np.asarray(pj.components_).T,
                            pt.components_.mT) <= TOL
    assert pt.n_samples_seen_ == 90
    np.testing.assert_allclose(pt.explained_variance_.numpy(),
                               np.asarray(pj.explained_variance_), rtol=TOL)
    z = pt.transform(x[:7])
    np.testing.assert_allclose(
        pt.inverse_transform(z).numpy(),
        np.asarray(pj.inverse_transform(pj.transform(jnp.asarray(x[:7])))),
        atol=TOL)
    with pytest.raises(ValueError, match="features"):
        pt.partial_fit(torch.zeros(5, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="batch"):
        pt.partial_fit(torch.zeros(5, dtype=torch.float64))


@pytest.mark.parametrize("cls", ["IncrementalSvd", "IncrementalPca"])
def test_jax_state_updates_on_in_the_port(cpu_device, rng, cls):
    # half the stream through the JAX object, its state across as numpy,
    # the other half through the port: the same as JAX all the way
    a = spectrum_matrix(rng, 40, 40, 0.7 ** np.arange(12) * 5) + 1.0
    if cls == "IncrementalSvd":
        oj = jax_inc.IncrementalSvd(6)
        step = lambda o, blk, conv: o.update(conv(blk))
        fields = ("s", "u", "v")
    else:
        oj = jax_inc.IncrementalPca(6)
        step = lambda o, blk, conv: o.partial_fit(conv(blk.T))
        fields = ("singular_values_", "mean_", "components_")
    for lo in (0, 10):
        step(oj, a[:, lo:lo + 10], jnp.asarray)
    state = {k: (np.asarray(v) if hasattr(v, "shape") else v)
             for k, v in vars(oj).items()}
    ot = from_jax_state(cls, state, device="cpu")
    assert type(ot) is getattr(port_inc, cls)
    for lo in (20, 30):
        step(oj, a[:, lo:lo + 10], jnp.asarray)
        step(ot, a[:, lo:lo + 10], torch.tensor)
    np.testing.assert_allclose(getattr(ot, fields[0]).numpy(),
                               np.asarray(getattr(oj, fields[0])), rtol=TOL)
    if cls == "IncrementalSvd":
        assert ot.n_cols == 40 and ot.track_v is True
        np.testing.assert_allclose(ot.reconstruct().numpy(),
                                   np.asarray(oj.reconstruct()), atol=TOL)
    else:
        assert ot.n_samples_seen_ == 40
        np.testing.assert_allclose(ot.mean_.numpy(), np.asarray(oj.mean_),
                                   atol=1e-12)
        assert subspace_gap(np.asarray(oj.components_).T,
                            ot.components_.mT) <= TOL
    with pytest.raises(ValueError, match="lacks"):
        from_jax_state(cls, {"rank": 3})


def low_rank_plus_sparse(rng, m=60, n=40, r=3, frac=0.05, amp=10.0):
    l_true = (rng.standard_normal((m, r)) / np.sqrt(m)) @ \
        (rng.standard_normal((r, n)) / np.sqrt(n)) * np.sqrt(m * n / r)
    mask = rng.random((m, n)) < frac
    s_true = np.where(mask, amp * rng.choice([-1.0, 1.0], (m, n)), 0.0)
    return l_true + s_true, l_true, s_true


@pytest.mark.parametrize("kw", [{}, {"tol": 1e-4}, {"max_iter": 7},
                                {"lam": 0.2, "mu0": 0.05, "rho": 1.3}],
                         ids=["default", "loose", "cut", "own-penalties"])
def test_robust_pca_matches_jax(cpu_device, rng, kw):
    # the sweeps freeze on the device at the first one below tol, so the
    # count and the iterates are those of a loop that checks every sweep
    m_mat, _, _ = low_rank_plus_sparse(rng)
    lj, sj, ij = jax_rpca.robust_pca(jnp.asarray(m_mat), **kw)
    lt, st, it = port_rpca.robust_pca(torch.tensor(m_mat), **kw)
    assert it["iterations"] == ij["iterations"] and it["rank"] == ij["rank"]
    assert it["rel_residual"] == pytest.approx(ij["rel_residual"], rel=1e-6)
    # JAX takes the mean of the support mask in f32
    assert it["nnz_frac"] == pytest.approx(ij["nnz_frac"], abs=1e-7)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=TOL)


def test_robust_pca_recovers_and_validates(cpu_device, rng):
    # test_robust_pca.py::test_exact_recovery
    m_mat, l_true, s_true = low_rank_plus_sparse(rng, 120, 80, 4)
    l_hat, s_hat, info = port_rpca.robust_pca(m_mat)
    assert np.linalg.norm(l_hat.numpy() - l_true) < 1e-5 * np.linalg.norm(
        l_true)
    assert info["rank"] == 4 and info["rel_residual"] < 1e-7
    assert np.mean((np.abs(s_hat.numpy()) > 1e-3) == (s_true != 0)) > 0.999
    assert isinstance(info["iterations"], int)
    z, _, info = port_rpca.robust_pca(np.zeros((6, 5)))
    assert info == {"iterations": 0, "rel_residual": 0.0, "rank": 0,
                    "nnz_frac": 0.0} and not bool(z.any())
    with pytest.raises(ValueError, match="2-d"):
        port_rpca.robust_pca(np.zeros(5))
    with pytest.raises(ValueError, match="lam"):
        port_rpca.robust_pca(np.ones((4, 4)), lam=-1.0)
    with pytest.raises(ValueError, match="max_iter"):
        port_rpca.robust_pca(np.ones((4, 4)), max_iter=0)
    with pytest.raises(TypeError, match="DeviceMesh"):
        port_rpca.robust_pca(np.ones((4, 4)), mesh=object())
