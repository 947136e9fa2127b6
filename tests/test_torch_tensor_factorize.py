"""Port parity: ops.tt, ops.cp, ops.nmf and ops.completion against the JAX
package.

The same numpy input goes through both packages on the CPU with the
sketches and key splits shared (``same_sketch``). TT cores and CP factors
carry the signs of their SVDs, which differ between LAPACK builds, so cores
are compared up to sign through the reconstruction and the rank-one terms;
everything else (histories, weights, reconstructions) at 1e-10 in f64 and
1e-4 in f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cpu_device, same_sketch  # noqa: F401 (fixtures)
from corrla_rs_tpu.ops import completion as jax_mc
from corrla_rs_tpu.ops import cp as jax_cp
from corrla_rs_tpu.ops import nmf as jax_nmf
from corrla_rs_tpu.ops import tt as jax_tt
from corrla_rs_tpu_torch.ops import completion as port_mc
from corrla_rs_tpu_torch.ops import cp as port_cp
from corrla_rs_tpu_torch.ops import nmf as port_nmf
from corrla_rs_tpu_torch.ops import tt as port_tt
from corrla_rs_tpu_torch.utils.convert import from_jax_state

torch.set_num_threads(1)

TOL = {np.float64: 1e-10, np.float32: 1e-4}


def tt_tensor(rng, dims, ranks, dtype=np.float64):
    """A dense tensor of exact TT ranks, from random cores."""
    rs = [1] + list(ranks) + [1]
    cores = [rng.standard_normal((rs[k], dims[k], rs[k + 1]))
             for k in range(len(dims))]
    t = cores[0]
    for g in cores[1:]:
        t = np.tensordot(t, g, axes=([-1], [0]))
    return t.reshape(dims).astype(dtype)


def cp_tensor(rng, dims, rank, dtype=np.float64):
    factors = [rng.standard_normal((n, rank)) for n in dims]
    t = np.einsum("ir,jr,kr->ijk", *factors) if len(dims) == 3 else \
        np.einsum("ir,jr,kr,lr->ijkl", *factors)
    return t.astype(dtype)


def rel(got, want):
    want = np.asarray(want)
    return float(np.linalg.norm(np.asarray(got) - want)
                 / max(np.linalg.norm(want), 1e-300))


# -- tensor train ----------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_tt_svd_matches_jax_and_recovers(same_sketch, rng, dtype):
    t = tt_tensor(rng, (6, 5, 7, 4), (3, 4, 2), dtype)
    cj = jax_tt.tt_svd(jnp.asarray(t), (3, 4, 2), key=3)
    cp_ = port_tt.tt_svd(t, (3, 4, 2), key=3)
    assert [tuple(g.shape) for g in cp_] == [tuple(g.shape) for g in cj]
    rec_j = np.asarray(jax_tt.tt_reconstruct(cj))
    rec_p = port_tt.tt_reconstruct(cp_).numpy()
    assert rel(rec_p, rec_j) <= TOL[dtype]
    assert rel(rec_p, t) <= (1e-10 if dtype == np.float64 else 1e-4)
    # cores agree up to the sign of each bond: compare |G| entrywise
    for gj, gp in zip(cj, cp_):
        np.testing.assert_allclose(np.abs(gp.numpy()), np.abs(np.asarray(gj)),
                                   atol=TOL[dtype] * np.abs(gj).max() * 10)


def test_tt_large_unfolding_takes_the_randomized_svd(same_sketch, rng):
    # 64 x 4096 unfolding (2^18 elements) at rank 3: the randomized path,
    # which draws from the split key as the JAX package does
    t = tt_tensor(rng, (64, 64, 64), (3, 3))
    cj = jax_tt.tt_svd(jnp.asarray(t), (3, 3), key=5)
    cp_ = port_tt.tt_svd(t, (3, 3), key=5)
    rec_j = np.asarray(jax_tt.tt_reconstruct(cj))
    rec_p = port_tt.tt_reconstruct(cp_).numpy()
    assert rel(rec_p, rec_j) <= 1e-10
    assert rel(rec_p, t) <= 1e-9


def test_tt_round_dot_norm_match_jax(same_sketch, rng):
    t = tt_tensor(rng, (5, 6, 4, 5), (2, 3, 2))
    # an over-ranked train of the same tensor, then rounded back
    big_j = jax_tt.tt_svd(jnp.asarray(t), (5, 12, 5), key=1)
    big_p = port_tt.tt_svd(t, (5, 12, 5), key=1)
    rj = jax_tt.tt_round(big_j, (2, 3, 2), key=2)
    rp = port_tt.tt_round(big_p, (2, 3, 2), key=2)
    assert [tuple(g.shape) for g in rp] == [tuple(g.shape) for g in rj]
    rec = port_tt.tt_reconstruct(rp).numpy()
    assert rel(rec, np.asarray(jax_tt.tt_reconstruct(rj))) <= 1e-10
    assert rel(rec, t) <= 1e-9
    other = tt_tensor(rng, (5, 6, 4, 5), (3, 2, 2))
    oj = jax_tt.tt_svd(jnp.asarray(other), (3, 2, 2))
    op = port_tt.tt_svd(other, (3, 2, 2))
    dot_p = float(port_tt.tt_dot(rp, op))
    np.testing.assert_allclose(dot_p, float(jax_tt.tt_dot(rj, oj)),
                               rtol=1e-10)
    np.testing.assert_allclose(dot_p, np.sum(t * other), rtol=1e-9)
    np.testing.assert_allclose(float(port_tt.tt_norm(rp)),
                               float(jax_tt.tt_norm(rj)), rtol=1e-10)
    # cores carried across from the JAX package contract the same
    carried = from_jax_state("tt_cores", {"cores": [np.asarray(g)
                                                    for g in rj]})
    assert rel(port_tt.tt_reconstruct(carried).numpy(), t) <= 1e-9


def test_tt_validation(cpu_device, rng):
    t = rng.standard_normal((4, 5, 6))
    with pytest.raises(ValueError, match=">= 2 axes"):
        port_tt.tt_svd(np.ones(5), ())
    with pytest.raises(ValueError, match="ranks must have 2 entries"):
        port_tt.tt_svd(t, (2,))
    with pytest.raises(ValueError, match="ranks must be >= 1"):
        port_tt.tt_svd(t, (2, 0))
    cores = port_tt.tt_svd(t, (2, 2))
    with pytest.raises(ValueError, match="ranks must have 2 entries"):
        port_tt.tt_round(cores, (2,))
    with pytest.raises(ValueError, match="differ in length"):
        port_tt.tt_dot(cores, cores[:2])
    with pytest.raises(ValueError, match="mode dims differ"):
        port_tt.tt_dot(cores, port_tt.tt_svd(
            rng.standard_normal((4, 6, 6)), (2, 2)))


# -- CP ----------------------------------------------------------------------

def cp_terms(weights, factors):
    """The rank-one terms as an (R, prod dims) matrix: free of the signs
    that CP leaves open between the factors of one term."""
    w = np.asarray(weights)
    fs = [np.asarray(f) for f in factors]
    out = []
    for r in range(w.shape[0]):
        term = w[r] * fs[0][:, r]
        for f in fs[1:]:
            term = np.multiply.outer(term, f[:, r])
        out.append(term.ravel())
    return np.stack(out)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("init", ["svd", "random"])
def test_cp_als_matches_jax(same_sketch, rng, init, dtype):
    t = cp_tensor(rng, (9, 8, 7), 3, dtype)
    wj, fj, fits_j = jax_cp.cp_als(jnp.asarray(t), 3, n_sweeps=15, key=4,
                                   init=init)
    wp, fp, fits_p = port_cp.cp_als(t, 3, n_sweeps=15, key=4, init=init)
    tol = TOL[dtype] * (1 if dtype == np.float64 else 50)
    np.testing.assert_allclose(fits_p.numpy(), np.asarray(fits_j), atol=tol)
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), rtol=tol * 10)
    tj, tp = cp_terms(wj, fj), cp_terms(wp, [f.numpy() for f in fp])
    assert rel(tp, tj) <= tol * 100
    rec = port_cp.cp_reconstruct(wp, fp).numpy()
    assert rel(rec, np.asarray(jax_cp.cp_reconstruct(wj, fj))) <= tol * 10


def test_cp_recovers_and_pads_narrow_modes(same_sketch, rng):
    # mode 0 has 2 rows < rank 3: the svd init pads it with a draw from
    # the folded key, as the JAX package does
    t = cp_tensor(rng, (2, 9, 8, 7), 3)
    wj, fj, fits_j = jax_cp.cp_als(jnp.asarray(t), 3, n_sweeps=10, key=2)
    wp, fp, fits_p = port_cp.cp_als(t, 3, n_sweeps=10, key=2)
    np.testing.assert_allclose(fits_p.numpy(), np.asarray(fits_j), atol=1e-9)
    t3 = cp_tensor(rng, (9, 8, 7), 3)
    wp, fp, fits = port_cp.cp_als(t3, 3, n_sweeps=60, key=0)
    assert rel(port_cp.cp_reconstruct(wp, fp).numpy(), t3) < 1e-7
    assert np.all(np.diff(wp.numpy()) <= 1e-12)
    np.testing.assert_allclose(
        [np.linalg.norm(f.numpy(), axis=0) for f in fp], 1.0, atol=1e-12)
    # factors carried across from the JAX package reconstruct the same
    w_c, f_c = from_jax_state("cp_factors", {
        "weights": np.asarray(wj), "factors": [np.asarray(f) for f in fj]})
    assert rel(port_cp.cp_reconstruct(w_c, f_c).numpy(),
               np.asarray(jax_cp.cp_reconstruct(wj, fj))) <= 1e-12


def test_cp_validation_and_degenerate_inputs(cpu_device, rng):
    t = rng.standard_normal((4, 5, 6))
    with pytest.raises(ValueError, match=">= 2-way"):
        port_cp.cp_als(np.ones(4), 2)
    with pytest.raises(ValueError, match="rank must be >= 1"):
        port_cp.cp_als(t, 0)
    with pytest.raises(ValueError, match="init must be"):
        port_cp.cp_als(t, 2, init="zeros")
    with pytest.raises(TypeError, match="DeviceMesh"):
        port_cp.cp_als(t, 2, mesh=object())
    w, f, fits = port_cp.cp_als(np.zeros((3, 4, 5)), 2, n_sweeps=4)
    assert float(w.abs().sum()) == 0.0 and fits.tolist() == [1.0] * 4
    assert [tuple(x.shape) for x in f] == [(3, 2), (4, 2), (5, 2)]


# -- NMF ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nmf_matches_jax(same_sketch, rng, dtype):
    x = (rng.random((40, 4)) @ rng.random((4, 30))).astype(dtype)
    wj, hj, ej = jax_nmf.nmf(jnp.asarray(x), 4, n_sweeps=25, key=6)
    wp, hp, ep = port_nmf.nmf(x, 4, n_sweeps=25, key=6)
    tol = TOL[dtype] * (1 if dtype == np.float64 else 10)
    # the init's singular vectors may differ in sign between the LAPACKs;
    # NNDSVD takes the dominant signed part, which is sign-free
    np.testing.assert_allclose(ep.numpy(), np.asarray(ej), atol=tol)
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj),
                               atol=tol * 10 * np.abs(wj).max())
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj),
                               atol=tol * 10 * np.abs(hj).max())
    assert float(wp.min()) >= 0.0 and float(hp.min()) >= 0.0
    assert wp.dtype == hp.dtype == ep.dtype == torch.from_numpy(x).dtype


def test_nmf_recovers_planted_factors_and_validates(cpu_device, rng):
    # test_nmf.py's planted problem and budget: HALS converges linearly
    x = rng.random((60, 4)) @ rng.random((4, 45))
    w, h, errs = port_nmf.nmf(x, 4, n_sweeps=2000, key=0)
    assert float(errs[-1]) < 1e-4
    assert np.all(np.diff(errs.numpy()) <= 1e-10)
    with pytest.raises(ValueError, match="2-d"):
        port_nmf.nmf(np.ones((2, 2, 2)), 1)
    with pytest.raises(ValueError, match="nonnegative"):
        port_nmf.nmf(-x, 2)
    with pytest.raises(ValueError, match="rank must be in"):
        port_nmf.nmf(x, 46)
    with pytest.raises(TypeError, match="DeviceMesh"):
        port_nmf.nmf(x, 2, mesh=object())


# -- matrix completion -------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_matrix_complete_matches_jax(same_sketch, rng, dtype):
    truth = rng.standard_normal((50, 3)) @ rng.standard_normal((3, 40))
    mask = rng.random((50, 40)) < 0.5
    data = np.where(mask, truth, 99.0).astype(dtype)
    mj, uj, vj, hj = jax_mc.matrix_complete(jnp.asarray(data),
                                            jnp.asarray(mask), 3,
                                            n_sweeps=12, key=8)
    mp, up, vp, hp = port_mc.matrix_complete(data, mask, 3, n_sweeps=12,
                                             key=8)
    tol = TOL[dtype] * (1 if dtype == np.float64 else 50)
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj),
                               atol=tol * max(float(hj[0]), 1.0))
    assert rel(mp.numpy(), mj) <= tol * 10
    assert tuple(up.shape) == (50, 3) and tuple(vp.shape) == (40, 3)


def test_matrix_complete_recovers_heldout_and_validates(cpu_device, rng):
    truth = rng.standard_normal((60, 3)) @ rng.standard_normal((3, 50))
    mask = rng.random((60, 50)) < 0.5
    data = np.where(mask, truth, np.nan)
    # noise-free data: the ridge at its floor, as test_completion.py has it
    m_hat, _, _, hist = port_mc.matrix_complete(data, mask, 3, n_sweeps=40,
                                                lam=1e-10)
    held = ~mask
    err = (np.linalg.norm((m_hat.numpy() - truth)[held])
           / np.linalg.norm(truth[held]))
    assert err < 1e-6 and float(hist[-1]) < 1e-8
    ints = np.round(truth * 3).astype(np.int64)
    assert port_mc.matrix_complete(ints, mask, 3, n_sweeps=2)[0].dtype \
        == torch.float64
    with pytest.raises(ValueError, match="2-d"):
        port_mc.matrix_complete(np.ones(4), np.ones(4), 1)
    with pytest.raises(ValueError, match="mask shape"):
        port_mc.matrix_complete(truth, mask[:, :-1], 2)
    with pytest.raises(ValueError, match="rank must be in"):
        port_mc.matrix_complete(truth, mask, 0)
    with pytest.raises(ValueError, match="no observed entries"):
        port_mc.matrix_complete(truth, np.zeros_like(mask), 2)
    with pytest.raises(TypeError, match="DeviceMesh"):
        port_mc.matrix_complete(truth, mask, 2, mesh=object())
