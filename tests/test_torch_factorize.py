"""Port parity: the factorizations on the RSVD core (nystrom, rank_select,
trace_est, sketch_solve, cg, slq, id_cur, hosvd) against the JAX package.

Routines without random numbers are held to the JAX result on the same
input at 1e-9 (f64). Randomized ones draw the JAX package's sketches and
probes from its keys (``_torch_parity.same_sketch``) and are held to it at
the same 1e-9, and, on their own draws, to the exact answer at the tolerance
of the JAX package's own test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401 (fixtures)
    cpu_device,
    decaying,
    same_sketch,
    subspace_gap,
)
from corrla_rs_tpu.ops import cg as jax_cg
from corrla_rs_tpu.ops import hosvd as jax_hosvd
from corrla_rs_tpu.ops import id_cur as jax_id
from corrla_rs_tpu.ops import nystrom as jax_ny
from corrla_rs_tpu.ops import rank_select as jax_rank
from corrla_rs_tpu.ops import sketch_solve as jax_ls
from corrla_rs_tpu.ops import slq as jax_slq
from corrla_rs_tpu.ops import trace_est as jax_tr
from corrla_rs_tpu_torch.ops import cg as port_cg
from corrla_rs_tpu_torch.ops import hosvd as port_hosvd
from corrla_rs_tpu_torch.ops import id_cur as port_id
from corrla_rs_tpu_torch.ops import nystrom as port_ny
from corrla_rs_tpu_torch.ops import rank_select as port_rank
from corrla_rs_tpu_torch.ops import sketch_solve as port_ls
from corrla_rs_tpu_torch.ops import slq as port_slq
from corrla_rs_tpu_torch.ops import trace_est as port_tr

torch.set_num_threads(1)

TOL = 1e-9


def psd(rng, n, ev):
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q[:, :len(ev)] * ev) @ q[:, :len(ev)].T


def spd(rng, n, cond=20.0):
    return psd(rng, n, np.linspace(1.0, cond, n))


def low_rank(rng, m, n, r):
    return rng.standard_normal((m, r)) @ rng.standard_normal((r, n))


def tall(rng, m=600, n=24, cond=10.0):
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (u * np.logspace(0, -np.log10(cond), n)) @ v.T


# --- nystrom ---------------------------------------------------------------

def test_nystrom_matches_jax(same_sketch, rng):
    a = psd(rng, 80, 0.6 ** np.arange(40))
    lj, vj = jax_ny.nystrom_eigh(jnp.asarray(a), 8, key=2)
    lt, vt = port_ny.nystrom_eigh(torch.tensor(a), 8, key=2)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL)
    assert subspace_gap(vj, vt) <= TOL
    fj = np.asarray(jax_ny.nystrom_approx(jnp.asarray(a), 8, key=2))
    ft = port_ny.nystrom_approx(torch.tensor(a), 8, key=2).numpy()
    np.testing.assert_allclose(ft @ ft.T, fj @ fj.T, atol=TOL)


def test_nystrom_exact_on_low_rank_and_f32(cpu_device, rng):
    # test_nystrom.py::test_exact_on_lowrank_psd (1e-8) and
    # ::test_f32_stability_tiny_spectrum (finite, leading three at 1e-3)
    ev = np.array([9.0, 5.0, 3.0, 2.0, 1.0, 0.5])
    a = psd(rng, 70, ev)
    lam, vec = port_ny.nystrom_eigh(a, 6, n_oversamples=6, key=1)
    np.testing.assert_allclose(lam.numpy(), ev, rtol=1e-8)
    np.testing.assert_allclose((vec.mT @ vec).numpy(), np.eye(6), atol=1e-8)
    s = (0.1 ** np.arange(60)).astype(np.float32)
    lam, vec = port_ny.nystrom_eigh(psd(rng, 60, s).astype(np.float32), 5,
                                    key=3)
    assert lam.dtype == torch.float32
    assert bool(torch.isfinite(lam).all() and torch.isfinite(vec).all())
    np.testing.assert_allclose(lam[:3].numpy(), s[:3], rtol=1e-3)
    with pytest.raises(ValueError, match="square"):
        port_ny.nystrom_eigh(np.ones((4, 3)), 2)
    with pytest.raises(ValueError, match="rank"):
        port_ny.nystrom_eigh(np.eye(4), 5)


# --- rank_select -----------------------------------------------------------

def test_svht_and_select_rank_match_jax(rng):
    sigma = np.sort(rng.uniform(0.1, 30.0, 40))[::-1]
    for shape in ((300, 40), (40, 300), (64, 64)):
        for kw in ({"noise": 0.02}, {"sigma": sigma}):
            assert port_rank.svht_threshold(shape, **kw) == pytest.approx(
                jax_rank.svht_threshold(shape, **kw), rel=1e-14)
        for noise in (None, 0.5):
            assert port_rank.select_rank(
                torch.tensor(sigma.copy()), shape, noise=noise
            ) == jax_rank.select_rank(sigma, shape, noise=noise)
    with pytest.raises(ValueError, match="noise"):
        port_rank.svht_threshold((5, 4))


def test_range_error_and_adaptive_svd_match_jax(same_sketch, rng):
    a = low_rank(rng, 120, 50, 12) + 1e-3 * rng.standard_normal((120, 50))
    q, _ = np.linalg.qr(rng.standard_normal((120, 6)))
    ej = jax_rank.range_error_estimate(jnp.asarray(a), jnp.asarray(q), key=4)
    et = port_rank.range_error_estimate(torch.tensor(a), torch.tensor(q),
                                        key=4)
    assert isinstance(et, float) and et == pytest.approx(ej, rel=TOL)
    # a spectrum falling by 30% an index, stopped at rank 8 of 50: every
    # kept direction stands clear of rounding (past a matrix's numerical
    # rank the trailing vectors are rounding's, and differ by package)
    a = decaying(rng, (120, 50), np.float64, rate=0.7)
    uj, sj, vj, rj, errj = jax_rank.adaptive_random_svd(
        jnp.asarray(a), 3.0, rank0=2, key=6)
    ut, st, vt, rt, errt = port_rank.adaptive_random_svd(
        torch.tensor(a), 3.0, rank0=2, key=6)
    assert rt == rj == 8 and errt == pytest.approx(errj, rel=1e-7)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=TOL)


def test_adaptive_svd_meets_tolerance_on_own_draws(cpu_device, rng):
    # test_rank_select.py::test_adaptive_random_svd_meets_tolerance; a
    # generator as the key repeats its sketch at every rank
    a = torch.tensor(low_rank(rng, 150, 60, 10))
    u, s, vt, r, err = port_rank.adaptive_random_svd(
        a, 1e-6, rank0=2, key=torch.Generator().manual_seed(3))
    assert err <= 1e-6 and 10 <= r <= 40
    assert float(torch.linalg.matrix_norm((u * s) @ vt - a, 2)) < 1e-6
    _, _, _, r_cap, _ = port_rank.adaptive_random_svd(a, 1e-12, rank0=4,
                                                      max_rank=16)
    assert r_cap == 16
    with pytest.raises(ValueError, match="tol"):
        port_rank.adaptive_random_svd(a, 0.0)


# --- trace_est -------------------------------------------------------------

def test_traces_match_jax(same_sketch, rng):
    a = spd(rng, 90)
    assert port_tr.hutchinson_trace(torch.tensor(a), 32, key=1) == \
        pytest.approx(jax_tr.hutchinson_trace(jnp.asarray(a), 32, key=1),
                      rel=TOL)
    got = port_tr.hutchpp_trace(torch.tensor(a), 30, key=2)
    assert got == pytest.approx(
        jax_tr.hutchpp_trace(jnp.asarray(a), 30, key=2), rel=TOL)
    # a callable operator takes the same probes
    at = torch.tensor(a)
    fn = port_tr.hutchpp_trace(lambda blk: at @ blk, 30, key=2, n_dim=90,
                               dtype=torch.float64)
    assert fn == pytest.approx(got, rel=1e-12)


def test_traces_on_own_draws(cpu_device, rng):
    # test_trace_est.py: exact on low rank at 1e-10; Hutch++ within 1% of
    # the trace of a decaying PSD matrix
    low = psd(rng, 100, np.array([5.0, 3.0, 1.0]))
    assert port_tr.hutchpp_trace(low, 30, key=0) == pytest.approx(
        np.trace(low), rel=1e-10)
    a = psd(rng, 150, 1.0 / np.arange(1, 151) ** 2)
    errs = [abs(port_tr.hutchpp_trace(a, 60, key=k) - np.trace(a))
            for k in range(5)]
    assert np.mean(errs) < 0.01 * np.trace(a)
    x = port_tr._rademacher(3, (2000, 4), torch.float64, "cpu")
    assert set(x.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(x.mean())) < 0.05
    with pytest.raises(TypeError, match="explicit"):
        port_tr.hutchinson_trace(lambda b: b)
    with pytest.raises(ValueError, match="n_dim"):
        port_tr.hutchpp_trace(lambda b: b, 9)
    with pytest.raises(ValueError, match="n_probes"):
        port_tr.hutchpp_trace(a, 2)


# --- sketch_solve ----------------------------------------------------------

def test_sketched_lstsq_matches_numpy_where_jax_is_off(same_sketch, rng):
    # the JAX package's own case (test_sketch_solve.py::
    # test_matches_numpy_lstsq_well_conditioned), which it fails by keeping
    # the iterate of least residual norm: the port passes it at atol 1e-9
    a = tall(rng, 2000, 40)
    b = a @ rng.standard_normal(40) + 0.01 * rng.standard_normal(2000)
    x_ref = np.linalg.lstsq(a, b, rcond=None)[0]
    x, hist = port_ls.sketched_lstsq(torch.tensor(a), torch.tensor(b), key=1)
    np.testing.assert_allclose(x.numpy(), x_ref, atol=1e-9)
    assert float(hist[-1]) < 1e-10 * float(hist[0])
    # same sketch, same recurrence: the residual histories agree while
    # they are above rounding, and the JAX answer is the farther one
    xj, hj = jax_ls.sketched_lstsq(jnp.asarray(a), jnp.asarray(b), key=1)
    np.testing.assert_allclose(hist[:20].numpy(), np.asarray(hj)[:20],
                               rtol=1e-6)
    assert np.abs(x.numpy() - x_ref).max() <= np.abs(
        np.asarray(xj) - x_ref).max()


def test_sketched_lstsq_conditioning_and_many_rhs(cpu_device, rng):
    # test_sketch_solve.py::test_conditioning_independent_convergence and
    # ::test_multiple_rhs: residual within 1e-10 / 1e-9 of the optimum
    a = tall(rng, 1500, 30, cond=1e8)
    b = rng.standard_normal(1500)
    x, _ = port_ls.sketched_lstsq(a, b, key=2)
    r_ref = np.linalg.norm(a @ np.linalg.lstsq(a, b, rcond=None)[0] - b)
    assert np.linalg.norm(a @ x.numpy() - b) <= r_ref * (1 + 1e-10)
    a = tall(rng, 900, 24)
    bb = rng.standard_normal((900, 3))
    x, hist = port_ls.sketched_lstsq(a, bb, key=3)
    assert x.shape == (24, 3) and hist.shape == (3, 30)
    np.testing.assert_allclose(x.numpy(),
                               np.linalg.lstsq(a, bb, rcond=None)[0],
                               atol=1e-9)
    # each column alone gives what it gives in the block
    x0, h0 = port_ls.sketched_lstsq(a, bb[:, 0], key=3)
    np.testing.assert_allclose(x0.numpy(), x[:, 0].numpy(), atol=1e-12)
    assert h0.shape == (30,)
    with pytest.raises(ValueError, match="tall"):
        port_ls.sketched_lstsq(np.ones((3, 5)), np.ones(3))
    with pytest.raises(ValueError, match="sketch_factor"):
        port_ls.sketched_lstsq(a, bb, sketch_factor=1.0)
    with pytest.raises(ValueError, match="rows"):
        port_ls.sketched_lstsq(a, np.ones(5))
    with pytest.raises(TypeError, match="DeviceMesh"):
        port_ls.sketched_lstsq(a, bb, mesh=object())


# --- cg --------------------------------------------------------------------

@pytest.mark.parametrize("precond", [None, "jacobi", "nystrom"])
def test_cg_matches_jax(same_sketch, rng, precond):
    a = spd(rng, 60, cond=200.0) + np.diag(np.linspace(0.0, 5.0, 60))
    b = rng.standard_normal((60, 3))
    b[:, 1] *= 1e-3
    pj = pt = None
    if precond == "jacobi":
        pj = jax_cg.jacobi_preconditioner(jnp.asarray(a))
        pt = port_cg.jacobi_preconditioner(torch.tensor(a))
    elif precond == "nystrom":
        pj = jax_cg.nystrom_preconditioner(jnp.asarray(a), 10, 0.5, key=3)
        pt = port_cg.nystrom_preconditioner(torch.tensor(a), 10, 0.5, key=3)
    rj = jax_cg.cg_solve(jnp.asarray(a), jnp.asarray(b), n_iters=120,
                         tol=1e-10, preconditioner=pj)
    rt = port_cg.cg_solve(torch.tensor(a), torch.tensor(b), n_iters=120,
                          tol=1e-10, preconditioner=pt)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=TOL)
    # the history too, rows after the early stop included
    assert rt.residual_norms.shape == (121, 3)
    np.testing.assert_allclose(rt.residual_norms.numpy(),
                               np.asarray(rj.residual_norms), atol=TOL)
    assert rt.converged.tolist() == np.asarray(rj.converged).tolist()
    assert rt.n_iters == 120


def test_cg_vector_callable_x0_and_validation(cpu_device, rng):
    a = torch.tensor(spd(rng, 40))
    b = torch.tensor(rng.standard_normal(40))
    res = port_cg.cg_solve(a, b, n_iters=200, tol=1e-12)
    assert isinstance(res, port_cg.CgResult) and res.x.shape == (40,)
    assert bool(res.converged) and res.residual_norms.shape == (201, 1)
    np.testing.assert_allclose(res.x.numpy(),
                               np.linalg.solve(a.numpy(), b.numpy()),
                               atol=1e-9)
    free = port_cg.cg_solve(lambda blk: a @ blk, b, n_iters=200, tol=1e-12)
    np.testing.assert_allclose(free.x.numpy(), res.x.numpy(), rtol=1e-12)
    warm = port_cg.cg_solve(a, b, x0=res.x, n_iters=5, tol=1e-10)
    assert float(warm.residual_norms[0, 0]) < 1e-9
    # not converged inside the budget: says so
    short = port_cg.cg_solve(a, b, n_iters=2, tol=1e-14)
    assert not bool(short.converged)
    with pytest.raises(ValueError, match="n_iters"):
        port_cg.cg_solve(a, b, n_iters=0)
    with pytest.raises(ValueError, match="x0"):
        port_cg.cg_solve(a, b, x0=torch.zeros(3, dtype=torch.float64))


def test_cg_reads_the_device_only_every_few_iterations(cpu_device, rng,
                                                       monkeypatch):
    a = torch.tensor(spd(rng, 30, cond=3.0))
    b = torch.tensor(rng.standard_normal((30, 2)))
    calls = []
    real = a.__class__.__bool__
    monkeypatch.setattr(torch.Tensor, "__bool__",
                        lambda self: calls.append(1) or real(self))
    res = port_cg.cg_solve(a, b, n_iters=400, tol=1e-8)
    monkeypatch.undo()
    assert bool(res.converged.all())
    # converged after ~15 iterations, found at the next multiple of 8
    assert len(calls) <= 400 // port_cg._CHECK_EVERY
    assert len(calls) <= 4


# --- slq -------------------------------------------------------------------

def test_lanczos_matches_jax(cpu_device, rng):
    a = spd(rng, 50)
    v0, _ = np.linalg.qr(rng.standard_normal((50, 4)))
    aj, bj = jax_slq.lanczos_tridiag(jnp.asarray(a), jnp.asarray(v0), 12)
    at, bt = port_slq.lanczos_tridiag(torch.tensor(a), torch.tensor(v0), 12)
    assert at.shape == (12, 4) and bt.shape == (11, 4)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=TOL)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=TOL)
    b = rng.standard_normal((50, 2))
    for fj, ft in ((jnp.exp, torch.exp), (lambda x: 1 / jnp.sqrt(x),
                                          torch.rsqrt)):
        yj = jax_slq.lanczos_fn_apply(jnp.asarray(a / 10), jnp.asarray(b), fj,
                                      30)
        yt = port_slq.lanczos_fn_apply(torch.tensor(a / 10), torch.tensor(b),
                                       ft, 30)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=TOL)
    y1 = port_slq.lanczos_fn_apply(torch.tensor(a / 10),
                                   torch.tensor(b[:, 0]), torch.exp, 30)
    np.testing.assert_allclose(y1.numpy(), yt[:, 0].numpy() * 0 + y1.numpy())
    assert y1.shape == (50,)


def test_slq_matches_jax(same_sketch, rng):
    a = spd(rng, 80)
    got = port_slq.slq_logdet(torch.tensor(a), 8, 20, key=3)
    assert isinstance(got, float)
    assert got == pytest.approx(
        jax_slq.slq_logdet(jnp.asarray(a), 8, 20, key=3), rel=TOL)
    assert port_slq.slq_spectral_sum(
        torch.tensor(a), lambda x: 1.0 / x, 8, 20, key=4
    ) == pytest.approx(jax_slq.slq_spectral_sum(
        jnp.asarray(a), lambda x: 1.0 / x, 8, 20, key=4), rel=TOL)
    at = torch.tensor(a)
    assert port_slq.slq_logdet(lambda blk: at @ blk, 8, 20, key=3, n_dim=80,
                               dtype=torch.float64) == pytest.approx(
        got, rel=1e-12)


def test_slq_on_own_draws(cpu_device, rng):
    # test_slq.py::test_logdet_well_conditioned (2e-2) and
    # ::test_lanczos_exact_eigenvalues_small (1e-8)
    a = spd(rng, 200, cond=10.0)
    truth = np.linalg.slogdet(a)[1]
    assert port_slq.slq_logdet(a, 24, 40, key=0) == pytest.approx(truth,
                                                                  rel=2e-2)
    small = torch.tensor(spd(rng, 8))
    v0 = torch.tensor(rng.standard_normal((8, 1)))
    al, be = port_slq.lanczos_tridiag(small, v0 / v0.norm(), 8)
    t = torch.diag(al[:, 0]) + torch.diag(be[:, 0], 1) + torch.diag(
        be[:, 0], -1)
    np.testing.assert_allclose(torch.linalg.eigvalsh(t).numpy(),
                               np.linalg.eigvalsh(small.numpy()), rtol=1e-8)
    with pytest.raises(ValueError, match="n_probes"):
        port_slq.slq_logdet(a, 0)
    with pytest.raises(ValueError, match="n_lanczos"):
        port_slq.slq_logdet(a, 4, 1)
    with pytest.raises(ValueError, match="n_dim"):
        port_slq.slq_logdet(lambda b: b)
    with pytest.raises(ValueError, match="square"):
        port_slq.slq_logdet(np.ones((3, 4)))


# --- id_cur ----------------------------------------------------------------

def test_qrcp_matches_jax(cpu_device, rng):
    b = low_rank(rng, 14, 60, 9) + 1e-6 * rng.standard_normal((14, 60))
    pj, rj = jax_id._qrcp(jnp.asarray(b), 9)
    pt, rt = port_id._qrcp(torch.tensor(b), 9)
    assert pt.tolist() == np.asarray(pj).tolist() and pt.dtype == torch.int64
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=TOL)
    xj = jax_id._interp_from_r(rj, pj)
    xt = port_id._interp_from_r(rt, pt)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=TOL)
    assert torch.equal(xt[:, pt], torch.eye(9, dtype=torch.float64))


def test_qrcp_never_reads_the_device(cpu_device, rng, monkeypatch):
    # the pivot stays a tensor: no .item(), int() or bool() in the loop
    def boom(self, *a):
        raise AssertionError("read from the device inside _qrcp")

    for name in ("item", "__bool__", "__int__", "__index__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    piv, r = port_id._qrcp(torch.tensor(rng.standard_normal((6, 20))), 5)
    monkeypatch.undo()
    assert len(set(piv.tolist())) == 5 and r.shape == (5, 20)


@pytest.mark.parametrize("shape", [(90, 40), (40, 90)], ids=["tall", "wide"])
def test_id_and_cur_match_jax(same_sketch, rng, shape):
    a = low_rank(rng, *shape, 7) + 1e-4 * rng.standard_normal(shape)
    cj, xj = jax_id.column_id(jnp.asarray(a), 7, key=2)
    ct, xt = port_id.column_id(torch.tensor(a), 7, key=2)
    assert ct.tolist() == np.asarray(cj).tolist()
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=TOL)
    rj, zj = jax_id.row_id(jnp.asarray(a), 7, key=3)
    rt, zt = port_id.row_id(torch.tensor(a), 7, key=3)
    assert rt.tolist() == np.asarray(rj).tolist()
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=TOL)
    for method in ("stable", "skeleton"):
        rj, cj, uj = jax_id.cur(jnp.asarray(a), 7, key=4, method=method)
        rt, ct, ut = port_id.cur(torch.tensor(a), 7, key=4, method=method)
        assert rt.tolist() == np.asarray(rj).tolist()
        assert ct.tolist() == np.asarray(cj).tolist()
        # U is held as the approximant it gives: the skeleton block is
        # ill-conditioned under the 1e-4 noise
        approx_j = a[:, np.asarray(cj)] @ np.asarray(uj) @ a[np.asarray(rj)]
        approx_t = a[:, ct.numpy()] @ ut.numpy() @ a[rt.numpy()]
        np.testing.assert_allclose(approx_t, approx_j, atol=1e-7)


def test_id_and_cur_exact_on_low_rank_and_f32(cpu_device, rng):
    # test_id_cur.py: exact on low rank (1e-9 / 1e-8), f32 at 1e-4
    a = low_rank(rng, 80, 50, 6)
    cols, x = port_id.column_id(a, 6, key=0)
    assert len(set(cols.tolist())) == 6
    assert np.linalg.norm(a[:, cols.numpy()] @ x.numpy() - a) < 1e-9 * \
        np.linalg.norm(a)
    rows, cols, u = port_id.cur(a, 6, key=1, method="skeleton")
    approx = a[:, cols.numpy()] @ u.numpy() @ a[rows.numpy()]
    assert np.linalg.norm(approx - a) / np.linalg.norm(a) < 1e-8
    a32 = low_rank(rng, 60, 120, 5).astype(np.float32)
    cols, x = port_id.column_id(a32, 5, key=2)
    assert x.dtype == torch.float32
    assert np.linalg.norm(a32[:, cols.numpy()] @ x.numpy() - a32) < 1e-4 * \
        np.linalg.norm(a32)
    with pytest.raises(ValueError, match="rank"):
        port_id.column_id(a, 0)
    with pytest.raises(ValueError, match="method"):
        port_id.cur(a, 3, method="fast")


# --- hosvd -----------------------------------------------------------------

def tucker(rng, dims, ranks):
    t = rng.standard_normal(ranks)
    for k, (d, r) in enumerate(zip(dims, ranks)):
        t = np.moveaxis(np.tensordot(rng.standard_normal((d, r)), t,
                                     axes=(1, k)), 0, k)
    return t


def test_mode_multiply_and_reconstruct_match_jax(cpu_device, rng):
    t = rng.standard_normal((5, 6, 7))
    for mode, rows in ((0, 4), (1, 3), (2, 9)):
        m = rng.standard_normal((rows, t.shape[mode]))
        got = port_hosvd.mode_multiply(torch.tensor(t), torch.tensor(m), mode)
        want = jax_hosvd.mode_multiply(jnp.asarray(t), jnp.asarray(m), mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    factors = [rng.standard_normal((d, r)) for d, r in ((8, 5), (9, 6),
                                                        (4, 7))]
    got = port_hosvd.tucker_reconstruct(torch.tensor(t),
                                        [torch.tensor(f) for f in factors])
    want = jax_hosvd.tucker_reconstruct(jnp.asarray(t),
                                        [jnp.asarray(f) for f in factors])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("fn", ["hosvd", "hooi"])
def test_hosvd_and_hooi_match_jax(same_sketch, rng, fn):
    x = tucker(rng, (12, 10, 9), (3, 4, 2)) + 1e-3 * rng.standard_normal(
        (12, 10, 9))
    cj, fj = getattr(jax_hosvd, fn)(jnp.asarray(x), (3, 4, 2), key=5)
    ct, ft = getattr(port_hosvd, fn)(torch.tensor(x), (3, 4, 2), key=5)
    assert ct.shape == (3, 4, 2)
    for uj, ut in zip(fj, ft):
        assert subspace_gap(uj, ut) <= TOL
    # the core's signs follow the factors'; its reconstruction is sign-free
    np.testing.assert_allclose(
        port_hosvd.tucker_reconstruct(ct, ft).numpy(),
        np.asarray(jax_hosvd.tucker_reconstruct(cj, fj)), atol=TOL)


def test_hosvd_exact_recovery_and_validation(cpu_device, rng):
    # test_hosvd.py::test_exact_recovery_low_multilinear_rank (1e-9)
    x = tucker(rng, (10, 8, 6, 5), (2, 3, 2, 2))
    core, factors = port_hosvd.hosvd(x, (2, 3, 2, 2), key=1)
    for u, r in zip(factors, (2, 3, 2, 2)):
        np.testing.assert_allclose((u.mT @ u).numpy(), np.eye(r), atol=1e-10)
    np.testing.assert_allclose(
        port_hosvd.tucker_reconstruct(core, factors).numpy(), x, atol=1e-9)
    noisy = x + 0.05 * rng.standard_normal(x.shape)
    errs = []
    for fn in (port_hosvd.hosvd, port_hosvd.hooi):
        c, f = fn(noisy, (2, 3, 2, 2), key=2)
        errs.append(np.linalg.norm(
            port_hosvd.tucker_reconstruct(c, f).numpy() - noisy))
    assert errs[1] <= errs[0] * (1 + 1e-9)
    with pytest.raises(ValueError, match="one entry per"):
        port_hosvd.hosvd(x, (2, 2))
    with pytest.raises(ValueError, match="must be in"):
        port_hosvd.hosvd(x, (11, 3, 2, 2))
    with pytest.raises(ValueError, match="exceeds prod"):
        port_hosvd.hooi(rng.standard_normal((8, 4, 4)), (8, 2, 2))
