"""Port parity: ops/eig_device (Francis QR, complex-free) against the JAX package.

Mirrors tests/test_eig_device.py: each test runs the same numpy input
through both packages. Eigenvalues are held to numpy and to JAX at the JAX
tests' tolerances (1e-11 of the largest, 5e-2 for the defective jordan10);
eigenvectors of distinct eigenvalues to JAX's to 1e-10 (both fix each
vector's phase by the same rule), eigenvectors of a cluster by the
projector onto their span. The Schur factors are held by their invariants
and by the deflation pattern (which subdiagonals are nonzero): the sweeps
are the same, but a 2x2 block's rotation within its plane is set by the
rounding of its last sweeps, which differs between LAPACK-free torch and
XLA (ROADMAP, Differences by design). The JAX results of the fixtures are
computed once for the module.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from corrla_rs_tpu.ops import eig_device as jax_eig
from corrla_rs_tpu_torch.ops import eig as port_eig_mod
from corrla_rs_tpu_torch.ops.eig_device import (
    eig_device,
    eigvals_device,
    hessenberg,
    schur,
)

torch.set_num_threads(1)

FIXTURES = ["randn12", "diag8", "rotations16", "jordan10", "repeated12",
            "scaled", "tiny2", "one1"]


def _fixtures():
    rng = np.random.default_rng(0)
    ths = rng.uniform(0.1, 3.0, 8)
    rs = rng.uniform(0.5, 2.0, 8)
    blocks = [r * np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
              for t, r in zip(ths, rs)]
    qq, _ = np.linalg.qr(rng.standard_normal((16, 16)))
    return {
        "randn12": rng.standard_normal((12, 12)),
        "diag8": np.diag(np.arange(1.0, 9.0)),
        "rotations16": qq @ sla.block_diag(*blocks) @ qq.T,
        "jordan10": np.eye(10) * 2.0 + np.diag(np.ones(9), 1),
        "repeated12": np.kron(np.eye(4), rng.standard_normal((3, 3))),
        "scaled": 1e6 * rng.standard_normal((9, 9)),
        "tiny2": rng.standard_normal((2, 2)),
        "one1": rng.standard_normal((1, 1)),
    }


@pytest.fixture(scope="module")
def fixtures():
    """name -> (matrix, JAX schur (t, q, ok), JAX eig_device)."""
    out = {}
    for name, a in _fixtures().items():
        ja = jnp.asarray(a)
        out[name] = (a, tuple(np.asarray(v) for v in jax_eig.schur(ja)),
                     tuple(np.asarray(v) for v in jax_eig.eig_device(ja)))
    return out


def _t(a):
    return torch.as_tensor(np.array(a))


def _complex(re, im):
    re, im = (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
              for v in (re, im))
    return re + 1j * im


def _sorted(re, im):
    return np.sort_complex(_complex(re, im))


def _projector(v):
    """Orthogonal projector onto the span of v's columns."""
    q, _ = np.linalg.qr(v)
    return q @ q.conj().T


def test_hessenberg_properties_and_jax(rng):
    a = rng.standard_normal((15, 15))
    h, q = (v.numpy() for v in hessenberg(_t(a)))
    assert np.max(np.abs(np.tril(h, -2))) == 0.0
    np.testing.assert_allclose(q.T @ q, np.eye(15), atol=1e-13)
    np.testing.assert_allclose(q @ h @ q.T, a, atol=1e-12)
    # the same reflectors in the same order as JAX
    hj, qj = (np.asarray(v) for v in jax_eig.hessenberg(jnp.asarray(a)))
    np.testing.assert_allclose(h, hj, atol=1e-12)
    np.testing.assert_allclose(q, qj, atol=1e-12)


@pytest.mark.parametrize("name", FIXTURES)
def test_schur_properties(fixtures, name):
    a, (tj, _qj, okj), _ = fixtures[name]
    n = a.shape[0]
    t, q, ok = schur(_t(a))
    t, q = t.numpy(), q.numpy()
    scale = max(np.max(np.abs(a)), 1.0)
    assert bool(ok) and bool(okj)
    np.testing.assert_allclose(q.T @ q, np.eye(n), atol=1e-12)
    np.testing.assert_allclose(q @ t @ q.T, a, atol=1e-12 * scale)
    if n > 2:
        assert np.max(np.abs(np.tril(t, -2))) == 0.0
        # the same deflations as JAX: the same 1x1 and 2x2 blocks
        np.testing.assert_array_equal(np.diagonal(t, -1) != 0,
                                      np.diagonal(tj, -1) != 0)


@pytest.mark.parametrize("name", FIXTURES)
def test_eigvals_match_numpy_and_jax(fixtures, name):
    a, _, (lrj, lij, _, _) = fixtures[name]
    lam = _sorted(*eigvals_device(_t(a)))
    ref = np.sort_complex(np.linalg.eigvals(a))
    scale = max(np.max(np.abs(ref)), 1e-30)
    # jordan10's eigenvalue is defective (condition ~eps^(-9/10)): numpy
    # agrees only to that intrinsic limit
    tol = 5e-2 if name == "jordan10" else 1e-11
    np.testing.assert_allclose(lam / scale, ref / scale, atol=tol)
    np.testing.assert_allclose(lam / scale, _sorted(lrj, lij) / scale,
                               atol=tol)


@pytest.mark.parametrize("name", FIXTURES)
def test_eigenvectors_satisfy_eigen_equation(fixtures, name):
    a, _, (lrj, lij, vrj, vij) = fixtures[name]
    lr, li, vr, vi = eig_device(_t(a))
    lam, v = _complex(lr, li), _complex(vr, vi)
    scale = max(np.max(np.abs(a)), 1.0)
    resid = np.max(np.abs(a @ v - v * lam[None, :]))
    assert resid < 1e-11 * scale, resid
    np.testing.assert_allclose(np.linalg.norm(v, axis=0), np.ones(len(lam)),
                               atol=1e-12)
    # JAX's vectors where the eigenvalue is simple and well separated (the
    # clusters are compared by their span in the cluster tests below)
    lamj, vj = _complex(lrj, lij), _complex(vrj, vij)
    np.testing.assert_allclose(lam, lamj, atol=1e-11 * scale)
    gap = np.where(np.eye(len(lam), dtype=bool), np.inf,
                   np.abs(lam[:, None] - lam[None, :]))
    distinct = gap.min(1) > 1e-3 * scale
    np.testing.assert_allclose(v[:, distinct], vj[:, distinct], atol=1e-10)


def test_eig_device_real_eigenvectors_are_real(rng):
    # symmetric: every eigenvalue real, so the vectors have no imaginary part
    a = rng.standard_normal((9, 9))
    a = a + a.T
    lr, li, vr, vi = eig_device(_t(a))
    assert float(li.abs().max()) == 0.0
    assert float(vi.abs().max()) == 0.0
    _, _, vrj, _ = jax_eig.eig_device(jnp.asarray(a))
    np.testing.assert_allclose(vr.numpy(), np.asarray(vrj), atol=1e-10)


def test_batched_stack_equals_per_matrix(rng):
    # a (B, n, n) stack gives what each matrix gives on its own (JAX vmaps)
    b = rng.standard_normal((3, 7, 7))
    lr, li = eigvals_device(_t(b))
    assert lr.shape == (3, 7)
    lr2, li2, vr, vi = eig_device(_t(b))
    assert vr.shape == (3, 7, 7)
    t, q, ok = schur(_t(b))
    assert t.shape == (3, 7, 7) and ok.shape == (3,) and bool(ok.all())
    jl = jax_eig.eigvals_device(jnp.asarray(b))
    for i in range(3):
        one = eig_device(_t(b[i]))
        for got, want in zip((lr2, li2, vr, vi), one):
            np.testing.assert_allclose(got[i].numpy(), want.numpy(),
                                       atol=1e-13)
        ti, qi, _ = schur(_t(b[i]))
        np.testing.assert_allclose(t[i].numpy(), ti.numpy(), atol=1e-13)
        np.testing.assert_allclose(q[i].numpy(), qi.numpy(), atol=1e-13)
        ref = np.sort_complex(np.linalg.eigvals(b[i]))
        np.testing.assert_allclose(_sorted(lr[i], li[i]), ref, atol=1e-11)
        np.testing.assert_allclose(_sorted(lr[i], li[i]),
                                   _sorted(jl[0][i], jl[1][i]), atol=1e-11)


def test_schur_reports_convergence_flag(rng):
    a = _t(rng.standard_normal((12, 12)))
    _t_, _q, ok = schur(a, max_iters=1)   # 1 round cannot deflate 12 eigs
    assert not bool(ok)
    _t_, _q, ok = schur(a)
    assert bool(ok)
    # a matrix of a stack that runs out of rounds leaves the others alone: a
    # diagonal matrix needs one round a deflation, 11 for n = 12
    b = torch.stack([torch.diag(torch.arange(1.0, 13.0, dtype=a.dtype)), a])
    t, _q, ok = schur(b, max_iters=11)
    assert ok.tolist() == [True, False]
    np.testing.assert_array_equal(t[0].numpy(), b[0].numpy())


def test_balancing_recovers_graded_matrix(rng):
    # D A D^-1 with 12 orders of magnitude of grading: exact power-of-two
    # balancing recovers machine precision, as in JAX (LAPACK xGEEV)
    n = 12
    base = rng.standard_normal((n, n))
    d = 10.0 ** np.linspace(-6, 6, n)
    graded = (d[:, None] * base) / d[None, :]
    ref = np.sort_complex(np.linalg.eigvals(base))
    err_raw = np.abs(_sorted(*eigvals_device(_t(graded), balance=False))
                     - ref).max() / np.abs(ref).max()
    lam = _sorted(*eigvals_device(_t(graded), balance=True))
    err_bal = np.abs(lam - ref).max() / np.abs(ref).max()
    assert err_bal < 1e-11
    assert err_bal < err_raw * 1e-6
    jl = jax_eig.eigvals_device(jnp.asarray(graded))
    np.testing.assert_allclose(lam / np.abs(ref).max(),
                               _sorted(*jl) / np.abs(ref).max(), atol=1e-11)
    lr, li, vr, vi = eig_device(_t(graded))
    lam, v = _complex(lr, li), _complex(vr, vi)
    resid = np.abs(graded @ v - v * lam[None, :]).max()
    assert resid < 1e-9 * np.abs(graded).max()


def test_non_convergence_poisons_with_nan(rng):
    a = _t(rng.standard_normal((12, 12)))
    lr, li = eigvals_device(a, max_iters=1)
    assert bool(torch.isnan(lr).all()) and bool(torch.isnan(li).all())
    lr, li = eigvals_device(a)
    assert bool(torch.isfinite(lr).all())


@pytest.mark.parametrize("mult", [2, 3])
@pytest.mark.parametrize("trial", [0, 1, 2])
def test_eig_device_clustered_eigenvalues_orthonormal(mult, trial):
    # a multiplicity-m eigenvalue gets an orthonormal eigenbasis, the span
    # of JAX's
    rng = np.random.default_rng(100 + trial)
    n = 10
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    vals = np.concatenate([np.full(mult, 2.0), np.linspace(1.0, 0.2, n - mult)])
    a = (q * vals) @ q.T
    lr, li, vr, vi = eig_device(_t(a))
    lam, v = _complex(lr, li), _complex(vr, vi)
    assert np.abs(a @ v - v * lam[None, :]).max() < 1e-8
    members = np.where(np.abs(lam - 2.0) < 1e-6)[0]
    assert len(members) == mult
    assert np.linalg.svd(v[:, members], compute_uv=False)[-1] > 0.9
    overlap = np.linalg.svd(q[:, :mult].T @ v[:, members], compute_uv=False)
    assert overlap[-1] > 1 - 1e-8
    lrj, lij, vrj, vij = jax_eig.eig_device(jnp.asarray(a))
    lamj, vj = _complex(lrj, lij), _complex(vrj, vij)
    mj = np.where(np.abs(lamj - 2.0) < 1e-6)[0]
    np.testing.assert_allclose(_projector(v[:, members]),
                               _projector(vj[:, mj]), atol=1e-8)


def test_eig_device_clustered_nonsymmetric():
    # a diagonalizable non-normal matrix with a double eigenvalue
    rng = np.random.default_rng(7)
    n = 8
    s = rng.standard_normal((n, n)) + 3.0 * np.eye(n)
    vals = np.array([1.5, 1.5, 1.0, 0.7, 0.5, 0.3, 0.2, 0.1])
    a = s @ np.diag(vals) @ np.linalg.inv(s)
    lr, li, vr, vi = eig_device(_t(a))
    lam, v = _complex(lr, li), _complex(vr, vi)
    assert np.abs(a @ v - v * lam[None, :]).max() / np.abs(vals).max() < 1e-7
    members = np.where(np.abs(lam - 1.5) < 1e-6)[0]
    assert len(members) == 2
    assert np.linalg.svd(v[:, members], compute_uv=False)[-1] > 0.9
    wl, vl = np.linalg.eig(a)
    bl = np.linalg.qr(vl[:, np.where(np.abs(wl - 1.5) < 1e-8)[0]])[0]
    overlap = np.linalg.svd(bl.conj().T @ v[:, members], compute_uv=False)
    assert overlap[-1] > 1 - 1e-7
    lrj, lij, vrj, vij = jax_eig.eig_device(jnp.asarray(a))
    lamj, vj = _complex(lrj, lij), _complex(vrj, vij)
    mj = np.where(np.abs(lamj - 1.5) < 1e-6)[0]
    np.testing.assert_allclose(_projector(v[:, members]),
                               _projector(vj[:, mj]), atol=1e-7)


def test_eig_device_distinct_eigs_unaffected_by_orthogonalization():
    # well separated: the cluster mask is empty; LAPACK's eigenvalues, and
    # JAX's vectors under the shared phase rule
    rng = np.random.default_rng(3)
    a = rng.standard_normal((9, 9))
    lr, li, vr, vi = eig_device(_t(a))
    lam, v = _complex(lr, li), _complex(vr, vi)
    assert np.abs(a @ v - v * lam[None, :]).max() < 1e-9
    np.testing.assert_allclose(np.sort_complex(lam),
                               np.sort_complex(np.linalg.eigvals(a)),
                               atol=1e-9)
    lrj, lij, vrj, vij = jax_eig.eig_device(jnp.asarray(a))
    np.testing.assert_allclose(lam, _complex(lrj, lij), atol=1e-11)
    np.testing.assert_allclose(v, _complex(vrj, vij), atol=1e-10)


def test_f32_matches_numpy_and_jax(rng):
    a = rng.standard_normal((12, 12)).astype(np.float32)
    lr, li, vr, vi = eig_device(_t(a))
    assert lr.dtype == torch.float32 and vr.dtype == torch.float32
    lam, v = _complex(lr, li), _complex(vr, vi)
    ref = np.sort_complex(np.linalg.eigvals(a.astype(np.float64)))
    scale = np.abs(ref).max()
    assert np.abs(np.sort_complex(lam) - ref).max() <= 1e-4 * scale
    assert np.abs(a @ v - v * lam[None, :]).max() <= 1e-4 * scale
    jl = jax_eig.eigvals_device(jnp.asarray(a))
    assert np.abs(np.sort_complex(lam) - _sorted(*jl)).max() <= 1e-4 * scale


def test_ops_eig_reexports_and_jittable_probe():
    assert port_eig_mod.eig_device is eig_device
    assert port_eig_mod.eigvals_device is eigvals_device
    assert port_eig_mod.schur is schur
    # torch.linalg.eig gives complex results on both device types itself
    assert port_eig_mod.jittable_eig_supported("cpu")
    assert port_eig_mod.jittable_eig_supported("cuda")
    assert not port_eig_mod.jittable_eig_supported("meta")
    assert port_eig_mod.jittable_eig_supported() is True   # default: cuda
