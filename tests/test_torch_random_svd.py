"""Port parity: random_svd / power_iter / _cholesky_qr2 against the JAX package.

Both packages draw the same sketch (``_torch_parity.same_sketch``), so the
only differences left are rounding: LAPACK's QR/SVD/Cholesky in both, summed
in other orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401 (fixtures)
    EPS,
    cpu_device,
    decaying,
    same_sketch,
    subspace_gap,
)
from corrla_rs_tpu.ops import random_svd as jax_rsvd
from corrla_rs_tpu_torch.ops import random_svd as port_rsvd

torch.set_num_threads(1)

# (dtype, stabilize, sigma rtol, U/V subspace gap). f64: the reference path
# (householder, QR skipped for i <= 2) agrees to rounding, 1e-10 leaves four
# orders of margin over the 1e-15 measured. f32: the always/cholesky path;
# sigma of a 0.8**j spectrum agree to ~1e-6 measured, 1e-5 stated.
CASES = [
    (np.float64, "auto", 1e-10, 1e-8),
    (np.float32, "auto", 1e-5, 1e-4),
    (np.float64, "always", 1e-10, 1e-8),   # cholesky QR in f64
]


@pytest.mark.parametrize("shape", [(120, 40), (40, 120)],
                         ids=["tall", "fat"])
@pytest.mark.parametrize("dtype,stabilize,rtol,gap", CASES,
                         ids=["f64-auto", "f32-auto", "f64-always"])
def test_random_svd_matches_jax(same_sketch, rng, shape, dtype, stabilize,
                                rtol, gap):
    a = decaying(rng, shape, dtype)
    uj, sj, vj = jax_rsvd.random_svd(jnp.asarray(a), 8, 6, 5, key=3,
                                     stabilize=stabilize)
    ut, st, vt = port_rsvd.random_svd(torch.as_tensor(a), 8, 6, 5, key=3,
                                      stabilize=stabilize)
    assert ut.shape == (shape[0], 8) and vt.shape == (8, shape[1])
    assert st.dtype == torch.float32 if dtype == np.float32 else torch.float64
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=rtol)
    assert subspace_gap(uj, ut) <= gap
    assert subspace_gap(np.asarray(vj).T, vt.numpy().T) <= gap


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_power_iter_matches_jax(same_sketch, rng, dtype):
    # the range projector Q Q^T is sign-free. It is set to eps * cond(Y)
    # of the last panel: in f64 (no QR for i <= 2) cond(Y) is about
    # (s_1/s_10)**(2q+1) = 0.9**-81 ~ 5e3, so 1e-10; in f32 the in-loop
    # cholesky QR keeps Y orthonormal and 1e-5 covers f32 rounding
    a = decaying(rng, (90, 30), dtype, rate=0.9)
    qj = np.asarray(jax_rsvd.power_iter(jnp.asarray(a), 10, 4, key=7))
    qt = port_rsvd.power_iter(torch.as_tensor(a), 10, 4, key=7).numpy()
    tol = 1e-10 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(qt @ qt.T, qj @ qj.T, atol=tol)
    np.testing.assert_allclose(qt.T @ qt, np.eye(10), atol=tol)


@pytest.mark.parametrize("dtype,noise", [(np.float32, 3e-4),
                                         (np.float64, 1e-8)])
def test_cholesky_qr2_ridge_fallback_matches_jax(cpu_device, dtype, noise):
    # a rank-1 panel plus noise: the Gram + small ridge is indefinite at
    # working precision, so the small-ridge Cholesky fails in both packages
    # and both take the large-ridge factor
    rng = np.random.default_rng(1)
    y = (rng.standard_normal((400, 1)) @ rng.standard_normal((1, 12))
         + noise * rng.standard_normal((400, 12))).astype(dtype)
    ys = torch.as_tensor(y) / torch.linalg.vector_norm(torch.as_tensor(y),
                                                       dim=0)
    eps_small = 1e-7 if dtype == np.float32 else 1e-15
    eye = torch.eye(12, dtype=ys.dtype)
    info = torch.linalg.cholesky_ex(ys.mT @ ys + eps_small * eye,
                                    upper=True).info
    assert int(info) != 0, "panel does not force the large-ridge branch"
    gj = jnp.asarray((ys.mT @ ys + eps_small * eye).numpy())
    assert not np.isfinite(np.asarray(jnp.linalg.cholesky(gj))).all()

    qj = np.asarray(jax_rsvd._cholesky_qr2(jnp.asarray(y)))
    qt = port_rsvd._cholesky_qr2(torch.as_tensor(y)).numpy()
    # the junk directions are set by the noise, i.e. to eps * cond(y)
    tol = EPS[dtype] * np.linalg.cond(y.astype(np.float64))
    np.testing.assert_allclose(qt, qj, atol=tol)
    # and the result is still an orthonormal basis of the panel
    np.testing.assert_allclose(qt.T @ qt, np.eye(12), atol=100 * EPS[dtype])
    recon = qt @ (qt.T @ y.astype(np.float64)) - y
    assert np.abs(recon).max() <= 100 * EPS[dtype] * np.abs(y).max()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_zero_matrix_stays_finite(same_sketch, dtype):
    # the norm-rescale guard: A == 0 must not turn into 0/0 = NaN
    a = np.zeros((30, 12), dtype)
    _, sj, _ = jax_rsvd.random_svd(jnp.asarray(a), 4, 3, 2, key=0)
    ut, st, vt = port_rsvd.random_svd(torch.as_tensor(a), 4, 3, 2, key=0)
    assert all(torch.isfinite(t).all() for t in (ut, st, vt))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_own_sketch_seed_and_generator(cpu_device, rng):
    # without the JAX draw: an int seed is reproducible and equals a
    # generator seeded with it; different seeds give different sketches
    a = torch.as_tensor(decaying(rng, (60, 20), np.float64))
    _, s1, v1 = port_rsvd.random_svd(a, 5, 4, 3, key=11)
    _, s2, v2 = port_rsvd.random_svd(a, 5, 4, 3, key=11)
    gen = torch.Generator().manual_seed(11)
    _, s3, _ = port_rsvd.random_svd(a, 5, 4, 3, key=gen)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)
    torch.testing.assert_close(v1, v2, rtol=0, atol=0)
    torch.testing.assert_close(s1, s3, rtol=0, atol=0)
    o1 = port_rsvd._draw_sketch(11, (4, 3), torch.float64, "cpu")
    o2 = port_rsvd._draw_sketch(12, (4, 3), torch.float64, "cpu")
    assert not torch.equal(o1, o2)
    # sigma agree with LAPACK whatever the draw, to the convergence of 4
    # iterations with 8 sketch columns: (s_9/s_5)**(4q+2) ~ 0.8**72 ~ 1e-7
    np.testing.assert_allclose(
        s1.numpy(), np.linalg.svd(a.numpy(), compute_uv=False)[:5],
        rtol=1e-6,
    )
