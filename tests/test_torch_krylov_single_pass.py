"""Port parity: block_krylov_svd and single_pass_svd against the JAX package.

Both packages draw the same sketches from the same key splits
(``_torch_parity.same_sketch``), so what is left is rounding.
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
from corrla_rs_tpu.ops import random_svd as jax_rsvd
from corrla_rs_tpu_torch.ops import random_svd as port_rsvd

torch.set_num_threads(1)

# same-sketch sigma: 1e-10 in f64, 1e-5 in f32 (1e-15 and ~1e-6 measured on
# a 0.8**j spectrum); U/V up to sign, as a gap of the column cosines
TOL = {np.float64: (1e-10, 1e-8), np.float32: (1e-5, 1e-3)}


@pytest.mark.parametrize("shape", [(120, 40), (40, 120)], ids=["tall", "fat"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_iter", [0, 3])
def test_block_krylov_svd_matches_jax(same_sketch, rng, shape, dtype, n_iter):
    a = decaying(rng, shape, dtype)
    uj, sj, vj = jax_rsvd.block_krylov_svd(jnp.asarray(a), 6, n_iter, 4, key=3)
    ut, st, vt = port_rsvd.block_krylov_svd(torch.as_tensor(a), 6, n_iter, 4,
                                            key=3)
    rtol, gap = TOL[dtype]
    assert ut.shape == (shape[0], 6) and vt.shape == (6, shape[1])
    assert st.numpy().dtype == dtype
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=rtol)
    assert subspace_gap(uj, ut) <= gap
    assert subspace_gap(np.asarray(vj).T, vt.numpy().T) <= gap


@pytest.mark.parametrize("shape", [(150, 40), (40, 150)], ids=["tall", "fat"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("core", [None, 5])
def test_single_pass_svd_matches_jax(same_sketch, rng, shape, dtype, core):
    # rate 0.5: the sigma kept stand well clear of each other, so the
    # vectors are as well defined as the values
    a = decaying(rng, shape, dtype, rate=0.5)
    uj, sj, vj = jax_rsvd.single_pass_svd(jnp.asarray(a), 5, 6,
                                          core_oversamples=core, key=9)
    ut, st, vt = port_rsvd.single_pass_svd(torch.as_tensor(a), 5, 6,
                                           core_oversamples=core, key=9)
    rtol, gap = TOL[dtype]
    assert ut.shape == (shape[0], 5) and vt.shape == (5, shape[1])
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=rtol)
    assert subspace_gap(uj, ut) <= gap
    assert subspace_gap(np.asarray(vj).T, vt.numpy().T) <= gap


def test_krylov_block_is_written_in_place(cpu_device, rng, monkeypatch):
    # every iterate lands in its slice of one (n, k (q + 1)) block, which is
    # what the final QR receives
    seen = {}
    real_qr = port_rsvd._householder_qr

    def spy(y):
        seen["shape"], seen["finite"] = tuple(y.shape), bool(
            torch.isfinite(y).all())
        return real_qr(y)

    monkeypatch.setattr(port_rsvd, "_householder_qr", spy)
    a = torch.as_tensor(decaying(rng, (90, 30), np.float64))
    port_rsvd.block_krylov_svd(a, 4, 3, 2, key=0)
    assert seen == {"shape": (90, 6 * 4), "finite": True}


def test_exact_on_low_rank_with_own_draws(cpu_device, rng):
    # without the JAX draw: both are exact on a rank-5 matrix, and an int
    # seed reproduces
    a = torch.as_tensor(rng.standard_normal((200, 5))
                        @ rng.standard_normal((5, 60)))
    s_true = np.linalg.svd(a.numpy(), compute_uv=False)[:5]
    for fn in (lambda k: port_rsvd.single_pass_svd(a, 5, 5, key=k),
               lambda k: port_rsvd.block_krylov_svd(a, 5, 1, 5, key=k)):
        u, s, vt = fn(4)
        np.testing.assert_allclose(s.numpy(), s_true, rtol=1e-9)
        np.testing.assert_allclose(((u * s) @ vt).numpy(), a.numpy(),
                                   atol=1e-9)
        torch.testing.assert_close(fn(4)[1], s, rtol=0, atol=0)
        assert not torch.equal(fn(5)[0], u)


def test_single_pass_tail_error_is_the_algorithm_s(same_sketch, rng):
    # a spectrum of 200 sigma from 1 to 1e-3 (3.4% an index), rank 100: with
    # 10 oversamples and no power iteration the trailing sigma are off by
    # more than 5e-2 in both packages alike (the two errors agree to 1e-9
    # from the same sketch), the leading 50 are within 5e-2, and 50
    # oversamples bring all 100 within 5e-2
    n, m, rank = 600, 400, 100
    s_true = np.logspace(0, -3, 200)
    u0 = np.linalg.qr(rng.standard_normal((n, 200)))[0]
    v0 = np.linalg.qr(rng.standard_normal((m, 200)))[0]
    a = (u0 * s_true) @ v0.T

    def errors(n_os):
        sj = jax_rsvd.single_pass_svd(jnp.asarray(a), rank, n_os, key=1)[1]
        st = port_rsvd.single_pass_svd(torch.as_tensor(a), rank, n_os,
                                       key=1)[1]
        return (np.abs(np.asarray(sj) - s_true[:rank]) / s_true[:rank],
                np.abs(st.numpy() - s_true[:rank]) / s_true[:rank])

    err_jax, err_port = errors(10)
    np.testing.assert_allclose(err_port, err_jax, rtol=0, atol=1e-9)
    assert err_port[:rank // 2].max() <= 5e-2 < err_port.max() <= 0.25
    err_jax, err_port = errors(50)
    np.testing.assert_allclose(err_port, err_jax, rtol=0, atol=1e-9)
    assert err_port.max() <= 5e-2
