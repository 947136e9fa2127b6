"""``mat_utils.pinv_batched`` (the one-sided Jacobi over a whole batch of
small matrices) against ``mat_utils.pinv`` (``torch.linalg.svd``) and against
the JAX package's ``pinv`` under ``jax.vmap``, on the CPU in f64, on what the
local polynomial fits compute: pinv(A) @ y.

A singular value that is exactly zero is inverted as 1 / eps along a left
vector that is arbitrary in the left null space, in LAPACK as here, and
LAPACK's own right vector for it is off the coordinate axis by rounding,
which 1 / eps = 1e14 amplifies to 1e-2 in every row of the reference. So the
rank-deficient cases are held by what is determined: the rows of the other
columns equal the pinv of the matrix without the zero column, and the zero
column's row has norm 1 / eps and lies in the left null space.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cpu_device  # noqa: F401 (fixture)
from corrla_rs_tpu.ops import mat_utils as jax_mat_utils
from corrla_rs_tpu_torch.ops import mat_utils, stats_corr

torch.set_num_threads(1)

RTOL = 1e-9


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("shape", [(40, 64, 45), (3, 5, 12, 7), (9, 10, 10),
                                   (6, 7, 16)],
                         ids=["vandermondes", "two-batch-dims", "square",
                              "fat"])
def test_pinv_batched_equals_pinv_on_full_rank_batches(rng, shape):
    a = torch.from_numpy(rng.standard_normal(shape))
    y = torch.from_numpy(rng.standard_normal(shape[:-1] + (2,)))
    got, want = mat_utils.pinv_batched(a), mat_utils.pinv(a)
    assert got.shape == want.shape
    assert rel(got @ y, want @ y) <= RTOL
    assert rel(got, want) <= RTOL


@pytest.mark.parametrize("shape", [(40, 64, 45), (9, 10, 10), (6, 7, 16)],
                         ids=["vandermondes", "square", "fat"])
def test_pinv_batched_equals_the_jax_pinv_under_vmap(rng, shape):
    a = rng.standard_normal(shape)
    y = rng.standard_normal(shape[:-1] + (2,))
    want = np.array(jax.vmap(jax_mat_utils.pinv)(jnp.asarray(a)) @ y)
    assert want.dtype == np.float64
    got = mat_utils.pinv_batched(torch.from_numpy(a)) @ torch.from_numpy(y)
    assert rel(got, torch.from_numpy(want)) <= RTOL


def test_pinv_batched_warns_when_the_sweeps_run_out(rng, monkeypatch):
    a = torch.from_numpy(rng.standard_normal((4, 12, 9)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mat_utils.pinv_batched(a)                # converges: no warning
    monkeypatch.setattr(mat_utils, "_JACOBI_BLIND_SWEEPS", 0)
    monkeypatch.setattr(mat_utils, "_JACOBI_MAX_SWEEPS", 1)
    with pytest.warns(RuntimeWarning, match="did not converge"):
        mat_utils.pinv_batched(a)


def test_pinv_batched_on_ill_conditioned_local_vandermondes(rng):
    # neighbourhoods of radius 0.05 off the origin: columns scale like
    # 1, h, h^2, cond in the thousands, and the smallest sigma are amplified most
    x = torch.from_numpy(0.7 + 0.05 * rng.standard_normal((30, 64, 4)))
    van = stats_corr.build_vandermonde(x, True)
    y = torch.from_numpy(rng.standard_normal((30, 64, 1)))
    assert float(torch.linalg.cond(van).max()) > 1e3
    assert rel(mat_utils.pinv_batched(van) @ y, mat_utils.pinv(van) @ y) \
        <= RTOL
    # f32 holds what f32 can: cond * eps
    got32 = mat_utils.pinv_batched(van.float()) @ y.float()
    assert got32.dtype == torch.float32
    assert rel(got32.double(), mat_utils.pinv(van) @ y) <= 0.2


def test_pinv_batched_amplifies_a_zero_column_as_pinv_does(rng):
    eps = 1e-14
    a = torch.from_numpy(rng.standard_normal((8, 20, 7)))
    a[2, :, 3] = 0.0
    a[5, :, 0] = 0.0
    a[5, :, 6] = 0.0
    got, ref = mat_utils.pinv_batched(a), mat_utils.pinv(a)
    assert bool(torch.isfinite(got).all())
    for b, zero_cols in ((2, [3]), (5, [0, 6])):
        keep = [j for j in range(7) if j not in zero_cols]
        # the other columns' rows: the pinv of the matrix without the zero
        # columns, which is what both compute there
        want = mat_utils.pinv(a[b][:, keep])
        assert rel(got[b][keep], want) <= RTOL
        for j in zero_cols:
            row = got[b, j]
            # 1 / (0 + eps) along a unit vector of the left null space
            assert float(row.norm()) == pytest.approx(1.0 / eps, rel=1e-9)
            assert float((a[b].mT @ row).abs().max()) <= 1e-12 / eps
            # the reference's row is amplified alike (its sigma is rounding,
            # not 0, so its norm is within a few percent of 1 / eps)
            assert float(ref[b, j].norm()) == pytest.approx(1.0 / eps,
                                                            rel=0.2)
        if len(zero_cols) == 2:
            u0, u1 = (got[b, j] * eps for j in zero_cols)
            assert abs(float(u0 @ u1)) <= 1e-12
    # the matrices without a zero column are untouched by the completion
    others = [0, 1, 3, 4, 6, 7]
    assert rel(got[others], ref[others]) <= RTOL


def test_pinv_batched_on_a_nearly_deficient_batch(rng):
    # sigma_min = 1e-6: determined, and amplified by 1e6
    u = np.linalg.qr(rng.standard_normal((5, 30, 6)))[0]
    v = np.linalg.qr(rng.standard_normal((5, 6, 6)))[0]
    s = np.array([3.0, 2.0, 1.0, 0.5, 0.1, 1e-6])
    a = torch.from_numpy((u * s) @ np.swapaxes(v, 1, 2))
    y = torch.from_numpy(rng.standard_normal((5, 30, 1)))
    got, want = mat_utils.pinv_batched(a) @ y, mat_utils.pinv(a) @ y
    assert float(want.abs().max()) > 1e4
    assert rel(got, want) <= RTOL


@pytest.mark.parametrize("shape, on_cuda, want", [
    ((32768, 64, 45), True, True),       # the local fits of active_ss
    ((32, 32, 64, 45), True, True),      # two batch dimensions: 1,024 in all
    ((2048, 16, 128), True, True),       # fat: rows and columns by size
    ((1024, 256, 128), True, True),
    ((32768, 64, 45), False, False),     # the CPU keeps LAPACK's loop
    ((512, 64, 45), True, False),        # too few matrices to pay
    ((64, 45), True, False),             # no batch
    ((4096, 16, 8), True, False),        # cuSOLVER's own batched SVD
    ((4096, 32, 32), True, False),
    ((2048, 256, 256), True, False),     # slower than the loop there
    ((2048, 300, 5), True, False),       # beyond what was measured
])
def test_the_batched_route_is_taken_where_it_was_measured_to_pay(
        shape, on_cuda, want):
    assert mat_utils._jacobi_pays(torch.Size(shape), on_cuda) is want


def test_the_polynomial_fits_route_batches_through_pinv_batched(
        cpu_device, rng, monkeypatch):
    calls = []
    real = mat_utils.pinv_batched
    monkeypatch.setattr(mat_utils, "pinv_batched",
                        lambda a, eps=1e-14: calls.append(a.shape) or
                        real(a, eps))
    x = torch.from_numpy(rng.standard_normal((12, 30, 3)))
    y = torch.from_numpy(rng.standard_normal((12, 30, 1)))
    # on the CPU nothing takes the Jacobi
    on_cpu = stats_corr.quad_fit(x, y)
    assert calls == []
    # what the rule sends there goes through quad_fit and jac_from_lin
    monkeypatch.setattr(mat_utils, "_jacobi_pays",
                        lambda shape, on_cuda: len(shape) > 2)
    coeffs = stats_corr.quad_fit(x, y)
    stats_corr.jac_from_lin(x, y)
    assert calls == [(12, 30, 10), (12, 30, 4)]
    want = torch.stack([stats_corr.quad_fit(x[i], y[i]) for i in range(12)])
    assert calls == [(12, 30, 10), (12, 30, 4)]      # unbatched: the SVD
    assert rel(coeffs, want) <= RTOL and rel(on_cpu, want) <= RTOL
