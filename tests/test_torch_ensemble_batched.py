"""``dmdc_fit_ensemble`` as one batched pass over the members.

``models.dmd._dmdc_reduce`` fits a stack of members in one pass over a
leading member axis, as the JAX package's ``jit(vmap)`` does, through the
member-batched RSVD core ``random_svd._random_svd_members``, and
``dmdc_fit_ensemble`` takes that pass. Held here: each member of a batch
equals its lone ``random_svd`` (also when healthy members share the batch
with deficient, non-finite or differently scaled ones, so every norm and
ridge choice is per member), the ensemble reduces its stack in one call of
``_dmdc_reduce`` and its factorization calls do not grow with the members,
each member's reduction equals its lone one, a one-member ensemble equals
``DMDc`` and the JAX package's ensemble, and a four-member ensemble of
distinct systems equals the JAX package's ``jit(vmap)`` fit.
"""
import jax
import numpy as np
import pytest
import torch

import corrla_rs_tpu as crt
import corrla_rs_tpu_torch as port
from _torch_parity import EPS, cpu_device, decaying, same_sketch  # noqa: F401
from corrla_rs_tpu.utils.prng import as_key
from corrla_rs_tpu_torch.models import dmd as port_dmd
from corrla_rs_tpu_torch.models.dmd import DMDc
from corrla_rs_tpu_torch.ops import random_svd as port_rsvd
from test_torch_dmd import RTOL, _close, _controlled

torch.set_num_threads(1)

# a batched fit against its lone fits: the same algorithm on the same
# sketch, apart only by the rounding of batched against single BLAS calls
MEMBER_TOL = {np.float64: 1e-12, np.float32: 1e-5}
KEYS = (5, 6, 7)


def _product(u, s, vt):
    return (u * s[..., None, :]) @ vt


def _held_to_lone(a, keys, dtype, **kw):
    """Each member of ``_random_svd_members(a)`` against ``random_svd`` of
    that member alone with its key: U S Vt relative to the member's scale,
    sigma relative to its largest."""
    u, s, vt = port_rsvd._random_svd_members(torch.as_tensor(a), 4, 6, 3,
                                             keys, **kw)
    tol = MEMBER_TOL[dtype]
    for b, key in enumerate(keys):
        u1, s1, vt1 = port_rsvd.random_svd(torch.as_tensor(a[b]), 4, 6, 3,
                                           key=key, **kw)
        assert u[b].shape == u1.shape and vt[b].shape == vt1.shape
        got, want = _product(u[b], s[b], vt[b]), _product(u1, s1, vt1)
        assert bool(torch.isfinite(got).all())
        scale = max(float(np.abs(a[b]).max()), 1e-300)
        assert float((got - want).abs().max()) <= tol * scale, b
        assert float((s[b] - s1).abs().max()) <= tol * max(float(s1[0]),
                                                           1e-300), b


@pytest.mark.parametrize("qr_method", ["householder", "cholesky"])
@pytest.mark.parametrize("stabilize", ["always", "reference"])
@pytest.mark.parametrize("shape", [(30, 12), (12, 30), (2100, 12)],
                         ids=["tall", "fat", "long"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_members_equal_their_lone_rsvds(cpu_device, dtype, shape, stabilize,
                                        qr_method):
    rng = np.random.default_rng(3)
    a = np.stack([decaying(rng, shape, dtype, rate=0.7) for _ in KEYS])
    _held_to_lone(a, KEYS, dtype, stabilize=stabilize, qr_method=qr_method)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_long_member_contractions_are_summed_in_chunks(cpu_device, dtype):
    # a member stack's contraction longer than _MEMBER_CHUNK is summed over
    # chunks (cuBLAS's batched GEMM loses digits over a long one on the
    # card); the sum is the product, and a 2-D product is a @ b itself
    rng = np.random.default_rng(6)
    n = 2 * port_rsvd._MEMBER_CHUNK + 37
    a = rng.standard_normal((3, 5, n)).astype(dtype)
    b = rng.standard_normal((3, n, 4)).astype(dtype)
    want = np.einsum("bij,bjk->bik", a.astype(np.float64),
                     b.astype(np.float64))
    got = port_rsvd._mm(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    scale = np.sqrt(n) * EPS[dtype] * np.abs(a).max() * np.abs(b).max()
    assert np.abs(got - want).max() <= 10 * scale
    t2 = (torch.as_tensor(a[0]), torch.as_tensor(b[0]))
    assert torch.equal(port_rsvd._mm(*t2), t2[0] @ t2[1])


@pytest.mark.parametrize("stabilize", ["always", "reference"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_deficient_and_scaled_members_keep_their_own_fits(cpu_device, dtype,
                                                          stabilize):
    # a zero member, one with repeated columns and two healthy ones whose
    # scales lie far apart: a norm taken over the batch underflows the
    # small member in the power loop
    rng = np.random.default_rng(4)
    far = 1e60 if dtype == np.float64 else 1e6
    healthy = decaying(rng, (40, 10), dtype, rate=0.7)
    repeated = np.repeat(decaying(rng, (40, 3), dtype, rate=0.7), [4, 3, 3],
                         axis=1)
    a = np.stack([healthy, np.zeros_like(healthy), repeated,
                  (healthy[::-1] * far).astype(dtype),
                  (healthy / far).astype(dtype)])
    keys = (1, 2, 3, 4, 5)
    _held_to_lone(a, keys, dtype, stabilize=stabilize)
    u, s, vt = port_rsvd._random_svd_members(torch.as_tensor(a), 4, 6, 3,
                                             keys, stabilize=stabilize)
    assert float(_product(u[1], s[1], vt[1]).abs().max()) == 0.0


@pytest.mark.parametrize("dtype,noise", [(np.float32, 3e-4),
                                         (np.float64, 1e-8)])
def test_cholesky_qr2_ridge_choice_is_per_member(cpu_device, dtype, noise):
    # the rank-1-plus-noise panel of test_torch_random_svd forces the
    # large ridge in its first round, a non-finite panel in every round;
    # the healthy panel beside either must keep the small one (a choice
    # made over the batch leaves it 1e-8 (f64) off orthonormal)
    rng = np.random.default_rng(1)
    deficient = (rng.standard_normal((400, 1)) @ rng.standard_normal((1, 12))
                 + noise * rng.standard_normal((400, 12))).astype(dtype)
    healthy = rng.standard_normal((400, 12)).astype(dtype)
    broken = healthy.copy()
    broken[7, 3] = np.nan
    eps_small = 1e-7 if dtype == np.float32 else 1e-15
    eye = torch.eye(12, dtype=torch.from_numpy(healthy).dtype)
    for panel, fails in ((deficient, True), (healthy, False)):
        ys = torch.as_tensor(panel)
        ys = ys / torch.linalg.vector_norm(ys, dim=0)
        info = torch.linalg.cholesky_ex(ys.mT @ ys + eps_small * eye,
                                        upper=True).info
        assert (int(info) != 0) == fails
    for stack in ((deficient, healthy), (healthy, deficient, healthy),
                  (healthy, broken)):
        got = port_rsvd._cholesky_qr2(torch.as_tensor(np.stack(stack)))
        for b, panel in enumerate(stack):
            want = port_rsvd._cholesky_qr2(torch.as_tensor(panel))
            torch.testing.assert_close(got[b], want, rtol=0,
                                       atol=MEMBER_TOL[dtype], equal_nan=True)


def _member_stack(dtype, n):
    xs, us = zip(*(_controlled(dtype, seed=s) for s in range(n)))
    return torch.as_tensor(np.stack(xs)), torch.as_tensor(np.stack(us))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_member_stack_factorizations_do_not_grow_with_members(
        cpu_device, monkeypatch, dtype):
    # dmdc_fit_ensemble reduces its stack in one call of _dmdc_reduce, so
    # two members and six make the same Cholesky and Householder calls (f32
    # takes the Cholesky QR in the loop, f64 the Householder QR from the
    # fourth iteration)
    calls = {"cholesky_ex": 0, "householder": 0, "reduce": 0}
    cholesky_ex, householder = torch.linalg.cholesky_ex, \
        port_rsvd._householder_qr
    reduce = port_dmd._dmdc_reduce

    def counted_cholesky(*args, **kw):
        calls["cholesky_ex"] += 1
        return cholesky_ex(*args, **kw)

    def counted_householder(y):
        calls["householder"] += 1
        return householder(y)

    def counted_reduce(x, *args):
        calls["reduce"] += 1
        assert x.ndim == 3
        return reduce(x, *args)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", counted_cholesky)
    monkeypatch.setattr(port_rsvd, "_householder_qr", counted_householder)
    monkeypatch.setattr(port_dmd, "_dmdc_reduce", counted_reduce)
    seen = []
    for n in (2, 6):
        calls.update(cholesky_ex=0, householder=0, reduce=0)
        x, u = _member_stack(dtype, n)
        fit = port.dmdc_fit_ensemble(x, u, 5, 10, key=9)
        assert fit["a_til"].shape == (n, 5, 5)
        seen.append(dict(calls))
    assert seen[0] == seen[1], seen
    assert seen[0]["reduce"] == 1
    assert seen[0]["householder"] > 0
    assert (seen[0]["cholesky_ex"] > 0) == (dtype == np.float32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_member_stack_reduction_equals_lone_reductions(cpu_device, dtype):
    # members whose data support every mode: the batched pass gives each
    # member's lone reduction (A~'s eigenvalues and B carry no SVD signs)
    x, u = _member_stack(dtype, 3)
    keys = port_dmd._split_seed(9, 3, "cpu")
    a_til, b_op, _, _ = port_dmd._dmdc_reduce(x, u, 5, 10, 12, keys)
    keys = port_dmd._split_seed(9, 3, "cpu")
    tol = MEMBER_TOL[dtype]
    for b in range(3):
        a1, b1, _, _ = port_dmd._dmdc_reduce(x[b], u[b], 5, 10, 12, keys[b])
        lam = np.sort_complex(np.linalg.eigvals(a_til[b].double().numpy()))
        lam1 = np.sort_complex(np.linalg.eigvals(a1.double().numpy()))
        assert np.abs(lam - lam1).max() <= tol * np.abs(lam1).max()
        assert float((b_op[b] - b1).abs().max()) <= tol * float(
            b1.abs().max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_one_member_ensemble_is_dmdc_and_jax(same_sketch, dtype):
    x, u = _controlled(dtype, seed=5)
    x_b, u_b = x[None], u[None]
    rtol = RTOL[dtype]
    fit = port.dmdc_fit_ensemble(x_b, u_b, 5, 10, key=9)
    lone = DMDc(x, u, 5, 10, key=jax.random.split(as_key(9), 1)[0],
                eig_backend="device")
    fj = crt.dmdc_fit_ensemble(x_b, u_b, 5, 10, key=9)
    lam = (fit["lambdas_re"][0] + 1j * fit["lambdas_im"][0]).numpy()
    lam_j = np.asarray(fj["lambdas_re"][0]) + 1j * np.asarray(
        fj["lambdas_im"][0])
    for want in (lone.lambdas, lam_j):
        np.testing.assert_allclose(np.sort_complex(lam),
                                   np.sort_complex(want), rtol=0, atol=rtol)
    _close(fit["a_til"][0], lone._A, rtol)
    _close(fit["b_op"][0], lone.est_b_til(), rtol)
    _close(fit["b_op"][0], fj["b_op"][0], rtol)
    x0 = x_b[:, :, :1]
    for m in ("reduced", "modes"):
        got = port.rollout_ensemble(fit, x0, u_b, method=m)[0]
        _close(got, lone.predict_multiple(x[:, :1], u, m), rtol)
        _close(got, crt.rollout_ensemble(fj, x0, u_b, method=m)[0], rtol)


def _signs(u, u_j):
    """The column signs that take the port's U^ to JAX's (SVD signs are the
    backend's choice)."""
    return np.sign(np.sum(np.asarray(u) * np.asarray(u_j), axis=-2))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_four_members_equal_the_jax_vmap_fit(same_sketch, dtype):
    # four driven systems with distinct dynamics, fitted in one batched
    # pass by each package on the same sketches
    x_b, u_b = (t.numpy() for t in _member_stack(dtype, 4))
    rtol = RTOL[dtype]
    fit = port.dmdc_fit_ensemble(x_b, u_b, 5, 10, key=9)
    fj = crt.dmdc_fit_ensemble(x_b, u_b, 5, 10, key=9)
    x0 = x_b[:, :, :1]
    lam = (fit["lambdas_re"] + 1j * fit["lambdas_im"]).numpy()
    lam_j = np.asarray(fj["lambdas_re"]) + 1j * np.asarray(fj["lambdas_im"])
    assert np.abs(np.sort_complex(lam_j[0]) - np.sort_complex(lam_j[1])
                  ).max() > 1e-2
    for b in range(4):
        np.testing.assert_allclose(np.sort_complex(lam[b]),
                                   np.sort_complex(lam_j[b]), rtol=0,
                                   atol=rtol)
        d = _signs(fit["u_hat"][b], fj["u_hat"][b])
        _close(d[:, None] * fit["a_til"][b].numpy() * d[None, :],
               fj["a_til"][b], rtol)
        _close(fit["b_op"][b], fj["b_op"][b], rtol)
    for m in ("reduced", "modes"):
        got = port.rollout_ensemble(fit, x0, u_b, method=m)
        want = crt.rollout_ensemble(fj, x0, u_b, method=m)
        for b in range(4):
            _close(got[b], want[b], rtol)
