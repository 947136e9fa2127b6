"""Port parity: eig, DMDc (both eig backends, all rollouts), PyDMDc, the
DMDc ensemble and plain DMD (exact/tls/fb) against the JAX package, plus
the forced-sine fixture of reference dmd_rom.rs:228-311."""
import jax
import numpy as np
import pytest
import torch

import corrla_rs_tpu as crt
import corrla_rs_tpu_torch as port
from _torch_parity import cpu_device, same_sketch  # noqa: F401 (fixtures)
from corrla_rs_tpu.models.dmd import DMD as JaxDMD
from corrla_rs_tpu.utils.prng import as_key
from corrla_rs_tpu_torch.models.dmd import DMD, DMDc
from corrla_rs_tpu_torch.ops.mat_utils import mat_linspace

torch.set_num_threads(1)

# same sketch, same keys: f64 to rounding, f32 at its own level
RTOL = {np.float64: 1e-8, np.float32: 1e-4}


def _controlled(dtype, n_x=24, n_t=33, n_u=2, seed=0):
    """A random stable linear system driven by two controls."""
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((n_x, n_x)))[0]
    a = q @ np.diag(np.linspace(0.5, 0.97, n_x)) @ q.T
    b = rng.standard_normal((n_x, n_u))
    u = np.vstack([np.sin(0.3 * np.arange(n_t)),
                   np.cos(0.17 * np.arange(n_t))])[:n_u]
    x = np.zeros((n_x, n_t))
    x[:, 0] = rng.standard_normal(n_x)
    for k in range(n_t - 1):
        x[:, k + 1] = a @ x[:, k] + b @ u[:, k]
    return x.astype(dtype), u.astype(dtype)


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _sine_fixture(nx, nt):
    # forced sine field with exponentially growing control (dmd_rom.rs:243-267)
    x = mat_linspace(0.0, 10.0, nx, torch.float64)[:, 0]
    t = mat_linspace(0.0, 10.0, nt, torch.float64)[:, 0]
    u = torch.exp(0.2 * t)[None, :]
    return torch.sin(x[:, None] + 0.2 * t[None, :]) * u, u


def test_eig_and_eig_host_match_numpy(cpu_device):
    a = np.random.default_rng(1).standard_normal((12, 12))
    vals, vecs = port.eig(a)
    assert vals.dtype == torch.complex128 and vals.device.type == "cpu"
    np.testing.assert_allclose(np.sort_complex(vals.numpy()),
                               np.sort_complex(np.linalg.eigvals(a)),
                               rtol=1e-12)
    resid = torch.as_tensor(a).to(vecs.dtype) @ vecs - vecs * vals
    assert float(resid.abs().max()) < 1e-12
    hv, hw = port.eig_host(a.astype(np.float32))
    assert isinstance(hv, np.ndarray) and hv.dtype == np.complex64
    jv, _ = crt.eig_host(a.astype(np.float32))
    np.testing.assert_allclose(np.sort_complex(hv), np.sort_complex(jv),
                               rtol=1e-5)


@pytest.mark.parametrize("eig_backend", ["host", "device"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dmdc_matches_jax(same_sketch, dtype, eig_backend):
    x, u = _controlled(dtype)
    mj = crt.DMDc(x, u, 6, 10, key=3, eig_backend=eig_backend)
    mt = DMDc(x, u, 6, 10, key=3, eig_backend=eig_backend)
    rtol = RTOL[dtype]
    assert isinstance(mt.lambdas, np.ndarray) and mt.lambdas.shape == (6,)
    np.testing.assert_allclose(np.sort_complex(mt.lambdas),
                               np.sort_complex(mj.lambdas), rtol=0,
                               atol=rtol)
    _close(mt.est_a_til(), mj.est_a_til(), rtol)
    _close(mt.est_b_til(), mj.est_b_til(), rtol)
    for method in ("dense", "modes", "reduced"):
        _close(mt.predict_multiple(x[:, :1], u, method),
               mj.predict_multiple(x[:, :1], u, method), rtol)
    _close(mt.predict(x[:, :1], u[:, :1]), mj.predict(x[:, :1], u[:, :1]),
           rtol)
    assert mt.modes_re.dtype == mt._w_im.dtype == torch.from_numpy(x).dtype


@pytest.mark.parametrize("nx,nt", [(20, 40), (50, 40)])
def test_dmdc_forced_sine_fixture(cpu_device, nx, nt):
    # 20th snapshot vs 19th prediction within 5e-2 (dmd_rom.rs:309)
    p, u = _sine_fixture(nx, nt)
    model = port.PyDMDc(p, u, n_modes=14, n_iters=40)
    assert model.est_a_til().shape == (nx, nx)
    assert model.est_b_til().shape == (nx, 1)
    pred = model.predict(p[:, 0:1], u)       # PyDMDc rolls the sequence
    assert pred.shape == (nx, nt)
    assert float((pred[:, 19] - p[:, 20]).abs().max()) < 5e-2
    one = model.predict_multiple(p[:, 0:1], u[:, :1])
    torch.testing.assert_close(
        DMDc.predict(model, p[:, 0:1], u[:, 0:1])[:, 0], one[:, 0],
        rtol=0, atol=1e-9)


def test_dmdc_validates(cpu_device):
    with pytest.raises(ValueError, match="eig_backend"):
        DMDc(np.ones((4, 5)), np.ones((1, 5)), 2, 2, eig_backend="nope")
    with pytest.raises(TypeError, match="mesh"):
        DMDc(np.ones((4, 5)), np.ones((1, 5)), 2, 2, mesh=object())
    with pytest.raises(ValueError, match="batches"):
        port.dmdc_fit_ensemble(np.ones((4, 5)), np.ones((1, 5)), 2, 2)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dmdc_ensemble_matches_jax_members(same_sketch, dtype):
    # member b of the ensemble is the JAX DMDc fit with the b-th split key
    # (the JAX ensemble's own eig is the Francis-QR solver, whose compile
    # is slow on the CPU; its members are these fits)
    xs, us = zip(*(_controlled(dtype, seed=s) for s in range(3)))
    x_b, u_b = np.stack(xs), np.stack(us)
    fit = port.dmdc_fit_ensemble(x_b, u_b, 5, 10, key=9)
    assert fit["lambdas_re"].shape == (3, 5)
    assert fit["modes_re"].shape == (3, 24, 5)
    assert fit["w_re"].shape == (3, 5, 24)
    rtol = RTOL[dtype]
    keys = jax.random.split(as_key(9), 3)
    x0 = x_b[:, :, :1]
    pred = {m: port.rollout_ensemble(fit, x0, u_b, method=m).numpy()
            for m in ("reduced", "modes")}
    shared = port.rollout_ensemble(fit, x0, u_b[0], method="reduced")
    assert shared.shape == (3, 24, 33)
    for b in range(3):
        mj = crt.DMDc(x_b[b], u_b[b], 5, 10, key=keys[b], eig_backend="host")
        lam = (fit["lambdas_re"][b] + 1j * fit["lambdas_im"][b]).numpy()
        np.testing.assert_allclose(np.sort_complex(lam),
                                   np.sort_complex(mj.lambdas), rtol=0,
                                   atol=rtol)
        _close(fit["b_op"][b], mj.est_b_til(), rtol)
        for m in ("reduced", "modes"):
            _close(pred[m][b], mj.predict_multiple(x0[b], u_b[b], m),
                   rtol)
    with pytest.raises(ValueError, match="method"):
        port.rollout_ensemble(fit, x0, u_b, method="dense")


def _autonomous(dtype, n_x=30, n_t=41, seed=2):
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((n_x, n_x)))[0]
    blocks = [np.array([[r * np.cos(w), -r * np.sin(w)],
                        [r * np.sin(w), r * np.cos(w)]])
              for r, w in ((0.98, 0.3), (0.9, 0.7))]
    core = np.zeros((5, 5))
    core[:2, :2], core[2:4, 2:4], core[4, 4] = blocks[0], blocks[1], 0.8
    a = q[:, :5] @ core @ q[:, :5].T
    x = np.zeros((n_x, n_t))
    x[:, 0] = q[:, :5] @ rng.standard_normal(5)
    for k in range(1, n_t):
        x[:, k] = a @ x[:, k - 1]
    noise = 1e-4 * rng.standard_normal(x.shape)
    return (x + noise).astype(dtype)


@pytest.mark.parametrize("solver,eig_backend,rank_rtol", [
    ("exact", "host", 0.0), ("exact", "device", 0.0),
    ("exact", "host", 1e-6), ("tls", "host", 0.0), ("fb", "device", 0.0)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dmd_matches_jax(same_sketch, dtype, solver, eig_backend, rank_rtol):
    x = _autonomous(dtype)
    kw = dict(n_modes=5, n_iters=10, key=4, eig_backend=eig_backend,
              solver=solver, rank_rtol=rank_rtol)
    mj, mt = JaxDMD(x, **kw), DMD(x, **kw)
    rtol = RTOL[dtype]
    np.testing.assert_allclose(np.sort_complex(mt.lambdas),
                               np.sort_complex(mj.lambdas), rtol=0,
                               atol=rtol)
    for method in ("modes", "reduced"):
        _close(mt.predict_multiple(x[:, :1], 12, method),
               mj.predict_multiple(x[:, :1], 12, method), rtol)
    _close(mt.reconstruct(), mj.reconstruct(), rtol)
    np.testing.assert_allclose(np.sort_complex(mt.eigs_continuous(0.1)),
                               np.sort_complex(mj.eigs_continuous(0.1)),
                               rtol=100 * rtol)
    assert isinstance(mt.amplitudes, np.ndarray) and mt.amplitudes.shape == (5,)


def test_dmd_validates(cpu_device):
    with pytest.raises(ValueError, match="eig_backend"):
        DMD(np.ones((4, 6)), 2, eig_backend="gpu")
    with pytest.raises(ValueError, match="solver"):
        DMD(np.ones((4, 6)), 2, solver="ols")
    with pytest.raises(ValueError, match="rank_rtol"):
        DMD(np.ones((4, 6)), 2, solver="tls", rank_rtol=1e-3)
    m = DMD(_autonomous(np.float64), 3)
    with pytest.raises(ValueError, match="method"):
        m.predict_multiple(_autonomous(np.float64)[:, :1], 5, method="banana")


@pytest.mark.parametrize("kind", ["DMDc", "PyDMDc", "DMD"])
def test_converted_dmd_predicts_what_jax_predicts(cpu_device, tmp_path, kind):
    from corrla_rs_tpu.utils.checkpoint import save_model
    from corrla_rs_tpu_torch.utils.convert import (
        from_jax_state,
        load_jax_checkpoint,
    )

    x, u = _controlled(np.float64)
    if kind == "DMD":
        mj = JaxDMD(_autonomous(np.float64), 5, key=2)
    else:
        mj = getattr(crt, kind)(x, u, 6, 10, key=3)
    path = tmp_path / "m.npz"
    if kind != "PyDMDc":      # the JAX registry saves DMDc and DMD
        save_model(str(path), mj)
    for mt in ([from_jax_state(kind, vars(mj))]
               + ([load_jax_checkpoint(str(path))] if kind != "PyDMDc"
                  else [])):
        assert type(mt).__name__ == kind
        assert isinstance(mt.lambdas, np.ndarray)
        if kind == "DMD":
            x0 = _autonomous(np.float64)[:, :1]
            for method in ("modes", "reduced"):
                _close(mt.predict_multiple(x0, 9, method),
                       mj.predict_multiple(x0, 9, method), 1e-12)
            _close(mt.reconstruct(), mj.reconstruct(), 1e-12)
        else:
            for method in ("dense", "modes", "reduced"):
                _close(mt.predict_multiple(x[:, :1], u, method),
                       mj.predict_multiple(x[:, :1], u, method), 1e-12)
            u_in = u if kind == "PyDMDc" else u[:, :1]   # sequence or step
            _close(mt.predict(x[:, :1], u_in), mj.predict(x[:, :1], u_in),
                   1e-12)
