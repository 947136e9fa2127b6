"""Port parity: the Koopman and DMD-family ROM models (EDMD, kernel DMD,
SPOD, operator inference, SINDy, optimized and BOP-DMD, bagged DMD)
against the JAX package.

Both packages run on the CPU in f64 on inputs made with numpy from a seed.
The randomized fits draw the JAX package's sketches and split their keys as
JAX does (``same_sketch``); bagged DMD's subsets come from JAX's
``jax.random.choice`` through the port's ``bop_dmd._draw_subset``. Where
both compute the same algebra the results agree to 1e-10 of their scale;
the looser tolerances are stated beside the comparison with their reason.
A fitted model of each of the eight checkpointed classes is saved by the
JAX package and loaded into the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrla_rs_tpu as crt
import corrla_rs_tpu_torch as port
from _torch_parity import cpu_device, same_sketch  # noqa: F401 (fixtures)
from corrla_rs_tpu.utils import checkpoint as jck
from corrla_rs_tpu.utils.prng import as_key
from corrla_rs_tpu_torch.models import bop_dmd as pbop
from corrla_rs_tpu_torch.models import edmd as pedmd
from corrla_rs_tpu_torch.models import sindy as psindy
from corrla_rs_tpu_torch.utils import checkpoint as pck
from corrla_rs_tpu_torch.utils.convert import from_jax_state, \
    load_jax_checkpoint

torch.set_num_threads(1)

TOL = 1e-10


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _close(got, want, tol=TOL):
    """Equal to ``tol`` of the larger magnitude of ``want``."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= tol * scale


def _same_set(got, want, tol=TOL):
    """Two spectra equal as sets, to ``tol`` of their largest modulus."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    gap = np.abs(got[:, None] - want[None, :])
    scale = max(float(np.abs(want).max()), 1e-300)
    assert gap.min(axis=1).max() <= tol * scale
    assert gap.min(axis=0).max() <= tol * scale


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# EDMD

MU, LAM, C = 0.9, 0.5, 0.4


def _koopman_pairs(rng, n_traj=8, m=30):
    """x1' = mu x1, x2' = lam x2 + c x1^2 from several starts: Koopman
    eigenvalues {1, mu, lam, mu^2} on the degree-2 dictionary."""
    xs, ys = [], []
    for _ in range(n_traj):
        v = rng.uniform(-1, 1, 2)
        traj = [v]
        for _ in range(m):
            x1, x2 = traj[-1]
            traj.append(np.array([MU * x1, LAM * x2 + C * x1 * x1]))
        traj = np.stack(traj, axis=1)
        xs.append(traj[:, :-1])
        ys.append(traj[:, 1:])
    return np.hstack(xs), np.hstack(ys)


def _sine_pairs():
    """x' = 0.95 sin(x) from 12 starts (the JAX test's RBF fixture)."""
    trajs = []
    for x0 in np.linspace(0.2, 2.5, 12):
        xs = [np.array([x0])]
        for _ in range(25):
            xs.append(0.95 * np.sin(xs[-1]))
        trajs.append(np.stack(xs, axis=1))
    return (np.hstack([t[:, :-1] for t in trajs]),
            np.hstack([t[:, 1:] for t in trajs]))


def _edmd_case(kind):
    """(args, kwargs, x0) of one Edmd fit, numpy inputs."""
    if kind == "poly":
        x, y = _koopman_pairs(_rng(1))
        return (x,), dict(dictionary="poly", degree=3, y_data=y), \
            np.array([0.7, -0.3])
    if kind == "rbf":
        x, y = _sine_pairs()
        centers = np.linspace(0.0, 2.7, 6)[:, None]
        return (x,), dict(dictionary="rbf", centers=centers, gamma=4.0,
                          y_data=y), np.array([1.7])
    rng = _rng(2)
    a = rng.standard_normal((5, 5))
    a *= 0.9 / np.max(np.abs(np.linalg.eigvals(a)))
    x = rng.standard_normal((5, 200))
    return (x,), dict(dictionary="linear", include_const=False,
                      y_data=a @ x), rng.standard_normal(5)


@pytest.mark.parametrize("kind", ["poly", "rbf", "linear"])
def test_edmd_matches_jax(cpu_device, kind):
    args, kw, x0 = _edmd_case(kind)
    j = crt.Edmd(*args, **kw)
    p = port.Edmd(*args, **kw)
    assert p.koopman.device.type == "cpu"
    # the RBF features come from direct differences in the port (the
    # kernel matrix's plain version) and from the Gram expansion in JAX:
    # equal to 1e-12, which the Gram's solve amplifies by its condition
    # number (3e6 here), so the operator is held at 1e-9 there
    tol = 1e-9 if kind == "rbf" else TOL
    _close(p.lift(args[0]), j.lift(args[0]), 1e-12)
    _close(p.koopman, j.koopman, tol)
    _same_set(p.lambdas, j.lambdas, tol)
    # a residual is the square root of a difference of quadratic forms:
    # where it is 0 in exact arithmetic, each package returns
    # sqrt(rounding), about 1e-8; held at 2e-7 absolute, relative ones
    # (the residual is a ratio) at the operator's tolerance elsewhere
    res_p, res_j = p.residuals(), j.residuals()
    assert np.abs(res_p - res_j).max() <= 2e-7 + tol * np.abs(res_j).max()
    _close(p.predict(x0, 10), j.predict(x0, 10), tol)
    _close(p.predict(x0, 10, relift=True), j.predict(x0, 10, relift=True),
           tol)
    lam_p, res_p = p.validated_spectrum(1e-2)
    lam_j, res_j = j.validated_spectrum(1e-2)
    _same_set(lam_p, lam_j, tol)


def test_edmd_eigenfunctions_and_custom_dictionary(cpu_device):
    x, y = _koopman_pairs(_rng(3))
    j = crt.Edmd(x, degree=2, y_data=y)
    p = port.Edmd(x, degree=2, y_data=y)
    # numpy's eig of the two (equal to 1e-10) operators: unit-norm
    # eigenvectors whose phase may differ, so |phi| is compared
    _close(np.abs(p.eigenfunctions(x[:, :5])),
           np.abs(j.eigenfunctions(x[:, :5])), 1e-8)
    traj = np.concatenate([x[:, :1], y[:, :30]], axis=1)
    jc = crt.Edmd(traj, dictionary=lambda v: v[0:1] ** 2)
    pc = port.Edmd(traj, dictionary=lambda v: v[0:1] ** 2)
    _close(pc.koopman, jc.koopman)
    _close(pc.predict(np.array([0.6, 0.2]), 8),
           jc.predict(np.array([0.6, 0.2]), 8))
    assert pedmd.poly_exponents(3, 3).tolist() == \
        __import__("corrla_rs_tpu.models.edmd",
                   fromlist=["x"]).poly_exponents(3, 3).tolist()
    with pytest.raises(ValueError, match="centers"):
        port.Edmd(traj, dictionary="rbf")


def test_edmd_rbf_lift_equals_the_gram_expansion(cpu_device):
    # the kernel matrix's gaussian with eps = sqrt(gamma) is the JAX
    # package's exp(-gamma ||x - c||^2)
    rng = _rng(4)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 300)))
    centers = torch.from_numpy(rng.uniform(-1, 1, (17, 2)))
    out = torch.empty(17, 300, dtype=torch.float64)
    pedmd._rbf_features_into(out, x, centers, 3.0)
    _close(out, pedmd._rbf_features_gram(x, centers, 3.0), 1e-13)


# ---------------------------------------------------------------------------
# kernel DMD

def _kdmd_data(n=6, m=80, seed=5):
    rng = _rng(seed)
    a = rng.standard_normal((n, n))
    a *= 0.95 / np.max(np.abs(np.linalg.eigvals(a)))
    x = np.empty((n, m))
    x[:, 0] = rng.standard_normal(n)
    for t in range(1, m):
        x[:, t] = a @ x[:, t - 1] + 0.05 * np.tanh(x[:, t - 1])
    return x


@pytest.mark.parametrize("kernel,method", [("rbf", "eigh"),
                                           ("poly", "eigh"),
                                           ("linear", "eigh"),
                                           ("rbf", "nystrom")])
def test_kernel_dmd_matches_jax(same_sketch, kernel, method):
    x = _kdmd_data()
    kw = dict(kernel=kernel, length_scale=2.0, degree=2,
              gram_method=method, key=3)
    j = crt.KernelDmd(x, 8, **kw)
    p = port.KernelDmd(x, 8, **kw)
    assert p.rank == j.rank
    # eigh's eigenvector signs may differ between the two LAPACK calls;
    # the spectrum, the forecast and |phi| do not depend on them
    _same_set(p.lambdas, j.lambdas, 1e-9)
    _close(p.predict(x[:, -1], 6), j.predict(x[:, -1], 6), 1e-9)
    _close(np.abs(p.eigenfunctions(x[:, :4])),
           np.abs(j.eigenfunctions(x[:, :4])), 1e-8)
    _close(np.abs(p.modes), np.abs(j.modes), 1e-8)


# ---------------------------------------------------------------------------
# SPOD

def _spod_data(seed=6, n_x=12, n_t=1024):
    rng = _rng(seed)
    s = np.linspace(0, 1, n_x)
    t = np.arange(n_t, dtype=float)
    return (np.outer(np.sin(np.pi * s), np.cos(2 * np.pi * (8 / 64) * t))
            + 0.7 * np.outer(np.cos(2 * np.pi * s),
                             np.sin(2 * np.pi * (16 / 64) * t))
            + 0.05 * rng.standard_normal((n_x, n_t)))


@pytest.mark.parametrize("kw", [dict(n_fft=64, overlap=0.5),
                                dict(n_fft=64, overlap=0.25, n_modes=4,
                                     window="boxcar", dt=0.5),
                                dict(n_fft=50, overlap=0.5, weights="w")])
def test_spod_matches_jax(cpu_device, kw):
    x = _spod_data()
    if kw.get("weights") == "w":
        kw = dict(kw, weights=np.linspace(0.5, 2.0, x.shape[0]))
    j = crt.spod(x, **kw)
    p = port.spod(x, **kw)
    assert p.n_blocks == j.n_blocks and p.n_freq == j.n_freq
    np.testing.assert_array_equal(p.freqs, j.freqs)
    # an FFT against JAX's DFT as two GEMMs: the same sums in another
    # order, equal to 1e-12 of the largest energy in f64
    _close(p.energies, j.energies, 1e-12)
    # eigenvectors of the (B, B) Grams carry a free phase; compare each
    # kept mode by |<phi_port, phi_jax>_W| = 1 where its energy is clear of
    # the next (a degenerate pair may rotate within its plane)
    w = np.ones(x.shape[0]) if "weights" not in kw else kw["weights"]
    e = _np(j.energies)
    for f in range(p.n_freq):
        for k in range(e.shape[1] - 1):
            if e[f, k] < 1e-3 * e.max() or e[f, k] < 1.01 * e[f, k + 1]:
                continue
            a = _np(p.modes_re[f, :, k]) + 1j * _np(p.modes_im[f, :, k])
            b = _np(j.modes_re[f, :, k]) + 1j * _np(j.modes_im[f, :, k])
            assert abs(abs(np.vdot(b, w * a)) - 1.0) < 1e-9, (f, k)
    lo_p, hi_p = p.energy_interval(0.9)
    lo_j, hi_j = j.energy_interval(0.9)
    _close(lo_p, lo_j, 1e-12)
    _close(hi_p, hi_j, 1e-12)
    np.testing.assert_array_equal(p.peak_frequencies(2),
                                  j.peak_frequencies(2))


def test_spod_mesh_type_and_validation(cpu_device):
    x = _spod_data(n_t=256)
    with pytest.raises(TypeError, match="DeviceMesh"):
        port.spod(x, n_fft=32, mesh=object())
    for kw in (dict(n_fft=2), dict(overlap=1.0), dict(window="hamming")):
        with pytest.raises(ValueError):
            port.spod(x, **kw)


# ---------------------------------------------------------------------------
# operator inference

def _quadratic_states(seed=7, n_x=40, n_t=200):
    """Random latent states z (n_t, 3) of a quadratic ODE, lifted to
    x = z Q^T, with exact derivatives: a persistently exciting data set,
    so the normal equations are well conditioned (a single decaying
    trajectory makes its quadratic features nearly collinear, and the
    operators then carry the rounding of each BLAS times cond ~ 1e12)."""
    rng = _rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n_x, 3)))
    z = rng.standard_normal((n_t, 3))
    a, b, c = z.T
    zdot = np.stack([0.1 - 0.5 * a + 0.3 * b * c, -0.8 * b - 0.2 * a * a,
                     -1.1 * c + 0.4 * a * b], axis=1)
    return z @ q.T, zdot @ q.T, 0.01


@pytest.mark.parametrize("kw", [dict(), dict(include_constant=False),
                                dict(include_quadratic=False)])
def test_opinf_matches_jax(same_sketch, kw):
    x, xdot, dt = _quadratic_states()
    j = crt.OpInf(3, **kw).fit(x, dt=dt, x_dot=xdot, key=4)
    p = port.OpInf(3, **kw).fit(x, dt=dt, x_dot=xdot, key=4)
    # the POD basis' column signs may differ between the two SVDs; the
    # full-space forecast does not depend on them
    _close(p.basis_ @ p.basis_.mT, np.asarray(j.basis_) @ np.asarray(
        j.basis_).T, 1e-10)
    _close(p.predict(x[0], 50, dt), j.predict(x[0], 50, dt))
    _close(port.kron2_compressed(np.arange(1.0, 5.0)),
           crt.kron2_compressed(jnp.arange(1.0, 5.0)))
    # the finite-difference derivative of the snapshot rows
    jf = crt.OpInf(3, **kw).fit(x, dt=dt, key=4)
    pf = port.OpInf(3, **kw).fit(x, dt=dt, key=4)
    _close(pf.predict(x[0], 5, dt), jf.predict(x[0], 5, dt))


def test_opinf_with_a_given_basis_and_control(cpu_device):
    # a fixed basis takes the SVD out: the operators themselves agree
    x, xdot, dt = _quadratic_states(seed=8)
    basis = np.linalg.qr(x[:50].T)[0][:, :3]
    u = np.sin(0.1 * np.arange(x.shape[0]))[:, None]
    j = crt.OpInf(3).fit(x, dt=dt, x_dot=xdot, u=u, basis=basis)
    p = port.OpInf(3).fit(x, dt=dt, x_dot=xdot, u=u, basis=basis)
    # held together, at the operators' scale (the control column is 0 in
    # exact arithmetic: xdot does not depend on u)
    _close(torch.cat([p.c_[:, None], p.a_, p.h_, p.b_], dim=1),
           np.concatenate([np.asarray(j.c_)[:, None], j.a_, j.h_, j.b_],
                          axis=1))
    _close(p.simulate_reduced(basis.T @ x[0], 30, dt, u=u[:30]),
           j.simulate_reduced(basis.T @ x[0], 30, dt, u=u[:30]))
    _close(p.reduce(x[:4]), j.reduce(x[:4]))
    _close(p.lift(np.ones((2, 3))), j.lift(np.ones((2, 3))))
    with pytest.raises(ValueError, match="control"):
        p.simulate_reduced(basis.T @ x[0], 3, dt)


# ---------------------------------------------------------------------------
# SINDy

SIGMA, RHO, BETA = 10.0, 28.0, 8.0 / 3.0


def _lorenz(n=1500, dt=0.002):
    def rhs(v):
        return np.array([SIGMA * (v[1] - v[0]), v[0] * (RHO - v[2]) - v[1],
                         v[0] * v[1] - BETA * v[2]])

    xs = [np.array([-8.0, 8.0, 27.0])]
    for _ in range(n - 1):
        v = xs[-1]
        k1 = rhs(v)
        k2 = rhs(v + 0.5 * dt * k1)
        k3 = rhs(v + 0.5 * dt * k2)
        k4 = rhs(v + dt * k3)
        xs.append(v + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4))
    return np.stack(xs), dt


@pytest.mark.parametrize("fit_kw", [dict(), dict(weak=True, n_windows=60),
                                    dict(x_dot="exact")])
def test_sindy_lorenz_matches_jax(cpu_device, fit_kw):
    x, dt = _lorenz()
    if fit_kw.get("x_dot") == "exact":
        fit_kw = dict(x_dot=np.stack([
            SIGMA * (x[:, 1] - x[:, 0]), x[:, 0] * (RHO - x[:, 2]) - x[:, 1],
            x[:, 0] * x[:, 1] - BETA * x[:, 2]], axis=1))
    j = crt.Sindy(degree=2, threshold=0.05).fit(x, dt=dt, **fit_kw)
    p = port.Sindy(degree=2, threshold=0.05).fit(x, dt=dt, **fit_kw)
    np.testing.assert_array_equal(_np(p.mask_), np.asarray(j.mask_))
    _close(p.coefficients_, j.coefficients_)
    assert p.feature_names_ == j.feature_names_
    assert p.equations() == j.equations()
    _close(p.predict(x[:20]), j.predict(x[:20]))
    _close(p.simulate(x[0], 200, dt), j.simulate(x[0], 200, dt), 1e-9)
    assert abs(p.score(x, dt=dt) - j.score(x, dt=dt)) < 1e-12


def test_sindy_control_discrete_and_library(cpu_device):
    rng = _rng(9)
    u = rng.uniform(-1, 1, (300, 1))
    x = np.empty((300, 2))
    x[0] = [0.3, -0.2]
    for k in range(1, 300):
        a, b = x[k - 1]
        x[k] = [0.9 * a + 0.1 * b * b + 0.2 * u[k - 1, 0],
                0.8 * b - 0.05 * a]
    # no harmonics in this fit: cos(x) of small states is nearly collinear
    # with 1 and x^2, and the library below covers them
    kw = dict(degree=2, threshold=0.01, discrete=True)
    j = crt.Sindy(**kw).fit(x, u=u)
    p = port.Sindy(**kw).fit(x, u=u)
    _close(p.coefficients_, j.coefficients_)
    assert p.equations() == j.equations()
    _close(p.simulate(x[0], 40, u=u), j.simulate(x[0], 40, u=u))
    assert abs(p.score(x, u=u) - j.score(x, u=u)) < 1e-12
    from corrla_rs_tpu.models import sindy as jsindy

    e = psindy.polynomial_exponents(3, 3, include_bias=False)
    np.testing.assert_array_equal(e, jsindy.polynomial_exponents(3, 3, False))
    z = rng.standard_normal((7, 3))
    _close(psindy.evaluate_library(z, e, trig_freqs=2),
           jsindy.evaluate_library(jnp.asarray(z), e, trig_freqs=2))
    # the guarded power keeps a finite gradient at 0
    zt = torch.zeros(2, 3, dtype=torch.float64, requires_grad=True)
    psindy.evaluate_library(zt, e).sum().backward()
    assert bool(torch.isfinite(zt.grad).all())
    with pytest.raises(ValueError, match="weak"):
        port.Sindy(discrete=True).fit(x, weak=True)


# ---------------------------------------------------------------------------
# optimized DMD, BOP-DMD

def _two_tone(t, n_x=12, noise=0.0, seed=10):
    alphas = np.array([-0.02 + 1.1j, -0.02 - 1.1j, -0.3 + 2.7j, -0.3 - 2.7j])
    gen = np.random.default_rng(7)
    phi = gen.standard_normal((n_x, 4)) + 1j * gen.standard_normal((n_x, 4))
    phi[:, 1] = np.conj(phi[:, 0])
    phi[:, 3] = np.conj(phi[:, 2])
    b = np.array([1.0, 1.0, 0.6, 0.6])
    x = np.real(phi @ (b[:, None] * np.exp(np.outer(alphas, t))))
    return x + noise * _rng(seed).standard_normal(x.shape)


def test_optdmd_matches_jax(same_sketch):
    t = 0.1 * np.arange(80)
    x = _two_tone(t, noise=0.01)
    j = crt.OptDmd(x, 4, dt=0.1, key=2)
    p = port.OptDmd(x, 4, dt=0.1, key=2)
    # the same host LM on projected data equal to rounding (its iterates
    # do not depend on the projection's signs); 1e-8 for the LM's
    # data-dependent stopping
    _same_set(p.alphas, j.alphas, 1e-8)
    assert abs(p.rss - j.rss) <= 1e-8 * j.rss
    tq = np.linspace(0.0, 10.0, 37)
    _close(p.predict(tq), j.predict(tq), 1e-8)
    _close(p.eigs_discrete(0.1), j.eigs_discrete(0.1), 1e-8)
    # unequal sampling and a scalar series (the Hankel warm start)
    tu = np.sort(_rng(11).uniform(0, 8, 90))
    xu = _two_tone(tu)
    _same_set(port.OptDmd(xu, 4, t=tu, key=1).alphas,
              crt.OptDmd(xu, 4, t=tu, key=1).alphas, 1e-8)
    sig = np.sin(1.3 * t) + 0.5 * np.cos(0.4 * t)
    _same_set(port.OptDmd(sig, 4, dt=0.1).alphas,
              crt.OptDmd(sig, 4, dt=0.1).alphas, 1e-8)


def test_bop_dmd_matches_jax(same_sketch):
    t = 0.1 * np.arange(100)
    x = _two_tone(t, n_x=16, noise=0.01)
    kw = dict(dt=0.1, n_members=6, subset_frac=0.7, key=3)
    j = crt.bop_dmd(x, 4, **kw)
    p = port.bop_dmd(x, 4, **kw)
    # member subsets from numpy's generator seeded by _seed_from_key: the
    # same in both packages
    _close(p.alphas_all, j.alphas_all, 1e-8)
    _close(p.alphas_mean, j.alphas_mean, 1e-8)
    _close(p.alphas_std, j.alphas_std, 1e-6)
    for got, want in zip(p.predict_interval(t[:9]), j.predict_interval(t[:9])):
        _close(got, want, 1e-8)
    with pytest.raises(ValueError, match="n_members"):
        port.bop_dmd(x, 2, n_members=1)


# ---------------------------------------------------------------------------
# bagged DMD

def _linear_traj(rng, n=24, n_t=120, noise=1e-3):
    r, th = 0.98, 0.3
    a_low = np.zeros((3, 3))
    a_low[:2, :2] = r * np.array([[np.cos(th), -np.sin(th)],
                                  [np.sin(th), np.cos(th)]])
    a_low[2, 2] = 0.9
    q, _ = np.linalg.qr(rng.standard_normal((n, 3)))
    z = np.empty((3, n_t))
    z[:, 0] = rng.standard_normal(3) + 2.0
    for k in range(1, n_t):
        z[:, k] = a_low @ z[:, k - 1]
    return q @ z + noise * rng.standard_normal((n, n_t))


@pytest.fixture
def jax_subsets(monkeypatch):
    """The port's member subsets from JAX's ``jax.random.choice``."""
    def draw(key, n_pairs, n_sub, device):
        idx = jax.random.choice(as_key(key), n_pairs, shape=(n_sub,),
                                replace=False)
        return torch.from_numpy(np.asarray(idx, np.int64)).to(device)

    monkeypatch.setattr(pbop, "_draw_subset", draw)


def test_bagged_dmd_matches_jax(same_sketch, jax_subsets):
    x = _linear_traj(_rng(12))
    j = crt.bagged_dmd(x, 3, n_members=5, key=3)
    p = port.bagged_dmd(x, 3, n_members=5, key=3)
    _same_set(p.lambdas_ref, j.lambdas_ref, 1e-10)
    # the members' eigenproblems: torch.linalg.eig here, JAX's Francis QR
    # there (its own iteration and stopping): 1e-9 on the eigenvalues;
    # modes are rescaled onto the reference, so their scaling drops out
    _close(p.lambdas_all, j.lambdas_all, 1e-9)
    _close(p.lambdas_std, j.lambdas_std, 1e-6)
    _close(p.modes_mean, j.modes_mean, 1e-8)
    _close(p.modes_all_re, j.modes_all_re, 1e-8)
    for got, want in zip(p.predict_interval(x[:, 0], 12),
                         j.predict_interval(x[:, 0], 12)):
        _close(got, want, 1e-8)
    with pytest.raises(ValueError, match="subset_frac"):
        port.bagged_dmd(x, 3, subset_frac=0.0)


# ---------------------------------------------------------------------------
# checkpoints: a JAX-saved file of each class loads and predicts the same

def _ckpt_cases():
    lor, dt = _lorenz(600)
    t = 0.1 * np.arange(60)
    two = _two_tone(t, noise=0.01)
    bur, burdot, dtb = _quadratic_states()
    kx, ky = _koopman_pairs(_rng(13))
    rbf_x, rbf_y = _sine_pairs()
    return {
        "Edmd": (lambda m: m.Edmd(kx, degree=2, y_data=ky),
                 lambda f: f.predict(np.array([0.5, 0.1]), 6)),
        "Edmd_rbf": (lambda m: m.Edmd(rbf_x, dictionary="rbf",
                                      centers=np.linspace(0, 2.7, 9)[:, None],
                                      gamma=4.0, y_data=rbf_y),
                     lambda f: f.predict(np.array([1.1]), 6, relift=True)),
        "KernelDmd": (lambda m: m.KernelDmd(_kdmd_data(), 6, key=1),
                      lambda f: f.predict(_kdmd_data()[:, -1], 5)),
        "Spod": (lambda m: m.spod(_spod_data(n_t=512), n_fft=64),
                 lambda f: f.energy_interval(0.9)[1]),
        "OpInf": (lambda m: m.OpInf(3).fit(bur, dt=dtb, x_dot=burdot,
                                           key=2),
                  lambda f: f.predict(bur[0], 20, dtb)),
        "Sindy": (lambda m: m.Sindy(degree=2, threshold=0.05).fit(lor, dt=dt),
                  lambda f: f.simulate(lor[0], 30, dt)),
        "OptDmd": (lambda m: m.OptDmd(two, 4, dt=0.1, key=2),
                   lambda f: f.predict(t[:11])),
        "BopDmd": (lambda m: m.bop_dmd(two, 4, dt=0.1, n_members=4, key=1),
                   lambda f: f.predict(t[:11])),
        "BaggedDmd": (lambda m: m.bagged_dmd(_linear_traj(_rng(14)), 3,
                                             n_members=4, key=1),
                      lambda f: f.predict(_linear_traj(_rng(14))[:, 0], 8)),
    }


@pytest.mark.parametrize("case", sorted(_ckpt_cases()))
def test_jax_saved_checkpoint_loads_and_predicts(cpu_device, tmp_path, case):
    fit, predict = _ckpt_cases()[case]
    model = fit(crt)
    path = str(tmp_path / "m.npz")
    jck.save_model(path, model)
    back = load_jax_checkpoint(path, device="cpu")
    assert type(back).__module__.startswith("corrla_rs_tpu_torch.")
    _close(predict(back), np.asarray(predict(model)), 1e-12)
    again = pck.load_model(path, device="cpu")
    _close(predict(again), np.asarray(predict(model)), 1e-12)
    # and a port-saved file of it round-trips in the port
    pck.save_model(str(tmp_path / "p.npz"), back)
    _close(predict(pck.load_model(str(tmp_path / "p.npz"), device="cpu")),
           np.asarray(predict(model)), 1e-12)


def test_from_jax_state_carries_the_rom_models(cpu_device):
    x, y = _koopman_pairs(_rng(15))
    j = crt.Edmd(x, degree=2, y_data=y)
    p = from_jax_state("Edmd", dict(vars(j)), device="cpu")
    assert isinstance(p, port.Edmd) and p.koopman.device.type == "cpu"
    _close(p.predict(x[:, 0], 5), j.predict(x[:, 0], 5), 1e-12)
    with pytest.raises(ValueError, match="lacks"):
        from_jax_state("Spod", {"freqs": np.zeros(3)}, device="cpu")
