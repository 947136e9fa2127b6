"""Port parity: ops.kalman, ops.enkf and ops.particle against the JAX
package.

``ops.kalman`` and ``ukf_filter`` draw nothing: the same numpy input goes
through both packages and the results are held at 1e-10 (f64). The ensemble
and particle filters draw: the port's seams (``enkf._draw_normals``,
``particle._draw_offsets``) are patched with the normals and uniforms the
JAX package's keys produce, and the particle test's torch ``propagate`` pops
the process noise that JAX's per-particle keys produced; held at 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cpu_device  # noqa: F401 (fixture)
from corrla_rs_tpu.ops import enkf as jax_enkf
from corrla_rs_tpu.ops import kalman as jax_kalman
from corrla_rs_tpu.ops import particle as jax_particle
from corrla_rs_tpu_torch.ops import enkf as port_enkf
from corrla_rs_tpu_torch.ops import kalman as port_kalman
from corrla_rs_tpu_torch.ops import particle as port_particle

torch.set_num_threads(1)

TOL_EXACT, TOL_DRAWN = 1e-10, 1e-9


def tt(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def lti(rng, n=6, n_u=2, p=2, t_len=40):
    """A stable random system and a noisy record of it."""
    a = rng.standard_normal((n, n))
    a *= 0.9 / np.abs(np.linalg.eigvals(a)).max()
    b = rng.standard_normal((n, n_u))
    c = rng.standard_normal((p, n))
    d = 0.1 * rng.standard_normal((p, n_u))
    u = rng.standard_normal((n_u, t_len))
    x = np.zeros(n)
    ys = []
    for t in range(t_len):
        ys.append(c @ x + d @ u[:, t] + 0.1 * rng.standard_normal(p))
        x = a @ x + b @ u[:, t] + 0.05 * rng.standard_normal(n)
    return a, b, c, d, u, np.stack(ys, axis=1)


# -- Kalman ------------------------------------------------------------------

def test_dare_and_dlqr_match_jax(cpu_device, rng):
    a, b, c, _, _, _ = lti(rng)
    q = 0.05 ** 2 * np.eye(6)
    r = np.array([[0.02, 0.005], [0.005, 0.01]])
    close(port_kalman.dare(a, c, q, r), jax_kalman.dare(a, c, q, r),
          TOL_EXACT)
    kj, pj = jax_kalman.dlqr(a, b, 2.0, 0.5)
    kt, pt = port_kalman.dlqr(a, b, 2.0, 0.5)
    close(kt, kj, TOL_EXACT)
    close(pt, pj, TOL_EXACT)
    close(port_kalman.dlqr(a, b[:, 0], np.eye(6), 1.0, n_iters=50)[0],
          jax_kalman.dlqr(a, b[:, 0], np.eye(6), 1.0, n_iters=50)[0],
          TOL_EXACT)
    with pytest.raises(ValueError, match="shape mismatch"):
        port_kalman.dare(a, c, q[:5, :5], r)
    with pytest.raises(ValueError, match="b must be"):
        port_kalman.dlqr(a, b[:4], 1.0, 1.0)
    with pytest.raises(ValueError, match="q must be"):
        port_kalman.dlqr(a, b, np.eye(5), 1.0)


@pytest.mark.parametrize("feedthrough", [True, False])
def test_kalman_filter_and_smoother_match_jax(cpu_device, rng, feedthrough):
    a, b, c, d, u, y = lti(rng)
    d = d if feedthrough else None
    x0 = rng.standard_normal(6)
    args = (a, b, c, d, 0.05 ** 2, np.diag([0.01, 0.02]), u, y)
    oj = jax_kalman.kalman_smooth(*args, x0=x0)
    ot = port_kalman.kalman_smooth(*args, x0=x0)
    assert set(ot) == set(oj)
    for name in ("x_filt", "innovations", "gain", "innovation_cov",
                 "state_cov", "x_smooth"):
        close(ot[name], oj[name], TOL_EXACT)
    assert isinstance(ot["loglik"], float)
    assert ot["loglik"] == pytest.approx(oj["loglik"], rel=1e-10)
    of = port_kalman.kalman_filter(*args)
    assert "x_smooth" not in of
    close(of["x_filt"], jax_kalman.kalman_filter(*args)["x_filt"], TOL_EXACT)
    # the smoother never does worse than the filter against the truth-free
    # check the JAX test makes: both reproduce the record's one-step fit
    assert ot["x_smooth"].shape == ot["x_filt"].shape == (6, 40)


def test_kalman_filter_validates_and_takes_one_dimensional_records(
        cpu_device, rng):
    a, b, c, d, u, y = lti(rng, n_u=1, p=1)
    oj = jax_kalman.kalman_filter(a, b[:, 0], c, None, 0.01, 0.04, u[0], y[0])
    ot = port_kalman.kalman_filter(a, b[:, 0], c, None, 0.01, 0.04, u[0],
                                   y[0])
    close(ot["x_filt"], oj["x_filt"], TOL_EXACT)
    with pytest.raises(ValueError, match="b must be"):
        port_kalman.kalman_filter(a, b[:3], c, None, 0.01, 0.04, u, y)
    with pytest.raises(ValueError, match="d must be"):
        port_kalman.kalman_filter(a, b, c, np.zeros((2, 2)), 0.01, 0.04, u, y)
    with pytest.raises(ValueError, match="u_seq/y_seq must be"):
        port_kalman.kalman_filter(a, b, c, None, 0.01, 0.04, u[:, :-1], y)


# -- EnKF / ETKF / ES-MDA ----------------------------------------------------

def normals(key, shape):
    return tt(jax.random.normal(key, shape, jnp.float64))


R_KINDS = {"scalar": lambda p, rng: 0.3,
           "diagonal": lambda p, rng: 0.1 + rng.random(p),
           "matrix": lambda p, rng: (lambda g: g @ g.T / p + 0.2 * np.eye(p))(
               rng.standard_normal((p, p)))}


@pytest.mark.parametrize("r_kind", list(R_KINDS))
@pytest.mark.parametrize("n_ens, p", [(12, 4), (6, 10)],
                         ids=["obs-space", "more-obs-than-members"])
def test_enkf_and_etkf_analysis_match_jax(cpu_device, rng, monkeypatch,
                                          r_kind, n_ens, p):
    n = 7
    x = rng.standard_normal((n_ens, n))
    h = rng.standard_normal((p, n))
    y = rng.standard_normal(p)
    r = R_KINDS[r_kind](p, rng)
    key = jax.random.key(3)
    monkeypatch.setattr(
        port_enkf, "_draw_normals",
        lambda k, n_steps, n_e, n_s, p_, dtype, device:
            (None, normals(key, (n_e, p_))[None]))
    xj = jax_enkf.enkf_analysis(jnp.asarray(x), y, h, r, key, inflation=1.1)
    xt = port_enkf.enkf_analysis(x, y, h, r, 3, inflation=1.1)
    close(xt, xj, TOL_DRAWN)
    # a callable operator, and the square-root filter (no draws)
    close(port_enkf.enkf_analysis(x, y, lambda v: tt(h) @ v, r, 3),
          jax_enkf.enkf_analysis(jnp.asarray(x), y,
                                 lambda v: jnp.asarray(h) @ v, r, key),
          TOL_DRAWN)
    close(port_enkf.etkf_analysis(x, y, h, r, inflation=1.05),
          jax_enkf.etkf_analysis(jnp.asarray(x), y, h, r, inflation=1.05),
          TOL_DRAWN)


@pytest.mark.parametrize("method, r_kind", [("etkf", "diagonal"),
                                            ("stochastic", "diagonal"),
                                            ("stochastic", "matrix")])
def test_enkf_filter_matches_jax(cpu_device, rng, monkeypatch, method,
                                 r_kind):
    n_ens, n, p, t_len = 10, 5, 3, 12
    a = 0.95 * np.linalg.qr(rng.standard_normal((n, n)))[0]
    h = rng.standard_normal((p, n))
    x0 = rng.standard_normal((n_ens, n))
    y_seq = rng.standard_normal((t_len, p))
    r = R_KINDS[r_kind](p, rng)
    key = jax.random.key(11)

    def replay(k, n_steps, n_e, n_s, p_, dtype, device):
        z_q, z_r, run = [], [], key
        for _ in range(n_steps):
            run, k_q, k_r = jax.random.split(run, 3)
            z_q.append(normals(k_q, (n_e, n_s)))
            z_r.append(normals(k_r, (n_e, p_)))
        return torch.stack(z_q), torch.stack(z_r)

    monkeypatch.setattr(port_enkf, "_draw_normals", replay)
    kw = dict(method=method, inflation=1.02, q=0.01)
    oj = jax_enkf.enkf_filter(jnp.asarray(x0), y_seq,
                              lambda v: jnp.tanh(jnp.asarray(a) @ v), h, r,
                              key, **kw)
    ot = port_enkf.enkf_filter(x0, y_seq, lambda v: torch.tanh(tt(a) @ v), h,
                               r, 11, **kw)
    for name in ("means", "ensemble", "spread"):
        close(ot[name], oj[name], TOL_DRAWN)
    assert ot["means"].shape == (t_len, n) and ot["spread"].shape == (t_len,)


def test_esmda_matches_jax_and_validates(cpu_device, rng, monkeypatch):
    n_ens, d, p = 16, 4, 6
    g = rng.standard_normal((p, d))
    x = rng.standard_normal((n_ens, d))
    y = rng.standard_normal(p)
    key = jax.random.key(5)

    def replay(k, n_steps, n_e, n_s, p_, dtype, device):
        z, run = [], key
        for _ in range(n_steps):
            run, k_pert = jax.random.split(run)
            z.append(normals(k_pert, (n_e, p_)))
        return None, torch.stack(z)

    monkeypatch.setattr(port_enkf, "_draw_normals", replay)
    for r in (0.2, R_KINDS["matrix"](p, rng)):
        oj = jax_enkf.esmda(jnp.asarray(x),
                            lambda th: jnp.asarray(g) @ th + 0.1 * th[0] ** 2,
                            y, r, key, n_mda=3)
        ot = port_enkf.esmda(x, lambda th: tt(g) @ th + 0.1 * th[0] ** 2, y,
                             r, 5, n_mda=3)
        for name in ("ensemble", "mean", "predicted", "data_misfit"):
            close(ot[name], oj[name], TOL_DRAWN)
        assert isinstance(ot["data_misfit"], np.ndarray)
    with pytest.raises(ValueError, match=r"sum\(1/alpha\) must be 1"):
        port_enkf.esmda(x, lambda th: tt(g) @ th, y, 0.2, 5, alphas=[2, 3])
    with pytest.raises(ValueError, match="method must be"):
        port_enkf.enkf_filter(x, y[None], lambda v: v, g[:, :4], 0.2, 5,
                              method="sqrt")
    with pytest.raises(ValueError, match="needs scalar/diagonal r"):
        port_enkf.enkf_filter(x, y[None], lambda v: v, g, np.eye(p), 5)
    with pytest.raises(ValueError, match="at least 2"):
        port_enkf.enkf_analysis(x[:1], y, g, 0.2, 5)
    with pytest.raises(ValueError, match="diagonal r must have length"):
        port_enkf.etkf_analysis(x, y, g, np.ones(p + 1))
    for fn, args in ((port_enkf.enkf_analysis, (x, y, g, 0.2, 5)),
                     (port_enkf.etkf_analysis, (x, y, g, 0.2)),
                     (port_enkf.esmda, (x, lambda th: th, y, 0.2, 5))):
        # mesh= is ported: what is not a DeviceMesh is refused by name
        with pytest.raises(TypeError, match="DeviceMesh"):
            fn(*args, mesh=object())


def test_etkf_mean_and_covariance_are_the_kalman_update(cpu_device, rng):
    # the property the JAX package tests: exact mean and exact posterior
    # sample covariance (I - KH) P_b, here for the port
    n_ens, n, p = 20, 4, 3
    x = rng.standard_normal((n_ens, n))
    h = rng.standard_normal((p, n))
    y = rng.standard_normal(p)
    r = 0.5
    xa = port_enkf.etkf_analysis(x, y, h, r).numpy()
    pb = np.cov(x.T)
    k = pb @ h.T @ np.linalg.inv(h @ pb @ h.T + r * np.eye(p))
    close(xa.mean(0), x.mean(0) + k @ (y - h @ x.mean(0)), 1e-10)
    close(np.cov(xa.T), (np.eye(n) - k @ h) @ pb, 1e-10)


# -- particle filter and UKF -------------------------------------------------

def test_particle_filter_matches_jax_from_the_same_noise(cpu_device, rng,
                                                         monkeypatch):
    n_part, n, t_len = 64, 2, 15
    a = np.array([[0.9, 0.2], [-0.1, 0.8]])
    x0 = rng.standard_normal((n_part, n))
    y_seq = rng.standard_normal((t_len, 1))
    key = jax.random.key(8)

    def prop_jax(k, x):
        return jnp.asarray(a) @ x + 0.3 * jax.random.normal(k, (n,),
                                                           jnp.float64)

    def lik_jax(x, y):
        return -0.5 * jnp.sum((y - x[:1]) ** 2) / 0.25

    # the noise and the offsets of every step, by the key arithmetic of
    # corrla_rs_tpu/ops/particle.py
    noise, offsets, run = [], [], key
    for _ in range(t_len):
        run, k_prop, k_res = jax.random.split(run, 3)
        noise.append(tt(jax.vmap(
            lambda k: jax.random.normal(k, (n,), jnp.float64))(
                jax.random.split(k_prop, n_part))))
        offsets.append(float(jax.random.uniform(k_res, (), jnp.float64)))
    monkeypatch.setattr(port_particle, "_draw_offsets",
                        lambda gen, n_steps, dtype: torch.tensor(
                            offsets, dtype=dtype))
    pending = list(noise)

    def prop_torch(gen, cloud):
        assert isinstance(gen, torch.Generator) and cloud.shape == (n_part, n)
        return cloud @ tt(a).mT + 0.3 * pending.pop(0)

    def lik_torch(x, y):
        return -0.5 * torch.sum((y - x[:1]) ** 2) / 0.25

    for thresh in (0.5, 1.0):
        pending[:] = list(noise)
        oj = jax_particle.particle_filter(jnp.asarray(x0), y_seq, prop_jax,
                                          lik_jax, key,
                                          resample_threshold=thresh)
        ot = port_particle.particle_filter(x0, y_seq, prop_torch, lik_torch,
                                           8, resample_threshold=thresh)
        for name in ("means", "ess", "particles", "log_weights"):
            close(ot[name], oj[name], TOL_DRAWN)
        assert ot["loglik"] == pytest.approx(oj["loglik"], abs=1e-9)
    assert float(ot["ess"].min()) < n_part     # it did reweight
    with pytest.raises(ValueError, match=r"\(N, n\)"):
        port_particle.particle_filter(x0[0], y_seq, prop_torch, lik_torch, 8)
    with pytest.raises(ValueError, match="resample_threshold"):
        port_particle.particle_filter(x0, y_seq, prop_torch, lik_torch, 8,
                                      resample_threshold=1.5)
    with pytest.raises(TypeError, match="DeviceMesh"):
        port_particle.particle_filter(x0, y_seq, prop_torch, lik_torch, 8,
                                      mesh=object())


def test_particle_filter_propagates_with_its_own_generator(cpu_device, rng):
    # the port's contract: propagate draws the whole cloud's noise from the
    # run's generator; a linear-Gaussian model is then held to the Kalman
    # log-likelihood within the Monte-Carlo error test_particle.py allows
    a, q, r, t_len = 0.9, 0.3 ** 2, 0.5 ** 2, 40
    xs, ys, x = [], [], 0.0
    for _ in range(t_len):
        x = a * x + 0.3 * rng.standard_normal()
        ys.append(x + 0.5 * rng.standard_normal())
    y_seq = np.array(ys)[:, None]

    def propagate(gen, cloud):
        return a * cloud + 0.3 * torch.randn(cloud.shape, generator=gen,
                                             dtype=cloud.dtype)

    def loglik(x, y):
        return (-0.5 * torch.sum((y - x) ** 2) / r
                - 0.5 * np.log(2 * np.pi * r))

    out = port_particle.particle_filter(rng.standard_normal((4000, 1)),
                                        y_seq, propagate, loglik, key=2)
    ukf = port_particle.ukf_filter(np.zeros(1), 1.0, y_seq, lambda v: a * v,
                                   lambda v: v, q, r)
    assert out["loglik"] == pytest.approx(ukf["loglik"], abs=0.5)
    close(out["means"], ukf["means"], 0.05)


def test_ukf_filter_matches_jax_and_is_exact_on_a_linear_system(cpu_device,
                                                                rng):
    n, p, t_len = 3, 2, 25
    y_seq = rng.standard_normal((t_len, p))
    x0, p0 = rng.standard_normal(n), 0.5 * np.eye(n)
    m = rng.standard_normal((n, n)) * 0.4
    hm = rng.standard_normal((p, n))
    q, r = np.array([0.01, 0.02, 0.03]), 0.1
    oj = jax_particle.ukf_filter(
        x0, p0, y_seq, lambda v: jnp.tanh(jnp.asarray(m) @ v),
        lambda v: jnp.asarray(hm) @ v + 0.1 * v[:2] ** 2, q, r, alpha=0.8,
        kappa=0.5, jitter=1e-9)
    ot = port_particle.ukf_filter(
        x0, p0, y_seq, lambda v: torch.tanh(tt(m) @ v),
        lambda v: tt(hm) @ v + 0.1 * v[:2] ** 2, q, r, alpha=0.8, kappa=0.5,
        jitter=1e-9)
    close(ot["means"], oj["means"], TOL_EXACT)
    close(ot["covs"], oj["covs"], TOL_EXACT)
    assert ot["loglik"] == pytest.approx(oj["loglik"], rel=1e-10)
    # linear f and h: the UKF is the time-varying Kalman filter
    mean, cov, ll = x0.copy(), p0.copy(), 0.0
    qm, rm = np.diag(q), r * np.eye(p)
    for y in y_seq:
        mean, cov = m @ mean, m @ cov @ m.T + qm
        s = hm @ cov @ hm.T + rm
        k = cov @ hm.T @ np.linalg.inv(s)
        e = y - hm @ mean
        ll -= 0.5 * (p * np.log(2 * np.pi) + np.linalg.slogdet(s)[1]
                     + e @ np.linalg.solve(s, e))
        mean, cov = mean + k @ e, cov - k @ s @ k.T
    lin = port_particle.ukf_filter(x0, p0, y_seq, lambda v: tt(m) @ v,
                                   lambda v: tt(hm) @ v, q, r)
    close(lin["means"][-1], mean, 1e-9)
    close(lin["covs"][-1], cov, 1e-9)
    assert lin["loglik"] == pytest.approx(ll, rel=1e-9)
    with pytest.raises(ValueError, match="x0_cov must be"):
        port_particle.ukf_filter(x0, np.eye(2), y_seq, lambda v: v,
                                 lambda v: v[:2], q, r)
    with pytest.raises(ValueError, match="q must be"):
        port_particle.ukf_filter(x0, 1.0, y_seq, lambda v: v,
                                 lambda v: v[:2], np.eye(2), r)
