"""Port parity: Grassmann interpolation and the ROM models on the DMD core
(Hankel, multi-resolution, physics-informed and online DMD, ERA/OKID,
DEIM, gappy POD, sparsity-promoting DMD) against the JAX package.

Both run on the CPU in f64 on inputs made with numpy; the randomized fits
draw the JAX package's sketches for the same keys (``same_sketch``). Each
comparison is held at the tolerance of the JAX package's own test of the
module, or tighter where both compute the same closed form.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cpu_device, same_sketch  # noqa: F401 (fixtures)
from corrla_rs_tpu.models import era as jera
from corrla_rs_tpu.models import hankel_dmd as jhankel
from corrla_rs_tpu.models import mrdmd as jmrdmd
from corrla_rs_tpu.models import online_dmd as jonline
from corrla_rs_tpu.models import pidmd as jpidmd
from corrla_rs_tpu.models.dmd import DMD as JDMD
from corrla_rs_tpu.ops import deim as jdeim
from corrla_rs_tpu.ops import gappy as jgappy
from corrla_rs_tpu.ops import grassmann as jgr
from corrla_rs_tpu.ops import spdmd as jspdmd
from corrla_rs_tpu_torch.models import era as pera
from corrla_rs_tpu_torch.models import hankel_dmd as phankel
from corrla_rs_tpu_torch.models import mrdmd as pmrdmd
from corrla_rs_tpu_torch.models import online_dmd as ponline
from corrla_rs_tpu_torch.models import pidmd as ppidmd
from corrla_rs_tpu_torch.models.dmd import DMD as PDMD
from corrla_rs_tpu_torch.ops import deim as pdeim
from corrla_rs_tpu_torch.ops import gappy as pgappy
from corrla_rs_tpu_torch.ops import grassmann as pgr
from corrla_rs_tpu_torch.ops import rbf_kernels
from corrla_rs_tpu_torch.ops import spdmd as pspdmd

torch.set_num_threads(1)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _sorted_close(got, want, tol):
    """Two spectra equal as sets: each value of one within ``tol`` of a
    value of the other (a sort would order near-equal real parts by their
    rounding)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    gap = np.abs(got[:, None] - want[None, :])
    assert gap.min(axis=1).max() <= tol and gap.min(axis=0).max() <= tol


# ---------------------------------------------------------------------------
# Grassmann

def _orth(rng, n, r):
    return np.linalg.qr(rng.standard_normal((n, r)))[0]


def _rot_basis(theta, n=40, r=3):
    """The first r axes turned by (j+1) theta in the (j, r+j) planes: a
    geodesic of G(n, r)."""
    y = np.zeros((n, r))
    for j in range(r):
        y[j, j] = np.cos((j + 1) * theta)
        y[r + j, j] = np.sin((j + 1) * theta)
    return y


def test_log_exp_angles_distance_match_jax():
    rng = np.random.default_rng(0)
    q0, q1 = _orth(rng, 50, 5), _orth(rng, 50, 5)
    stack = np.stack([q1, _orth(rng, 50, 5), q0])
    want = np.asarray(jgr.grassmann_log(jnp.asarray(q0), jnp.asarray(q1)))
    _close(pgr.grassmann_log(_t(q0), _t(q1)), want, 1e-10)
    # batched: every anchor's log in one call
    got = pgr.grassmann_log(_t(q0), _t(stack))
    for i in range(3):
        _close(got[i], jgr.grassmann_log(jnp.asarray(q0),
                                         jnp.asarray(stack[i])), 1e-10)
    _close(got[2], np.zeros((50, 5)), 1e-12)
    _close(pgr.grassmann_exp(_t(q0), _t(want)),
           jgr.grassmann_exp(jnp.asarray(q0), jnp.asarray(want)), 1e-10)
    y = pgr.grassmann_exp(_t(q0), got[0])
    _close(y @ y.mT, q1 @ q1.T, 1e-9)
    y0, y1 = _rot_basis(0.0), _rot_basis(0.3)
    _close(pgr.subspace_angles(_t(y0), _t(y1)),
           jgr.subspace_angles(jnp.asarray(y0), jnp.asarray(y1)), 1e-9)
    assert float(pgr.grassmann_distance(_t(y0), _t(y1))) == pytest.approx(
        float(np.linalg.norm([0.3, 0.6, 0.9])), abs=1e-9)


@pytest.mark.parametrize("ref,kernel,degree", [(1, "linear", 1),
                                               (2, "cubic", 1),
                                               (0, "gaussian", 0)])
def test_grassmann_interp_matches_jax(cpu_device, ref, kernel, degree):
    rng = np.random.default_rng(ref)
    thetas = np.array([0.0, 0.15, 0.3, 0.45])
    rots = [_orth(rng, 3, 3) for _ in thetas]
    bases = np.stack([_rot_basis(t) @ q for t, q in zip(thetas, rots)])
    kw = dict(ref=ref, kernel=kernel, kernel_param=2.0, poly_degree=degree)
    j = jgr.GrassmannInterp(bases, thetas[:, None], **kw)
    p = pgr.GrassmannInterp(bases, thetas[:, None], **kw)
    for theta in (np.array([0.15]), np.array([[0.1], [0.33], [0.4]])):
        _close(p(theta), j(theta), 1e-9)
    # exact at the anchors (the JAX test's tolerance on projectors)
    for t, b in zip(thetas, bases):
        y = _np(p(np.array([t])))
        np.testing.assert_allclose(y @ y.T, b @ b.T, atol=1e-7)


def test_grassmann_interp_2d_and_kernel_counts(cpu_device):
    pts = np.array([[0., 0.], [1., 0.], [0., 1.], [1., 1.], [0.5, 0.5]])
    bases = np.stack([_rot_basis(0.2 * a + 0.1 * b) for a, b in pts])
    before = (rbf_kernels.pairwise_kernel_matrix.launches,
              rbf_kernels.rbf_matvec.launches)
    p = pgr.GrassmannInterp(bases, pts, ref=4)
    y = p(np.array([0.5, 0.25]))
    truth = _rot_basis(0.2 * 0.5 + 0.1 * 0.25)
    assert float(pgr.grassmann_distance(_t(truth), y)) < 0.02
    _close(y, jgr.GrassmannInterp(bases, pts, ref=4)(np.array([0.5, 0.25])),
           1e-9)
    # on the CPU the interpolant runs the plain versions: nothing launched
    assert (rbf_kernels.pairwise_kernel_matrix.launches,
            rbf_kernels.rbf_matvec.launches) == before


def test_matvec_plan_at_millions_of_columns():
    # a Grassmann interpolant's predict: few queries, 16 anchors, n * r
    # columns; the chunks exceed gridDim.y's 65,535 and need no split, so
    # no (splits, C, M) scratch is allocated
    for itemsize, cols in ((4, 20), (8, 16)):
        for c in (2_000_000, 65535 * cols + 7):
            plan = rbf_kernels._matvec_plan(64, 16, c, 132, itemsize)
            assert plan.cols == cols and plan.splits == 1
            assert plan.col_chunks == -(-c // cols) > 65535
    # the scratch of a split plan stays bounded whatever C: splits happen
    # only below 2 blocks an SM, which bounds splits * C * M
    worst = 0
    for m in (1, 3, 512, 2000):
        for c in (1, 20, 100, 5000, 10**6):
            plan = rbf_kernels._matvec_plan(m, 100_000, c, 132, 4)
            if plan.splits > 1:
                worst = max(worst, plan.splits * c * m)
    assert 0 < worst <= 2 * 132 * 2 * 512 * 20


# ---------------------------------------------------------------------------
# Hankel DMD and mrDMD

def _two_tone(n=420):
    t = np.arange(n, dtype=float)
    return np.sin(0.5 * t) + 0.3 * np.cos(1.3 * t)


def test_hankel_dmd_matches_jax(same_sketch):
    sig = _two_tone()
    j = jhankel.HankelDmd(sig[:400], n_delays=10, n_modes=4)
    p = phankel.HankelDmd(sig[:400], n_delays=10, n_modes=4)
    _sorted_close(p.lambdas, j.lambdas, 1e-9)
    freqs = np.sort(np.abs(np.angle(p.lambdas)))
    np.testing.assert_allclose(freqs, [0.5, 0.5, 1.3, 1.3], atol=1e-8)
    _close(p.forecast(20)[0], sig[400:420], 1e-7)
    _close(p.forecast(20), j.forecast(20), 1e-8)
    _close(p.forecast(15, x_hist=sig[None, 180:200]),
           j.forecast(15, x_hist=sig[None, 180:200]), 1e-8)
    _close(p.forecast(10, method="reduced"),
           j.forecast(10, method="reduced"), 1e-8)
    assert tuple(p.state_modes()[0].shape) == (1, 4)
    _close(phankel.hankel_embed(np.arange(12.0).reshape(2, 6), 3),
           jhankel.hankel_embed(jnp.arange(12.0).reshape(2, 6), 3), 0)
    with pytest.raises(ValueError, match="x_hist"):
        p.forecast(5, x_hist=sig[None, :5])
    with pytest.raises(ValueError, match="n_delays"):
        phankel.HankelDmd(sig[:10], n_delays=0, n_modes=2)


def _transient_field(n_x=40, n_t=256):
    """Slow global oscillation plus a fast burst in the third quarter
    (the JAX package's mrDMD test field)."""
    s = np.linspace(0, 1, n_x)
    t = np.arange(n_t, dtype=float)
    ws, wf = 2 * np.pi / 512, 2 * np.pi / 16
    slow = (np.outer(np.sin(np.pi * s), np.cos(ws * t))
            + np.outer(np.cos(np.pi * s), np.sin(ws * t)))
    gate = ((t >= 128) & (t < 192)).astype(float)
    burst = (np.outer(np.cos(3 * np.pi * s), np.sin(wf * t) * gate)
             + np.outer(np.sin(3 * np.pi * s), np.cos(wf * t) * gate))
    return slow + 0.8 * burst


def test_mrdmd_matches_jax(same_sketch):
    x = _transient_field()
    j = jmrdmd.mrdmd(x, n_modes=6, max_levels=4, max_cycles=3.0)
    p = pmrdmd.mrdmd(x, n_modes=6, max_levels=4, max_cycles=3.0)
    assert (p.levels, p.t0s, p.t1s) == (j.levels, j.t0s, j.t1s)
    assert p.n_nodes >= 4 and max(p.levels) == 3
    full = _np(p.reconstruct())
    assert np.linalg.norm(full - x) / np.linalg.norm(x) < 0.25
    scale = np.abs(x).max()
    np.testing.assert_allclose(full, np.asarray(j.reconstruct()),
                               atol=1e-8 * scale)
    np.testing.assert_allclose(_np(p.reconstruct(levels=[0, 2])),
                               np.asarray(j.reconstruct(levels=[0, 2])),
                               atol=1e-8 * scale)
    # the level-0 node's spectrum; deeper nodes fit residual windows of
    # lower rank, whose spare directions are rounding in both packages
    np.testing.assert_allclose(np.sort(p.node_frequencies(0.5)[0]),
                               np.sort(j.node_frequencies(0.5)[0]),
                               atol=1e-8)
    deep = [f for lvl, f in zip(p.levels, p.node_frequencies())
            if lvl > 0 and f.size]
    assert min(np.min(np.abs(f - 2 * np.pi / 16)) for f in deep) < 0.05


def test_mrdmd_linear_system_exact(same_sketch):
    t = np.arange(128, dtype=float)
    s = np.linspace(0, 1, 16)
    x = (np.outer(np.sin(np.pi * s), np.cos(2 * np.pi * t / 512))
         + np.outer(np.cos(np.pi * s), np.sin(2 * np.pi * t / 512)))
    fit = pmrdmd.mrdmd(x, n_modes=4, max_levels=2, max_cycles=1.0)
    lvl0 = _np(fit.reconstruct(levels=[0]))
    assert np.linalg.norm(lvl0 - x) / np.linalg.norm(x) < 1e-6
    for bad, match in (({"max_levels": 0}, "max_levels"),
                       ({"max_cycles": 0.0}, "max_cycles"),
                       ({"n_modes": 0}, "n_modes")):
        kw = {"n_modes": 4, **bad}
        with pytest.raises(ValueError, match=match):
            pmrdmd.mrdmd(x, **kw)


# ---------------------------------------------------------------------------
# piDMD

def _rotation_data(rng, n_x=16, n_t=200, noise=0.0):
    q = _orth(rng, n_x, n_x)
    x = np.empty((n_x, n_t))
    x[:, 0] = rng.standard_normal(n_x)
    for k in range(1, n_t):
        x[:, k] = q @ x[:, k - 1]
    return x + noise * rng.standard_normal(x.shape)


def _self_adjoint_data(rng, sign, n_x=12, n_t=120):
    g = rng.standard_normal((n_x, n_x))
    a = (g + sign * g.T) / 2
    a = a / np.abs(np.linalg.eigvals(a)).max() * 0.97
    x = np.empty((n_x, n_t))
    x[:, 0] = rng.standard_normal(n_x)
    for k in range(1, n_t):
        x[:, k] = a @ x[:, k - 1] + 1e-3 * rng.standard_normal(n_x)
    return x


@pytest.mark.parametrize("family", ["orthogonal", "symmetric",
                                    "skewsymmetric"])
def test_pidmd_reduced_families_match_jax(same_sketch, family):
    rng = np.random.default_rng(2)
    x = (_rotation_data(rng, noise=0.01) if family == "orthogonal" else
         _self_adjoint_data(rng, 1.0 if family == "symmetric" else -1.0))
    j = jpidmd.PiDmd(x, 8, family=family, key=3)
    p = ppidmd.PiDmd(x, 8, family=family, key=3)
    # the POD basis is the JAX one up to the signs of its columns, which
    # LAPACK and XLA choose apart: A~ up to D A~ D
    _close(np.abs(_np(p.a_til)), np.abs(np.asarray(j.a_til)), 1e-9)
    _sorted_close(p.lambdas, j.lambdas, 1e-9)
    _close(p.predict_multiple(x[:, 0], 30), j.predict_multiple(x[:, 0], 30),
           1e-8)
    a_til = _np(p.a_til)
    if family == "orthogonal":
        np.testing.assert_allclose(np.abs(p.lambdas), 1.0, atol=1e-10)
    elif family == "symmetric":
        np.testing.assert_allclose(a_til, a_til.T, atol=1e-12)
        assert np.max(np.abs(p.lambdas.imag)) < 1e-10
    else:
        np.testing.assert_allclose(a_til, -a_til.T, atol=1e-12)
        assert np.max(np.abs(p.lambdas.real)) < 1e-10


def test_pidmd_diagonal_and_circulant_match_jax(cpu_device):
    rng = np.random.default_rng(4)
    gains = rng.uniform(0.5, 1.1, size=20)
    x = np.empty((20, 60))
    x[:, 0] = rng.standard_normal(20)
    for k in range(1, 60):
        x[:, k] = gains * x[:, k - 1]
    p = ppidmd.PiDmd(x, family="diagonal")
    _close(p.gains, gains, 1e-9)
    _close(p.predict_multiple(x[:, 0], 59), x[:, 1:], 1e-6)
    _close(p.predict_multiple(x[:, 0], 59),
           jpidmd.PiDmd(x, family="diagonal").predict_multiple(x[:, 0], 59),
           1e-10)
    n_x = 32
    x = np.empty((n_x, 100))
    x[:, 0] = rng.standard_normal(n_x)
    for k in range(1, 100):
        x[:, k] = np.roll(x[:, k - 1], 1)
    p = ppidmd.PiDmd(x, family="circulant")
    j = jpidmd.PiDmd(x, family="circulant")
    lam_true = np.exp(-2j * np.pi * np.arange(n_x) / n_x)
    np.testing.assert_allclose(p.lambdas, lam_true, atol=1e-8)
    np.testing.assert_allclose(p.lambdas, j.lambdas, atol=1e-10)
    _close(p.predict_multiple(x[:, 0], 40), x[:, 1:41], 1e-7)
    _close(p.predict_multiple(x[:, 0], 40), j.predict_multiple(x[:, 0], 40),
           1e-10)
    with pytest.raises(ValueError, match="family"):
        ppidmd.PiDmd(x, family="nope")
    with pytest.raises(ValueError, match="n_modes"):
        ppidmd.PiDmd(x, 0, family="orthogonal")


# ---------------------------------------------------------------------------
# ERA and OKID

def _mimo_system(rng, n=5, p=2, q=3):
    a = _orth(rng, n, n) @ np.diag(rng.uniform(0.5, 0.9, n)) @ \
        _orth(rng, n, n).T
    a = 0.5 * (a + a.T)
    return a, rng.standard_normal((n, p)), rng.standard_normal((q, n))


def _markov(a, b, c, n):
    hs = np.empty((n, c.shape[0], b.shape[1]))
    ca = c.copy()
    for k in range(n):
        hs[k] = ca @ b
        ca = ca @ a
    return hs


def _simulate(a, b, c, d, u):
    x = np.zeros(a.shape[0])
    ys = []
    for k in range(u.shape[1]):
        ys.append(c @ x + d @ u[:, k])
        x = a @ x + b @ u[:, k]
    return np.stack(ys, 1)


def test_era_matches_jax_and_recovers_the_system(same_sketch):
    rng = np.random.default_rng(5)
    a, b, c = _mimo_system(rng)
    h = _markov(a, b, c, 40)
    j = jera.era(h, 5, key=2)
    p = pera.era(h, 5, key=2)
    # balanced coordinates are the JAX ones up to the signs of the
    # singular vectors: (D A D, D B, C D)
    for name in ("a", "b", "c"):
        _close(np.abs(_np(getattr(p, name))),
               np.abs(np.asarray(getattr(j, name))), 1e-9)
    _close(p.hsv, j.hsv, 1e-9)
    _sorted_close(p.lambdas, np.linalg.eigvals(a), 1e-9)
    _close(p.impulse_response(12), h[:12], 1e-9)
    _close(p.impulse_response(12), j.impulse_response(12), 1e-10)
    u = rng.standard_normal((2, 30))
    _close(p.predict(u), _simulate(a, b, c, np.zeros((3, 2)), u), 1e-8)
    _close(p.predict(u), j.predict(u), 1e-9)
    # a start in balanced coordinates: the port's own, x0 = e_1
    x0 = np.eye(5)[0]
    h_x0 = np.stack([_np(p.c @ torch.linalg.matrix_power(p.a, k))[:, 0]
                     for k in range(4)], 1)
    _close(p.predict(np.zeros((2, 4)), x0=x0), h_x0, 1e-10)
    red = p.truncate(3)
    _close(np.abs(_np(red.a)), np.abs(np.asarray(j.truncate(3).a)), 1e-9)
    _sorted_close(red.lambdas, j.truncate(3).lambdas, 1e-9)
    with pytest.raises(ValueError, match="order"):
        p.truncate(9)
    with pytest.raises(ValueError, match="rank"):
        pera.era(h, 100)


def test_okid_and_era_okid_match_jax(same_sketch):
    rng = np.random.default_rng(6)
    a, b, c = _mimo_system(rng, n=4, p=1, q=2)
    d = rng.standard_normal((2, 1))
    u = rng.standard_normal((1, 400))
    y = _simulate(a, b, c, d, u)
    jm, jd = jera.okid(u, y, 20)
    pm, pd = pera.okid(u, y, 20)
    np.testing.assert_allclose(pm, jm, atol=1e-9)
    np.testing.assert_allclose(pd, jd, atol=1e-9)
    np.testing.assert_allclose(pm, _markov(a, b, c, 20), atol=1e-7)
    np.testing.assert_allclose(pd, d, atol=1e-8)
    j = jera.era_okid(u, y, 4, key=1)
    p = pera.era_okid(u, y, 4, key=1)
    _close(p.d, j.d, 1e-9)
    u2 = rng.standard_normal((1, 50))
    _close(p.predict(u2), _simulate(a, b, c, d, u2), 1e-6)
    _close(p.predict(u2), j.predict(u2), 1e-8)
    with pytest.raises(ValueError, match="too short"):
        pera.okid(u[:, :30], y[:, :30], 20)


# ---------------------------------------------------------------------------
# online DMD

@pytest.mark.parametrize("forgetting,batch", [(1.0, 7), (0.97, 16)])
def test_online_dmd_matches_jax(cpu_device, forgetting, batch):
    rng = np.random.default_rng(7)
    n, q, m = 6, 2, 120
    a = 0.9 * _orth(rng, n, n)
    b = rng.standard_normal((n, q))
    u = rng.standard_normal((q, m))
    x = np.empty((n, m + 1))
    x[:, 0] = rng.standard_normal(n)
    for k in range(m):
        x[:, k + 1] = a @ x[:, k] + b @ u[:, k]
    j = jonline.OnlineDmd(n, q, forgetting=forgetting)
    p = ponline.OnlineDmd(n, q, forgetting=forgetting)
    j.fit_stream(jnp.asarray(x), jnp.asarray(u), batch=batch)
    p.fit_stream(x, u, batch=batch)
    assert p.n_seen == j.n_seen == m
    _close(p._ab, j._ab, 1e-8)
    _close(p._p, j._p, 1e-6 * float(np.abs(np.asarray(j._p)).max()))
    _close(p.a, a, 1e-6)
    _close(p.b, b, 1e-6)
    lam_p, _ = p.eig()
    lam_j, _ = j.eig()
    np.testing.assert_allclose(lam_p, lam_j, atol=1e-8)
    _close(p.predict(x[:, 0], u[:, :10]),
           j.predict(jnp.asarray(x[:, 0]), jnp.asarray(u[:, :10])), 1e-8)
    # one more pair through update, and a plain (no control) model
    p.update(x[:, 5], x[:, 6], u[:, 5])
    j.update(jnp.asarray(x[:, 5]), jnp.asarray(x[:, 6]), jnp.asarray(u[:, 5]))
    _close(p._ab, j._ab, 1e-8)
    pp = ponline.OnlineDmd(n).fit_stream(x[:, :40], batch=8)
    jp = jonline.OnlineDmd(n).fit_stream(jnp.asarray(x[:, :40]), batch=8)
    _close(pp.predict(x[:, 0], n_steps=5),
           jp.predict(jnp.asarray(x[:, 0]), n_steps=5), 1e-6)
    with pytest.raises(ValueError, match="n_ctrl"):
        p.update(x[:, 0], x[:, 1])
    with pytest.raises(ValueError, match="forgetting"):
        ponline.OnlineDmd(3, forgetting=0.0)


# ---------------------------------------------------------------------------
# DEIM, gappy POD, spDMD

def test_deim_matches_jax_and_is_exact_on_span(cpu_device):
    rng = np.random.default_rng(8)
    u = _orth(rng, 200, 8)
    jp, jproj = jdeim.deim_points(jnp.asarray(u))
    pp, pproj = pdeim.deim_points(u)
    np.testing.assert_array_equal(_np(pp), np.asarray(jp))
    _close(pproj, jproj, 1e-10)
    assert len(set(_np(pp).tolist())) == 8
    fields = u @ rng.standard_normal((8, 5))
    rec = pdeim.deim_reconstruct(u, pproj, fields[_np(pp)])
    _close(rec, fields, 1e-10)


def test_gappy_reconstruct_and_oversample_match_jax(cpu_device):
    rng = np.random.default_rng(9)
    u = _orth(rng, 150, 6)
    pts, _ = pdeim.deim_points(u)
    extra_p = pgappy.oversample_points(u, pts, 6)
    extra_j = jgappy.oversample_points(jnp.asarray(u),
                                       jnp.asarray(_np(pts)), 6)
    np.testing.assert_array_equal(_np(extra_p), np.asarray(extra_j))
    assert len(set(_np(extra_p).tolist())) == 12
    c_true = rng.standard_normal((6, 3))
    vals = (u @ c_true)[_np(extra_p)] + 1e-3 * rng.standard_normal((12, 3))
    for ridge in (0.0, 1e-6):
        xp, cp = pgappy.gappy_reconstruct(u, extra_p, vals, ridge)
        xj, cj = jgappy.gappy_reconstruct(jnp.asarray(u),
                                          jnp.asarray(_np(extra_p)),
                                          jnp.asarray(vals), ridge)
        _close(xp, xj, 1e-10)
        _close(cp, cj, 1e-10)
    x1, c1 = pgappy.gappy_reconstruct(u, extra_p, vals[:, 0])
    assert tuple(x1.shape) == (150,) and tuple(c1.shape) == (6,)


def test_gappy_pod_fill_matches_jax(cpu_device):
    rng = np.random.default_rng(10)
    n, m, r = 60, 40, 3
    a = rng.standard_normal((n, r)) @ rng.standard_normal((r, m))
    mask = rng.random((n, m)) < 0.7
    fj, uj, sj = jgappy.gappy_pod_fill(jnp.asarray(a), jnp.asarray(mask), r)
    fp, up, sp = pgappy.gappy_pod_fill(a, mask, r)
    np.testing.assert_array_equal(_np(fp)[mask], a[mask])
    _close(fp, fj, 1e-8)
    _close(sp, sj, 1e-8)
    _close(up @ up.mT, np.asarray(uj) @ np.asarray(uj).T, 1e-8)
    err = np.linalg.norm(_np(fp) - a) / np.linalg.norm(a)
    assert err < 1e-4


def test_spdmd_matches_jax(same_sketch):
    rng = np.random.default_rng(11)
    n_x, m = 30, 60
    lam = np.array([0.98 * np.exp(0.2j), 0.9 * np.exp(0.7j), 0.7])
    modes = rng.standard_normal((n_x, 3)) + 1j * rng.standard_normal(
        (n_x, 3))
    t = np.arange(m)
    z = (modes[:, :2] @ (lam[:2, None] ** t)).real * 2 + np.outer(
        modes[:, 2].real, lam[2].real ** t)
    x = z + 1e-4 * rng.standard_normal(z.shape)
    gammas = [0.0, 1.0, 50.0, 1e4]
    j = jspdmd.spdmd(JDMD(x, 8), x, gammas)
    p = pspdmd.spdmd(PDMD(x, 8), x, gammas)
    np.testing.assert_array_equal(p["nnz"], j["nnz"])
    # the losses near the noise floor differ by what the rounding of the
    # two DMD fits leaves there: 1e-6 percent, 1e-8 of ||X||
    np.testing.assert_allclose(p["ploss_pct"], j["ploss_pct"], rtol=1e-6,
                               atol=1e-6)
    amp_j = np.abs(j["amplitudes"])
    np.testing.assert_allclose(np.abs(p["amplitudes"]), amp_j, rtol=1e-5,
                               atol=1e-6 * amp_j.max())
    assert p["ploss_floor_pct"] == pytest.approx(j["ploss_floor_pct"],
                                                 rel=1e-6, abs=1e-6)
    with pytest.raises(ValueError, match="gammas"):
        pspdmd.spdmd(PDMD(x, 8), x, [-1.0])
