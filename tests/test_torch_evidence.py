"""Port parity: ops.laplace, ops.bridge and ops.psis against the JAX package.

The port's BFGS reaches the mode by other iterates than
``jax.scipy.optimize.minimize``, so a Laplace fit is compared on what both
minimize: the mode to 1e-5, the covariance and the evidence (functions of
the mode) to 1e-6. Bridge sampling and the restarts draw their standard
normals through ``ops.random_svd._draw_sketch``, which ``same_sketch``
patches with the JAX draw, so from the same posterior draws the fixed point
agrees to 1e-9. PSIS keeps the weights on their device and fits the Pareto
tail with the same numpy arithmetic as the JAX package: 1e-12;
``importance_resample`` draws through its seam ``_draw_categorical``, fed
the JAX package's indices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cpu_device, same_sketch  # noqa: F401 (fixtures)
from corrla_rs_tpu.ops import bridge as jax_bridge
from corrla_rs_tpu.ops import laplace as jax_laplace
from corrla_rs_tpu.ops import psis as jax_psis
from corrla_rs_tpu_torch.ops import bridge as port_bridge
from corrla_rs_tpu_torch.ops import laplace as port_laplace
from corrla_rs_tpu_torch.ops import psis as port_psis
from corrla_rs_tpu_torch.utils.convert import from_jax_state

torch.set_num_threads(1)

MU = np.array([0.5, -1.0, 2.0])
COV = np.array([[1.0, 0.3, 0.1], [0.3, 0.5, -0.2], [0.1, -0.2, 2.0]])
PREC = np.linalg.inv(COV)
LOGZ = 0.5 * 3 * np.log(2 * np.pi) + 0.5 * np.linalg.slogdet(COV)[1]


def gauss_jax(x):
    dx = x - jnp.asarray(MU)
    return -0.5 * dx @ jnp.asarray(PREC) @ dx


def gauss_torch(x):
    dx = x - torch.from_numpy(MU)
    return -0.5 * dx @ torch.from_numpy(PREC) @ dx


def banana_jax(x):
    return -0.5 * (x[0] ** 2 / 4.0 + (x[1] - 0.3 * x[0] ** 2) ** 2)


def banana_torch(x):
    return -0.5 * (x[0] ** 2 / 4.0 + (x[1] - 0.3 * x[0] ** 2) ** 2)


# -- Laplace -----------------------------------------------------------------

def test_laplace_is_exact_on_a_gaussian_and_matches_jax(same_sketch):
    rj = jax_laplace.laplace_approx(gauss_jax, jnp.zeros(3))
    rt = port_laplace.laplace_approx(gauss_torch, np.zeros(3))
    np.testing.assert_allclose(rt.x_map.numpy(), MU, atol=1e-5)
    np.testing.assert_allclose(rt.x_map.numpy(), np.asarray(rj.x_map),
                               atol=1e-5)
    np.testing.assert_allclose(rt.cov.numpy(), COV, atol=1e-8)
    np.testing.assert_allclose(rt.cov.numpy(), np.asarray(rj.cov), atol=1e-6)
    np.testing.assert_allclose(rt.chol_cov.numpy(), np.linalg.cholesky(COV),
                               atol=1e-8)
    assert rt.log_evidence == pytest.approx(LOGZ, abs=1e-6)
    assert rt.log_evidence == pytest.approx(rj.log_evidence, abs=1e-6)
    assert rt.ln_post_map == pytest.approx(0.0, abs=1e-9)
    assert rt.converged is True and rt.x_map_all.shape == (1, 3)
    assert rt.x_map.dtype == torch.float64
    assert isinstance(rt.log_evidence, float)


def test_laplace_on_a_curved_posterior_matches_jax(same_sketch):
    rj = jax_laplace.laplace_approx(banana_jax, jnp.array([0.5, 0.5]))
    rt = port_laplace.laplace_approx(banana_torch, np.array([0.5, 0.5]))
    # the mode is (0, 0) and the covariance diag(4, 1); JAX's BFGS stops
    # 1e-6 short of them, so the two are compared at 1e-5
    np.testing.assert_allclose(rt.x_map.numpy(), np.asarray(rj.x_map),
                               atol=1e-5)
    np.testing.assert_allclose(rt.cov.numpy(), np.asarray(rj.cov), atol=1e-5)
    np.testing.assert_allclose(rt.cov.numpy(), np.diag([4.0, 1.0]),
                               atol=1e-5)
    assert rt.log_evidence == pytest.approx(rj.log_evidence, abs=1e-6)


def test_laplace_multistart_finds_the_dominant_mode(same_sketch):
    # test_laplace.py::test_multistart_finds_dominant_mode, with the
    # restarts drawn as the JAX package draws them
    def mix(xp, x):
        lse = jnp.logaddexp if xp is jnp else torch.logaddexp
        total = jnp.sum if xp is jnp else torch.sum
        return lse(np.log(0.9) - 0.5 * total((x + 4.0) ** 2),
                   np.log(0.1) - 0.5 * total((x - 4.0) ** 2) / 0.25)

    def mix_t(x):
        return mix(torch, x) + 0.0 * x[0]

    x0 = np.array([3.0, 3.0])
    single = port_laplace.laplace_approx(mix_t, x0)
    assert float(single.x_map[0]) > 0          # stuck at the minor mode
    multi = port_laplace.laplace_approx(mix_t, x0, n_restarts=32, spread=5.0,
                                        key=2)
    np.testing.assert_allclose(multi.x_map.numpy(), [-4.0, -4.0], atol=1e-3)
    assert multi.x_map_all.shape == (32, 2)
    mj = jax_laplace.laplace_approx(lambda x: mix(jnp, x), jnp.asarray(x0),
                                    n_restarts=32, spread=5.0, key=2)
    assert multi.log_evidence == pytest.approx(mj.log_evidence, abs=1e-5)
    # explicit starts override n_restarts
    two = port_laplace.laplace_approx(mix_t, np.array([[3.0, 3.0],
                                                       [-3.0, -3.0]]))
    assert two.x_map_all.shape == (2, 2) and float(two.x_map[0]) < 0


def test_laplace_sample_matches_jax_and_the_saddle_guard(same_sketch):
    rj = jax_laplace.laplace_approx(gauss_jax, jnp.zeros(3))
    carried = from_jax_state("LaplaceResult", {
        k: np.asarray(v) for k, v in rj._asdict().items()})
    assert isinstance(carried, port_laplace.LaplaceResult)
    assert carried.converged is True and isinstance(carried.log_evidence,
                                                    float)
    dj = jax_laplace.laplace_sample(rj, 500, key=4)
    dt = port_laplace.laplace_sample(carried, 500, key=4)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-12)
    np.testing.assert_allclose(dt.numpy().mean(0), MU, atol=0.2)
    with pytest.raises(ValueError, match="not positive definite"):
        port_laplace.laplace_approx(lambda x: -x[0] ** 2 + x[1] ** 2,
                                    np.array([0.1, 0.0]))


# -- bridge sampling ---------------------------------------------------------

def test_bridge_matches_jax_from_the_same_draws(same_sketch, rng):
    draws = rng.multivariate_normal(MU, COV, size=600)
    for n_prop in (None, 400):
        bj = jax_bridge.bridge_sampling_evidence(gauss_jax,
                                                 jnp.asarray(draws),
                                                 n_proposal=n_prop, key=3)
        bt = port_bridge.bridge_sampling_evidence(gauss_torch, draws,
                                                  n_proposal=n_prop, key=3)
        assert bt.log_evidence == pytest.approx(bj.log_evidence, abs=1e-9)
        assert bt.n_iterations == bj.n_iterations
        assert bt.converged and bj.converged
        np.testing.assert_allclose(bt.proposal_mean.numpy(),
                                   np.asarray(bj.proposal_mean), atol=1e-12)
        np.testing.assert_allclose(bt.proposal_chol.numpy(),
                                   np.asarray(bj.proposal_chol), atol=1e-12)
    # test_bridge.py::test_gaussian_evidence_exact_case's tolerance
    assert bt.log_evidence == pytest.approx(LOGZ, abs=0.05)


def test_bridge_runs_its_fixed_point_in_f64_on_f32_draws(cpu_device, rng):
    draws = rng.multivariate_normal(MU, COV, size=2000).astype(np.float32)

    def lnp(x):
        dx = x - torch.from_numpy(MU).float()
        return -0.5 * dx @ torch.from_numpy(PREC).float() @ dx

    res = port_bridge.bridge_sampling_evidence(lnp, draws, key=1)
    assert res.converged and res.proposal_mean.dtype == torch.float32
    assert res.log_evidence == pytest.approx(LOGZ, abs=0.05)


def test_bridge_validates_and_reports_no_overlap(cpu_device, rng):
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        port_bridge.bridge_sampling_evidence(gauss_torch, np.zeros(10))
    with pytest.raises(ValueError, match=r">= 4\*d draws"):
        port_bridge.bridge_sampling_evidence(gauss_torch, np.zeros((8, 3)))
    # a posterior supported where no proposal draw falls
    draws = rng.standard_normal((400, 2)) * 0.1
    res = port_bridge.bridge_sampling_evidence(
        lambda x: torch.where(x[0] > 50.0, 0.0, -np.inf) + 0.0 * x[1], draws)
    assert np.isneginf(res.log_evidence) and not res.converged
    assert res.n_iterations == 0


# -- PSIS --------------------------------------------------------------------

@pytest.mark.parametrize("n, heavy", [(2000, False), (2000, True), (40, False),
                                      (12, True)])
def test_psis_matches_jax(cpu_device, rng, n, heavy):
    x = rng.standard_normal(n) * (1.0 if not heavy else 0.6)
    # target N(0, 1) from a narrower or wider proposal
    scale = 0.6 if heavy else 1.4
    lw = -0.5 * (x * scale) ** 2 + 0.5 * x ** 2 if heavy else \
        -0.5 * x ** 2 + 0.5 * (x / scale) ** 2
    rj = jax_psis.psis(jnp.asarray(lw))
    rt = port_psis.psis(lw)
    np.testing.assert_allclose(rt.log_weights.numpy(),
                               np.asarray(rj.log_weights), atol=1e-12)
    assert rt.k_hat == pytest.approx(rj.k_hat, abs=1e-12)
    assert rt.n_tail == rj.n_tail and rt.ess == pytest.approx(rj.ess,
                                                              rel=1e-12)
    assert float(torch.exp(rt.log_weights).sum()) == pytest.approx(1.0,
                                                                    rel=1e-12)
    # a tensor in gives the weights back beside it
    assert port_psis.psis(torch.from_numpy(lw)).log_weights.device.type == \
        "cpu"


def test_psis_brings_only_the_tail_to_the_host(cpu_device, rng, monkeypatch):
    # every way a tensor's values reach numpy or a list is counted: the
    # n weights stay tensors, the Pareto fit sees the tail and the cutoff
    n = 5000
    lw = torch.from_numpy(rng.standard_normal(n) ** 2 * 0.4)
    seen = []
    for how in ("numpy", "tolist", "__array__"):
        real = getattr(torch.Tensor, how)
        monkeypatch.setattr(
            torch.Tensor, how,
            lambda self, *a, _real=real, **k: seen.append(self.numel())
            or _real(self, *a, **k))
    res = port_psis.psis(lw)
    monkeypatch.undo()
    assert res.n_tail == 213 and seen and max(seen) <= res.n_tail + 1
    assert res.log_weights.shape == (n,)
    # the smoothed tail keeps the raw weights' order
    order = torch.argsort(lw)
    assert bool((torch.diff(res.log_weights[order]) >= 0).all())


def test_psis_orders_tail_risk_and_fails_safe(cpu_device, rng):
    x = rng.standard_normal(4000)
    safe = port_psis.psis(-0.5 * x ** 2 + 0.5 * (x / 1.3) ** 2 + 0 * x)
    z = rng.standard_normal(4000) * 0.5
    risky = port_psis.psis(-0.5 * z ** 2 + 0.5 * (z / 0.5) ** 2)
    assert safe.k_hat < 0.5 < 0.7 < risky.k_hat and safe.ess > risky.ess
    tiny = port_psis.psis(np.zeros(6))
    assert tiny.k_hat == float("inf") and tiny.n_tail == 0
    with pytest.raises(ValueError, match=">= 5 weights"):
        port_psis.psis(np.zeros(4))


def test_importance_resample_matches_jax_from_the_same_indices(cpu_device,
                                                               rng,
                                                               monkeypatch):
    # proposal N(0, 1.5^2), target N(0.5, 0.8^2): test_psis.py's case
    x = rng.standard_normal((3000, 1)) * 1.5
    lw = (-0.5 * ((x[:, 0] - 0.5) / 0.8) ** 2 + 0.5 * (x[:, 0] / 1.5) ** 2)
    dj, rj = jax_psis.importance_resample(jnp.asarray(x), jnp.asarray(lw),
                                          2000, key=6)
    idx = jax.random.categorical(jax.random.key(6), rj.log_weights,
                                 shape=(2000,))
    monkeypatch.setattr(port_psis, "_draw_categorical",
                        lambda key, logw, n: torch.from_numpy(np.array(idx)))
    dt, rt = port_psis.importance_resample(x, lw, 2000, key=6)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert rt.k_hat == pytest.approx(rj.k_hat, abs=1e-12)
    monkeypatch.undo()
    own, res = port_psis.importance_resample(x, lw, 4000, key=6)
    assert res.k_hat < 0.7 and own.shape == (4000, 1)
    assert float(own.mean()) == pytest.approx(0.5, abs=0.08)
    assert float(own.std()) == pytest.approx(0.8, abs=0.08)
