"""Port parity: ops.ensemble_mcmc, ops.hmc, ops.nuts and ops.smc against the
JAX package.

torch cannot reproduce JAX's draws, so each sampler's one seam
(``_draw_stretch``, ``_draw_hmc``, ``_draw_nuts``, ``_draw_smc``) is patched
with a replay of the JAX package's own key arithmetic, and the same numpy
start goes through both packages' entry points. In f64 the histories then
agree to rounding over a few dozen generations: 1e-10 stated. HMC and NUTS
hold that over a short warmup; dual averaging feeds each generation's
acceptance back into the next step size with a gain above one (gamma = 0.05),
so over the 21 generations that reach the mass adaptation a rounding
difference grows by 2-5x a generation, and that run is held at 1e-4, which
still fails on any fault of logic (those are O(1)). For NUTS the
replay is exact too: the JAX doubling loop consumes its keys by position (the
doubling at depth j and the leaf i of its subtree always take the same
splits), so one table a generation reproduces every draw the per-chain
``while_loop`` would make. Each sampler is then held, on its own draws, to
its target at the tolerances of the JAX package's own tests
(tests/test_ensemble_mcmc.py, test_hmc.py, test_nuts.py, test_smc.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cpu_device  # noqa: F401 (fixture)
from corrla_rs_tpu.ops import ensemble_mcmc as jax_ens
from corrla_rs_tpu.ops import hmc as jax_hmc
from corrla_rs_tpu.ops import nuts as jax_nuts
from corrla_rs_tpu.ops import samplers as jax_samplers
from corrla_rs_tpu.ops import smc as jax_smc
from corrla_rs_tpu_torch.ops import ensemble_mcmc as port_ens
from corrla_rs_tpu_torch.ops import hmc as port_hmc
from corrla_rs_tpu_torch.ops import nuts as port_nuts
from corrla_rs_tpu_torch.ops import smc as port_smc
from corrla_rs_tpu_torch.utils.convert import from_jax_state

torch.set_num_threads(1)

ATOL = 1e-10
# (warmup generations, tolerance) of the gradient samplers' parity runs: a
# short warmup at rounding, and the shortest one that adapts the mass
WARMUPS = pytest.mark.parametrize("n_warmup, tol", [(6, ATOL), (21, 1e-4)],
                                  ids=["short-warmup", "mass-adapting"])
PREC = np.array([[1.5, 0.4, 0.0], [0.4, 1.0, -0.3], [0.0, -0.3, 2.0]])


def lnp_jax(x):
    return -0.5 * x @ jnp.asarray(PREC) @ x - 0.05 * jnp.sum(x) ** 4


def lnp_torch(x):
    return -0.5 * x @ torch.from_numpy(PREC) @ x - 0.05 * torch.sum(x) ** 4


def gauss_jax(x):
    """A Gaussian for the gradient samplers: its Hamiltonian flow is linear,
    so rounding differences between the packages grow linearly, where the
    quartic term above makes long trajectories chaotic (they amplify 1e-16
    to 1e-7 in twenty generations)."""
    return -0.5 * x @ jnp.asarray(PREC) @ x


def gauss_torch(x):
    return -0.5 * x @ torch.from_numpy(PREC) @ x


def tt(a):
    return torch.from_numpy(np.array(a))


# -- stretch move ------------------------------------------------------------

def stretch_replay(key):
    """``_draw_stretch`` as the JAX package draws: a split of the running
    key a chunk, then ``_draw_chunk``."""
    box = [jax.random.key(key)]

    def draw(gen, n_gens, half, dtype):
        box[0], k_draw = jax.random.split(box[0])
        rand = jax_ens._draw_chunk(k_draw, n_gens, half, jnp.float64)
        return port_ens._GenRand(*(tt(v) for v in rand))

    return draw


def test_stretch_run_matches_jax_from_the_same_draws(cpu_device, rng,
                                                     monkeypatch):
    walkers = rng.standard_normal((8, 3))
    hist_j, st_j = jax_ens.stretch_run(jnp.asarray(walkers), lnp_jax, 60,
                                       key=3)
    monkeypatch.setattr(port_ens, "_draw_stretch", stretch_replay(3))
    hist_t, st_t = port_ens.stretch_run(walkers, lnp_torch, 60, key=3)
    np.testing.assert_allclose(hist_t.numpy(), np.asarray(hist_j), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(st_t.lnp.numpy(), np.asarray(st_j.lnp),
                               rtol=0, atol=ATOL)
    assert int(st_t.n_accept) == int(st_j.n_accept)
    assert int(st_t.n_reject) == int(st_j.n_reject)
    assert st_t.n_accept.dtype == torch.int64
    # a state carried across resumes from the same walkers
    carried = from_jax_state("EnsembleState", {
        **{k: np.asarray(v) for k, v in st_j._asdict().items()
           if k != "key"}, "key": 7})
    np.testing.assert_array_equal(carried.walkers.numpy(),
                                  np.asarray(st_j.walkers))
    assert isinstance(carried.key, torch.Generator)
    assert port_ens.stretch_run(walkers, lnp_torch, 0)[0].shape == (0, 8, 3)


def test_stretch_recovers_a_gaussian_and_the_sampler_surface(cpu_device, rng):
    # tests/test_ensemble_mcmc.py::test_gaussian_recovery's target and
    # tolerances
    mu, sig = torch.tensor([1.5, -2.0]), torch.tensor([0.7, 1.3])

    def lnp(x):
        return -0.5 * torch.sum(((x - mu) / sig) ** 2)

    walkers = rng.standard_normal((32, 2)) * 0.5
    hist, state = port_ens.stretch_run(walkers.astype(np.float32), lnp, 3000,
                                       key=1)
    tail = hist[1000:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(tail.mean(0), mu.numpy(), atol=0.1)
    np.testing.assert_allclose(tail.std(0), sig.numpy(), atol=0.1)
    ar = float(state.n_accept) / float(state.n_accept + state.n_reject)
    assert 0.2 < ar < 0.9
    smp = port_ens.EnsembleSampler(lnp, walkers.astype(np.float32), key=2)
    smp.sample_mcmc(32 * 40).sample_mcmc(32 * 10)
    assert smp.chain_history.shape == (50, 32, 2)
    assert smp.get_samples(5).shape == (160, 2)
    assert 0.1 < smp.accept_ratio() < 0.95
    with pytest.raises(ValueError, match="even n_walkers"):
        port_ens.stretch_run(walkers[:5], lnp, 2)


# -- HMC ---------------------------------------------------------------------

def phase_keys(key, n_warmup, n_steps, adapt_mass=True):
    """The JAX samplers' key of every generation, by phase."""
    keys_w = jax.random.split(jax.random.key(key), n_warmup + 1)
    n1, _ = port_hmc._warmup_split(n_warmup, adapt_mass)
    return {port_hmc.WARMUP_UNIT: keys_w[1:n1 + 1],
            port_hmc.WARMUP_METRIC: keys_w[n1 + 1:],
            port_hmc.SAMPLING: jax.random.split(keys_w[0], n_steps)}


def hmc_replay(key, n_warmup, n_steps):
    keys = phase_keys(key, n_warmup, n_steps)

    def draw(gen, phase, start, n_gens, n_chains, d, n_leapfrog,
             jitter_steps, dtype):
        z, n_leap, u = [], [], []
        for k in keys[phase][start:start + n_gens]:
            k_mom, k_len, k_acc = jax.random.split(k, 3)
            z.append(jax.random.normal(k_mom, (n_chains, d), jnp.float64))
            n_leap.append(int(jax.random.randint(k_len, (), 1,
                                                 n_leapfrog + 1))
                          if jitter_steps else n_leapfrog)
            u.append(jax.random.uniform(k_acc, (n_chains,), jnp.float64))
        return port_hmc._GenRand(tt(jnp.stack(z)), n_leap, tt(jnp.stack(u)))

    return draw


@WARMUPS
@pytest.mark.parametrize("jitter", [False, True], ids=["fixed", "jittered"])
def test_hmc_run_matches_jax_from_the_same_draws(cpu_device, rng, monkeypatch,
                                                 jitter, n_warmup, tol):
    x0 = rng.standard_normal((6, 3))
    kw = dict(n_steps=10, n_warmup=n_warmup, n_leapfrog=6, key=5,
              jitter_steps=jitter)
    rj = jax_hmc.hmc_run(jnp.asarray(x0), gauss_jax, **kw)
    monkeypatch.setattr(port_hmc, "_draw_hmc", hmc_replay(5, n_warmup, 10))
    rt = port_hmc.hmc_run(x0, gauss_torch, **kw)
    np.testing.assert_allclose(rt.history.numpy(), np.asarray(rj.history),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(rt.final.numpy(), np.asarray(rj.final),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(rt.inv_mass.numpy(), np.asarray(rj.inv_mass),
                               rtol=tol)
    assert (n_warmup >= 20) == bool((rt.inv_mass != 1.0).any())
    assert rt.step_size == pytest.approx(rj.step_size, rel=tol)
    assert rt.accept_ratio == pytest.approx(rj.accept_ratio, abs=tol)
    assert rt.n_divergent == rj.n_divergent
    assert isinstance(rt.accept_ratio, float) and isinstance(rt.n_divergent,
                                                             int)


def test_hmc_recovers_a_gaussian_and_hits_its_target(cpu_device, rng):
    # test_hmc.py's anisotropic Gaussian at d = 10, and its tolerances
    d = 10
    sig = torch.from_numpy(np.geomspace(0.3, 3.0, d))

    def lnp(x):
        return -0.5 * torch.sum((x / sig) ** 2)

    res = port_hmc.hmc_run(rng.standard_normal((16, d)), lnp, n_steps=200,
                           n_warmup=200, n_leapfrog=16, key=1)
    draws = res.history.reshape(-1, d).numpy()
    np.testing.assert_allclose(draws.mean(0), 0.0, atol=0.25)
    np.testing.assert_allclose(draws.std(0), sig.numpy(), rtol=0.2, atol=0.03)
    assert res.n_divergent == 0
    assert res.accept_ratio == pytest.approx(0.8, abs=0.12)
    ratio = float(res.inv_mass.max() / res.inv_mass.min())
    assert ratio > 10.0          # the metric saw the anisotropy (100 true)
    with pytest.raises(ValueError, match=r"\(n_chains, d\)"):
        port_hmc.hmc_run(np.zeros(3), lnp, 2)
    with pytest.raises(TypeError, match="DeviceMesh"):
        port_hmc.hmc_run(np.zeros((4, d)), lnp, 2, mesh=object())


def test_hmc_counts_divergences_and_stays_finite(cpu_device, rng):
    # a step size far too large on a steep quartic: every trajectory blows
    # up, is rejected and counted, and the chains stay where they were
    def lnp(x):
        return -torch.sum(x ** 4) * 1e4

    x0 = rng.standard_normal((8, 2)) + 3.0
    res = port_hmc.hmc_run(x0, lnp, n_steps=5, n_warmup=0,
                           init_step_size=50.0, n_leapfrog=8)
    assert bool(torch.isfinite(res.history).all())
    assert res.n_divergent > 0
    np.testing.assert_array_equal(res.final.numpy(), x0)


# -- NUTS --------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def nuts_tables(k, n_chains, d, max_depth):
    """One generation's draws of the JAX ``nuts_transition`` for every
    chain, by the key arithmetic of corrla_rs_tpu/ops/nuts.py: the chain's
    key splits into momentum and loop keys; a doubling splits the loop key
    in four (next, direction, subtree, accept); a leaf splits the subtree
    key in two (next, select)."""
    n_leaf = 1 << max(max_depth - 1, 0)

    def one(key):
        k_mom, key = jax.random.split(key)
        z = jax.random.normal(k_mom, (d,), jnp.float64)
        right, u_acc, u_leaf = [], [], []
        for depth in range(max_depth):
            key, k_dir, k_sub, k_acc = jax.random.split(key, 4)
            right.append(jax.random.bernoulli(k_dir))
            u_acc.append(jax.random.uniform(k_acc, (), jnp.float64))
            row = []
            for i in range(n_leaf):
                if i < (1 << depth):
                    k_sub, k_sel = jax.random.split(k_sub)
                    row.append(jax.random.uniform(k_sel, (), jnp.float64))
                else:
                    row.append(jnp.ones((), jnp.float64))
            u_leaf.append(jnp.stack(row))
        return z, jnp.stack(right), jnp.stack(u_acc), jnp.stack(u_leaf)

    return jax.vmap(one)(jax.random.split(k, n_chains))


def nuts_replay(key, n_warmup, n_steps):
    keys = phase_keys(key, n_warmup, n_steps)

    def draw(gen, phase, start, n_gens, n_chains, d, max_depth, dtype):
        gens = [nuts_tables(k, n_chains, d, max_depth)
                for k in keys[phase][start:start + n_gens]]
        return port_nuts._GenRand(*(tt(jnp.stack(col))
                                    for col in zip(*gens)))

    return draw


@WARMUPS
def test_nuts_run_matches_jax_from_the_same_draws(cpu_device, rng,
                                                  monkeypatch, n_warmup, tol):
    x0 = rng.standard_normal((5, 3))
    kw = dict(n_steps=8, n_warmup=n_warmup, max_depth=4, key=9)
    rj = jax_nuts.nuts_run(jnp.asarray(x0), gauss_jax, **kw)
    monkeypatch.setattr(port_nuts, "_draw_nuts", nuts_replay(9, n_warmup, 8))
    rt = port_nuts.nuts_run(x0, gauss_torch, **kw)
    np.testing.assert_allclose(rt.history.numpy(), np.asarray(rj.history),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(rt.inv_mass.numpy(), np.asarray(rj.inv_mass),
                               rtol=tol)
    assert (n_warmup >= 20) == bool((rt.inv_mass != 1.0).any())
    assert rt.step_size == pytest.approx(rj.step_size, rel=tol)
    assert rt.accept_ratio == pytest.approx(rj.accept_ratio, abs=tol)
    assert rt.mean_tree_depth == pytest.approx(rj.mean_tree_depth, abs=1e-12)
    assert rt.n_divergent == rj.n_divergent
    # the trees really doubled, and not all to the same depth
    assert 1.0 < rt.mean_tree_depth < 4.0


def test_nuts_subtree_stops_on_a_divergence_under_the_mask(cpu_device, rng,
                                                           monkeypatch):
    # chains that diverge at once beside chains that do not: the dead
    # chains' NaN arithmetic must not leak through the masks (parity with
    # the JAX package on a target that blows up away from the origin)
    def lj(x):
        return -jnp.sum(x ** 4) * jnp.where(jnp.sum(x ** 2) > 4.0, 1e6, 1.0)

    def lt(x):
        return -torch.sum(x ** 4) * torch.where(torch.sum(x ** 2) > 4.0,
                                                1e6, 1.0)

    x0 = rng.standard_normal((6, 2)) * 0.5
    x0[:2] += 2.5
    kw = dict(n_steps=6, n_warmup=0, max_depth=4, key=4, init_step_size=0.3)
    rj = jax_nuts.nuts_run(jnp.asarray(x0), lj, **kw)
    monkeypatch.setattr(port_nuts, "_draw_nuts", nuts_replay(4, 0, 6))
    rt = port_nuts.nuts_run(x0, lt, **kw)
    assert rj.n_divergent > 0 and rt.n_divergent == rj.n_divergent
    np.testing.assert_allclose(rt.history.numpy(), np.asarray(rj.history),
                               rtol=0, atol=ATOL)
    assert bool(torch.isfinite(rt.history).all())


def test_nuts_recovers_a_gaussian(cpu_device, rng):
    # test_nuts.py::test_gaussian_recovery's tolerances at d = 4
    d = 4
    sig = torch.from_numpy(np.geomspace(0.4, 2.0, d))

    def lnp(x):
        return -0.5 * torch.sum((x / sig) ** 2)

    res = port_nuts.nuts_run(rng.standard_normal((16, d)), lnp, n_steps=150,
                             n_warmup=100, max_depth=6, key=1)
    draws = res.history[30:].reshape(-1, d).numpy()
    np.testing.assert_allclose(draws.mean(0), 0.0, atol=0.15)
    np.testing.assert_allclose(draws.std(0), sig.numpy(), rtol=0.15)
    assert res.n_divergent == 0
    assert 0.6 < res.accept_ratio <= 1.0
    # the JAX package doubles 0.97 times a generation on this target
    assert 0.5 <= res.mean_tree_depth <= 6.0
    with pytest.raises(TypeError, match="DeviceMesh"):
        port_nuts.nuts_run(np.zeros((4, d)), lnp, 2, mesh=object())


# -- tempered SMC ------------------------------------------------------------

D_SMC, S0, S = 3, 2.0, 0.5


def smc_fns(xp, pi=np.pi):
    total = jnp.sum if xp is jnp else torch.sum

    def ln_prior(x):
        return (-0.5 * total(x ** 2) / S0 ** 2
                - 0.5 * D_SMC * np.log(2 * pi * S0 ** 2))

    def ln_like(x):
        return (-0.5 * total(x ** 2) / S ** 2
                - 0.5 * D_SMC * np.log(2 * pi * S ** 2))

    return ln_like, ln_prior


def smc_replay(key):
    box = [jax.random.key(key)]

    def draw(gen, stage, n, d, n_mcmc, jitter, dtype):
        k_res, k_mut, box[0] = jax.random.split(box[0], 3)
        pairs, eps, u_acc = [], [], []
        for k in jax.random.split(k_mut, n_mcmc):
            k_pick, k_jit, k_acc = jax.random.split(k, 3)
            pairs.append(jax_samplers.pick_others_batched(k_pick, n, 2))
            eps.append(jax.random.uniform(k_jit, (n, d), jnp.float64, 0.0,
                                          jitter))
            u_acc.append(jax.random.uniform(k_acc, (n,), jnp.float64))
        return port_smc._StageRand(
            tt(jax.random.uniform(k_res, (), jnp.float64)),
            tt(jnp.stack(pairs)).long(), tt(jnp.stack(eps)),
            tt(jnp.stack(u_acc)))

    return draw


def test_smc_sample_matches_jax_from_the_same_draws(cpu_device, rng,
                                                    monkeypatch):
    init = S0 * rng.standard_normal((256, D_SMC))
    rj = jax_smc.smc_sample(*smc_fns(jnp), jnp.asarray(init), n_mcmc=3,
                            key=2)
    monkeypatch.setattr(port_smc, "_draw_smc", smc_replay(2))
    rt = port_smc.smc_sample(*smc_fns(torch), init, n_mcmc=3, key=2)
    assert rt.n_stages == rj.n_stages >= 3
    np.testing.assert_allclose(rt.betas.numpy(), np.asarray(rj.betas),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(rt.particles.numpy(),
                               np.asarray(rj.particles), rtol=0, atol=ATOL)
    np.testing.assert_allclose(rt.ess.numpy(), np.asarray(rj.ess), rtol=1e-9)
    np.testing.assert_allclose(rt.accept_ratios.numpy(),
                               np.asarray(rj.accept_ratios), atol=ATOL)
    assert rt.log_evidence == pytest.approx(rj.log_evidence, abs=1e-9)


def test_smc_recovers_the_conjugate_evidence_and_posterior(cpu_device, rng):
    # test_smc.py::test_gaussian_conjugate_evidence_and_posterior
    init = S0 * rng.standard_normal((4096, D_SMC))
    res = port_smc.smc_sample(*smc_fns(torch), init, n_mcmc=5, key=1)
    logz_true = -0.5 * D_SMC * np.log(2 * np.pi * (S0 ** 2 + S ** 2))
    assert res.log_evidence == pytest.approx(logz_true, abs=0.15)
    post_var = 1.0 / (1.0 / S0 ** 2 + 1.0 / S ** 2)
    p = res.particles.numpy()
    np.testing.assert_allclose(p.mean(0), 0.0, atol=0.05)
    np.testing.assert_allclose(p.var(0), post_var, rtol=0.15)
    b = res.betas.numpy()
    assert b[0] == 0.0 and b[-1] == pytest.approx(1.0, abs=1e-12)
    assert np.all(np.diff(b) > 0) and res.n_stages == len(b) - 1
    assert np.all(res.accept_ratios.numpy() > 0.1)
    with pytest.raises(RuntimeError, match="did not reach beta=1"):
        port_smc.smc_sample(*smc_fns(torch), init[:64], max_stages=1,
                            ess_target=0.99)
    with pytest.raises(TypeError, match="DeviceMesh"):
        port_smc.smc_sample(*smc_fns(torch), init[:64], mesh=object())
