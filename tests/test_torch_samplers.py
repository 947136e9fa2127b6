"""Port parity: the Dirichlet rejection sampler, the log-probability
combinators, one DEMC generation (exact, from the same pre-drawn
randomness), and full sampler runs at the JAX tests' own statistical
tolerances (reference space_samplers.rs:421-570)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corrla_rs_tpu as crt
import corrla_rs_tpu_torch as port
from _torch_parity import cpu_device  # noqa: F401 (fixture)
from corrla_rs_tpu.ops import samplers as jax_samplers
from corrla_rs_tpu.utils.prng import as_key
from corrla_rs_tpu_torch import native
from corrla_rs_tpu_torch.ops import samplers as port_samplers

torch.set_num_threads(1)

# U234/U235/U238 enrichment bounds (space_samplers.rs:430-434)
BOUNDS = np.array([[0.0, 0.0026], [0.1955, 0.1995], [0.80, 0.825]])
# wide bounds: ~30% acceptance, so small chunks take several shots
WIDE = np.array([[0.0, 0.5], [0.1, 0.6], [0.0, 0.7]])


def _jax_dirichlet_draws(seed):
    """A stand-in for the port's ``_draw_dirichlet`` that returns the JAX
    package's draws: the key chain of its rejection loop (split once a
    shot), normalised exponentials or jax.random.dirichlet."""
    state = {"key": as_key(seed)}

    def draw(gen, n_rows, alphas, uniform, dtype, device):
        state["key"], sub = jax.random.split(state["key"])
        if uniform:
            e = jax.random.exponential(sub, (n_rows, alphas.shape[0]),
                                       jnp.float64)
            zs = e / jnp.sum(e, axis=1, keepdims=True)
        else:
            zs = jax.random.dirichlet(sub, jnp.asarray(alphas.numpy()),
                                      (n_rows,), dtype=jnp.float64)
        return torch.from_numpy(np.array(zs)).to(device)

    return draw


@pytest.mark.parametrize("alphas", [None, [0.7, 1.3, 2.0]])
def test_rejection_fill_is_exact_from_the_same_draws(cpu_device, monkeypatch,
                                                     alphas):
    monkeypatch.setattr(port_samplers, "_draw_dirichlet",
                        _jax_dirichlet_draws(5))
    want = np.asarray(jax_samplers.constr_dirichlet_sample(
        2 * WIDE, 150, 20, 64, 2.0, alphas=alphas, key=5))
    got = port.constr_dirichlet_sample(2 * WIDE, 150, 20, 64, 2.0,
                                       alphas=alphas, key=5)
    assert got.dtype == torch.float64 and got.shape == (150, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_samples", [8, 13, 21])
def test_constr_dirichlet(cpu_device, n_samples):
    s = port.constr_dirichlet_sample(BOUNDS, n_samples, max_zshots=500,
                                     chunk_size=20000, c_scale=1.0,
                                     key=0).numpy()
    assert s.shape == (n_samples, 3)
    np.testing.assert_allclose(s.sum(axis=1), 1.0, atol=1e-6)
    assert (s >= BOUNDS[:, 0]).all() and (s <= BOUNDS[:, 1]).all()


def test_constr_dirichlet_alphas_broadcast_and_errors(cpu_device):
    s1 = port.constr_dirichlet_sample(BOUNDS, 5, 500, 20000, 1.0,
                                      alphas=[1.0], key=1)
    s2 = port.constr_dirichlet_sample(BOUNDS, 5, 500, 20000, 1.0,
                                      alphas=[1.0, 1.0, 1.0], key=1)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)
    with pytest.raises(ValueError):
        port.constr_dirichlet_sample(BOUNDS, 5, 500, 20000, 1.0,
                                     alphas=[1.0, 2.0])
    impossible = np.array([[0.9, 1.0], [0.9, 1.0], [0.9, 1.0]])
    with pytest.raises(RuntimeError, match="only 0/4"):
        port.constr_dirichlet_sample(impossible, 4, 3, 100, 1.0, key=0)


def test_constr_dirichlet_mean_matches_jax_statistically(cpu_device):
    # 4000 draws each; coordinate means within 4 standard errors
    alphas = [0.7, 1.3, 2.0]
    t = port.constr_dirichlet_sample(WIDE, 4000, 50, 4096, 1.0,
                                     alphas=alphas, key=3).numpy()
    j = np.asarray(crt.constr_dirichlet_sample(WIDE, 4000, 50, 4096, 1.0,
                                               alphas=alphas, key=3))
    se = np.sqrt(t.var(0) / 4000 + j.var(0) / 4000)
    assert (np.abs(t.mean(0) - j.mean(0)) <= 4 * se).all()
    np.testing.assert_allclose(t.sum(1), 1.0, atol=1e-12)


def test_constr_dirichlet_host_backend(cpu_device):
    if not native.available():
        pytest.skip("needs g++ to build native/")
    s = port.constr_dirichlet_sample(BOUNDS, 10, 500, 20000, 1.0, key=4,
                                     backend="host")
    # the C++ sampler's threads fill rows in the order they finish, so its
    # rows are checked by the contract, not against the JAX call's
    assert isinstance(s, torch.Tensor) and s.shape == (10, 3)
    s = s.numpy()
    np.testing.assert_allclose(s.sum(1), 1.0, atol=1e-6)
    assert (s >= BOUNDS[:, 0]).all() and (s <= BOUNDS[:, 1]).all()


def test_ln_prob_combinators_match_jax(cpu_device):
    rng = np.random.default_rng(0)
    x = rng.dirichlet([1.0, 2.0, 3.0], size=20)
    x[:3] = [[0.0, 0.2, 0.8], [0.001, 0.197, 0.802], [0.5, 0.3, 0.2]]
    alphas = [1.5, 2.0, 0.8]
    pairs = [(port_samplers.ln_prior_uniform(BOUNDS),
              jax_samplers.ln_prior_uniform(BOUNDS)),
             (port_samplers.ln_like_dirichlet(alphas),
              jax_samplers.ln_like_dirichlet(alphas))]
    pairs.append((port_samplers.ln_like_sum(*(p[0] for p in pairs)),
                  jax_samplers.ln_like_sum(*(p[1] for p in pairs))))
    xt = torch.from_numpy(x)
    for f_port, f_jax in pairs:
        got = torch.func.vmap(f_port)(xt).numpy()
        want = np.asarray(jax.vmap(f_jax)(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        assert float(f_port(xt[1])) == pytest.approx(float(f_jax(x[1])),
                                                     rel=1e-12)


def _pairs(rng, n_chains):
    """Two distinct partners != c for each chain c."""
    out = np.zeros((n_chains, 2), np.int64)
    for c in range(n_chains):
        out[c] = rng.choice([i for i in range(n_chains) if i != c], 2,
                            replace=False)
    return out


@pytest.mark.parametrize("target", ["simplex", "gauss"])
def test_demc_generation_is_exact_from_the_same_draws(cpu_device, target):
    rng = np.random.default_rng(7)
    n_chains = 12
    if target == "simplex":
        heads = np.asarray(crt.constr_dirichlet_sample(BOUNDS, n_chains, 500,
                                                       20000, 1.0, key=1))
        lnp = [m.ln_like_sum(m.ln_like_dirichlet(np.ones(3)),
                             m.ln_prior_uniform(BOUNDS))
               for m in (port_samplers, jax_samplers)]
        fixups = [lambda x: x / torch.sum(x), lambda x: x / jnp.sum(x)]
        eps = 1e-4
    else:
        heads = rng.standard_normal((n_chains, 2))
        lnp = [lambda x: -0.5 * torch.sum(x * x),
               lambda x: -0.5 * jnp.sum(x * x)]
        fixups = [None, None]
        eps = 1e-2
    pairs = _pairs(rng, n_chains)
    jitter = rng.uniform(0, eps, heads.shape)
    u_acc = rng.uniform(size=n_chains)
    u_acc[:3] = [0.0, 0.999999, 0.5]
    lnp0 = np.array(jax.vmap(lnp[1])(jnp.asarray(heads)))
    js = jax_samplers.DemcState(jnp.asarray(heads), jnp.asarray(lnp0),
                                as_key(0), jnp.int32(3), jnp.int32(4))
    want = jax_samplers._demc_step_pre(
        js, (jnp.asarray(pairs), jnp.asarray(jitter), jnp.asarray(u_acc)),
        lnp[1], 0.8, fixups[1])
    ts = port_samplers.DemcState(torch.tensor(heads),
                                 torch.from_numpy(lnp0), None,
                                 torch.tensor(3), torch.tensor(4))
    got = port_samplers._demc_step_pre(
        ts, (torch.from_numpy(pairs), torch.from_numpy(jitter),
             torch.from_numpy(u_acc)), lnp[0], 0.8, fixups[0])
    np.testing.assert_array_equal(got.heads.numpy(), np.asarray(want.heads))
    np.testing.assert_array_equal(got.head_lnp.numpy(),
                                  np.asarray(want.head_lnp))
    assert int(got.n_accept) == int(want.n_accept)
    assert int(got.n_reject) == int(want.n_reject)
    assert int(got.n_accept) + int(got.n_reject) == 7 + n_chains
    assert 3 < int(got.n_accept) < 3 + n_chains   # some accept, some not


def _gauss_lnp(mu=2.0, std=3.0):
    def lnp_like(x):
        return -0.5 * ((x[0] - mu) / std) ** 2 - np.log(std)

    return port_samplers.ln_like_sum(
        lnp_like, port_samplers.ln_prior_uniform(np.array([[-20.0, 20.0]])))


def test_demc_gaussian(cpu_device):
    # space_samplers.rs:462-506: mu=2, std=3 at 5e-1, acceptance > 0.2
    sampler = port.DeMcSampler(_gauss_lnp(), np.zeros((8, 1)), gamma=0.8,
                               var_epsilon=1e-10, key=0)
    sampler.sample_mcmc(5000)
    samples = sampler.get_samples(2000).numpy()
    assert samples.shape == (2000 * 8, 1)
    assert abs(samples.mean() - 2.0) < 5e-1
    assert abs(samples.std(ddof=1) - 3.0) < 5e-1
    assert sampler.accept_ratio() > 0.2
    assert sampler.chain_history.shape == (5001, 8, 1)
    assert sampler.get_chain_samples(10, 3).shape == (10, 1)


def test_demc_serial_mode_gaussian(cpu_device):
    # space_samplers.rs:361-374 serial update order, same statistics
    s = port.DeMcSampler(_gauss_lnp(), np.zeros((8, 1)), gamma=0.8,
                         var_epsilon=1e-10, key=0)
    s.sample_mcmc(2000, mode="serial")
    tail = s.get_samples(1000).numpy()
    assert abs(tail.mean() - 2.0) < 5e-1
    assert abs(tail.std(ddof=1) - 3.0) < 5e-1
    assert s.accept_ratio() > 0.2
    assert s.n_accept + s.n_reject == 2000 * 8
    p = port.DeMcSampler(_gauss_lnp(), np.zeros((8, 1)), gamma=0.8,
                         var_epsilon=1e-10, key=0).sample_mcmc(50)
    q = port.DeMcSampler(_gauss_lnp(), np.zeros((8, 1)), gamma=0.8,
                         var_epsilon=1e-10, key=0).sample_mcmc(50, "serial")
    assert not torch.allclose(p.chain_history, q.chain_history)


def test_demc_dirichlet_simplex(cpu_device):
    # space_samplers.rs:509-569: samples stay on the simplex, in bounds
    seeds = port.constr_dirichlet_sample(BOUNDS, 8, 500, 20000, 1.0, key=2)
    lnp = port_samplers.ln_like_sum(port_samplers.ln_like_dirichlet(
        np.ones(3)), port_samplers.ln_prior_uniform(BOUNDS))
    sampler = port.DeMcSampler(lnp, seeds, gamma=0.8, var_epsilon=1e-10,
                               prop_fixup_fn=lambda x: x / torch.sum(x),
                               key=3)
    sampler.sample_mcmc(2000)
    tail = sampler.get_samples(250).numpy()
    np.testing.assert_allclose(tail.sum(axis=1), 1.0, atol=1e-6)
    assert (tail > BOUNDS[:, 0] - 1e-12).all()
    assert (tail < BOUNDS[:, 1] + 1e-12).all()


def test_get_samples_interleaving(cpu_device):
    # space_samplers.rs:309-323: generation-major, chain-minor; gamma=0,
    # eps=0 proposes the current state, so the chains stay put
    sampler = port.DeMcSampler(lambda x: -0.5 * torch.sum(x**2),
                               torch.arange(3.0)[:, None], gamma=0.0,
                               var_epsilon=0.0, key=0)
    sampler.sample_mcmc(4)
    out = sampler.get_samples(2).numpy()
    np.testing.assert_allclose(out[:, 0], [0.0, 1.0, 2.0, 0.0, 1.0, 2.0])
    assert sampler.get_samples(0).shape == (0, 1)   # the n_tail=0 quirk


def test_demc_run_and_step_shapes(cpu_device):
    lnp = _gauss_lnp()
    hist, state = port_samplers.demc_run(np.zeros((6, 1)), lnp, 57, 0.8,
                                         1e-3, key=1)
    assert hist.shape == (57, 6, 1)
    assert int(state.n_accept) + int(state.n_reject) == 57 * 6
    nxt = port_samplers.demc_step(state, lnp, 0.8, 1e-3)
    assert int(nxt.n_accept) + int(nxt.n_reject) == 58 * 6


def test_pick_others_batched_distinct(cpu_device):
    gen = torch.Generator().manual_seed(0)
    idx = port_samplers.pick_others_batched(gen, 16, 6, n_batch=50)
    assert idx.shape == (50, 16, 6)
    c = torch.arange(16)[None, :, None]
    assert not bool((idx == c).any())
    srt = idx.sort(dim=-1).values
    assert bool((srt[..., 1:] != srt[..., :-1]).all())
    counts = torch.zeros(16, 16)
    for b in range(50):
        counts[torch.arange(16)[:, None], idx[b]] += 1
    off = counts[~torch.eye(16, dtype=torch.bool)]
    assert float(off.mean()) == pytest.approx(50 * 6 / 15)


def test_cs_mcmc_dirichlet_sample_device_route(cpu_device):
    # a Generator seed takes the device route (lib_math_utils_py.rs:107-168)
    samples, ar = port.cs_mcmc_dirichlet_sample(
        BOUNDS, n_samples=500, n_seed_samples=8, max_zshots=500,
        chunk_size=20000, c_scale=1.0, alphas=np.ones(3), gamma=0.8,
        var_epsilon=1e-12, seed=torch.Generator().manual_seed(4))
    assert isinstance(samples, torch.Tensor)
    assert samples.shape == (500 * 8, 3)
    np.testing.assert_allclose(samples.sum(1).numpy(), 1.0, atol=1e-6)
    assert 0.0 < ar <= 1.0


def test_cs_mcmc_dirichlet_sample_host_route(cpu_device):
    if not native.available():
        pytest.skip("needs g++ to build native/")
    # int seed and few chains: the C++ pipeline, as in the JAX package,
    # whose samples come back as a numpy array
    samples, ar = port.cs_mcmc_dirichlet_sample(
        BOUNDS, n_samples=300, n_seed_samples=8, max_zshots=500,
        chunk_size=20000, c_scale=1.0, alphas=np.ones(3), gamma=0.8,
        var_epsilon=1e-12, seed=4)
    assert isinstance(samples, np.ndarray) and samples.shape == (2400, 3)
    np.testing.assert_allclose(samples.sum(1), 1.0, atol=1e-6)
    assert (samples > BOUNDS[:, 0] - 1e-12).all()
    assert (samples < BOUNDS[:, 1] + 1e-12).all()
    assert 0.3 < ar < 0.7


def test_cs_mcmc_dirichlet_sample_host_route_only_on_the_cpu(monkeypatch):
    # a caller who asks for the card gets the device route even with an int
    # seed and few chains: the C++ host pipeline is never entered
    from corrla_rs_tpu_torch.ops import samplers

    class DeviceRoute(Exception):
        pass

    def host(*args, **kwargs):
        raise AssertionError("the host route ran for a CUDA device")

    def device_route(*args, device=None, **kwargs):
        raise DeviceRoute(device)

    monkeypatch.setattr(native, "available", lambda: True)
    monkeypatch.setattr(native, "cs_dirichlet_rejection_host", host)
    monkeypatch.setattr(native, "demc_dirichlet_host", host)
    monkeypatch.setattr(samplers, "constr_dirichlet_sample", device_route)
    monkeypatch.setattr(port.api, "split_seed", lambda seed, n, dev: [0, 1])
    with pytest.raises(DeviceRoute) as route:
        port.cs_mcmc_dirichlet_sample(
            BOUNDS, n_samples=300, n_seed_samples=8, max_zshots=500,
            chunk_size=20000, c_scale=1.0, alphas=np.ones(3), gamma=0.8,
            var_epsilon=1e-12, seed=4, device="cuda")
    assert route.value.args[0] == torch.device("cuda")


def test_cs_dirichlet_sample_surface(cpu_device):
    samples = port.cs_dirichlet_sample(BOUNDS, 6, 500, 20000, 1.0, np.ones(3))
    assert samples.shape == (6, 3)
