"""Port parity: ops.dream against the JAX package.

torch cannot reproduce JAX's draws, so parity is held from the same
pre-drawn randomness: the JAX package's ``_draw_chunk`` output goes to both
packages' ``_dream_generation`` (one generation) and, through the port's
``_draw_dream`` seam, to the port's ``dream_run`` (a run). In f64 the two
agree to rounding: 1e-12 stated. The sampler as a whole, on its own draws, is
held to the target distribution.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cpu_device  # noqa: F401 (fixture)
from corrla_rs_tpu.ops import dream as jax_dream
from corrla_rs_tpu_torch.ops import dream as port_dream
from corrla_rs_tpu_torch.utils.convert import from_jax_state

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-12
FIELDS = ("heads", "head_lnp", "p_cr", "jump_dist", "n_id", "n_accept", "t")


def lnp_jax(x):
    return -0.5 * jnp.sum(x * x) - 0.1 * jnp.sum(x) ** 2


def lnp_torch(x):
    return -0.5 * torch.sum(x * x) - 0.1 * torch.sum(x) ** 2


def to_torch(rand):
    """A JAX ``_GenRand`` as the port's, integer fields as int64."""
    return port_dream._GenRand(*(torch.from_numpy(np.array(v)) for v in rand))


def assert_states_match(st_t, st_j):
    for name in FIELDS:
        np.testing.assert_allclose(
            getattr(st_t, name).numpy(), np.asarray(getattr(st_j, name)),
            rtol=0, atol=ATOL, err_msg=name)


def jax_run(heads, rand, n_gens, fixup, **kw):
    """n_gens generations of the JAX ``_dream_generation`` from ``rand``."""
    state = jax_dream.make_dream_state(jnp.asarray(heads), lnp_jax,
                                       n_cr=kw["n_cr"])
    hist = []
    for i in range(n_gens):
        state = jax_dream._dream_generation(
            state, jax_dream._GenRand(*(v[i] for v in rand)), lnp_jax,
            kw["delta_max"], kw["n_cr"], kw["gamma_jump_prob"], kw["n_adapt"],
            fixup)
        hist.append(np.asarray(state.heads))
    return np.stack(hist), state


@pytest.mark.parametrize("fixup", [False, True], ids=["plain", "fixup"])
@pytest.mark.parametrize("n_adapt", [0, 12])
def test_generations_match_jax_from_the_same_draws(cpu_device, rng,
                                                   monkeypatch, n_adapt,
                                                   fixup):
    n_chains, d, n_gens = 24, 4, 20
    kw = dict(delta_max=3, n_cr=3, gamma_jump_prob=0.2, n_adapt=n_adapt)
    heads = rng.standard_normal((n_chains, d)) * 2.0
    rand = jax_dream._draw_chunk(jax.random.key(5), n_gens, n_chains, d, 3,
                                 0.05, 1e-6, jnp.float64)
    fix_j = (lambda v: jnp.clip(v, -3.0, 3.0)) if fixup else None
    fix_t = (lambda v: torch.clamp(v, -3.0, 3.0)) if fixup else None
    hist_j, st_j = jax_run(heads, rand, n_gens, fix_j, **kw)

    # one generation: the pure function of state and draws
    rand_t = to_torch(rand)
    st0 = port_dream.make_dream_state(torch.tensor(heads), lnp_torch, n_cr=3)
    st1 = port_dream._dream_generation(
        st0, port_dream._GenRand(*(v[0] for v in rand_t)), lnp_torch, 3, 3,
        0.2, n_adapt, fix_t)
    np.testing.assert_allclose(st1.heads.numpy(), hist_j[0], rtol=0,
                               atol=ATOL)
    assert int(st1.t) == 1 and st1.n_accept.ndim == 0

    # the run: dream_run draws through its seam, chunk after chunk
    cursor = [0]

    def pre_drawn(gen, n, *_args):
        lo = cursor[0]
        cursor[0] += n
        return port_dream._GenRand(*(v[lo:lo + n] for v in rand_t))

    monkeypatch.setattr(port_dream, "_draw_dream", pre_drawn)
    monkeypatch.setattr(port_dream, "_chunk_for", lambda n: 7)  # 7 + 7 + 6
    hist_t, st_t = port_dream.dream_run(
        torch.tensor(heads), lnp_torch, n_gens, key=0, prop_fixup_fn=fix_t,
        **kw)
    assert cursor[0] == n_gens
    np.testing.assert_allclose(hist_t.numpy(), hist_j, rtol=0, atol=ATOL)
    assert_states_match(st_t, st_j)
    assert int(st_t.n_accept) > 0 and int(st_t.t) == n_gens
    if n_adapt:
        assert float((st_t.p_cr - 1 / 3).abs().max()) > 1e-3
    else:
        assert torch.equal(st_t.p_cr, torch.full((3,), 1 / 3,
                                                 dtype=torch.float64))


def test_jax_state_resumes_in_the_port(cpu_device, rng, monkeypatch):
    # a JAX run's final state crosses as numpy (utils.convert) and the
    # port carries on from it as JAX does, from the same draws
    n_chains, d = 16, 3
    kw = dict(delta_max=2, n_cr=3, gamma_jump_prob=0.2, n_adapt=30)
    heads = rng.standard_normal((n_chains, d))
    rand = jax_dream._draw_chunk(jax.random.key(2), 25, n_chains, d, 2, 0.05,
                                 1e-6, jnp.float64)
    _, st_mid = jax_run(heads, jax_dream._GenRand(*(v[:10] for v in rand)),
                        10, None, **kw)
    state_np = {k: np.asarray(v) for k, v in st_mid._asdict().items()
                if k != "key"}
    st_port = from_jax_state("DreamState", dict(state_np, key=7),
                             device="cpu")
    assert isinstance(st_port, port_dream.DreamState)
    assert st_port.key.initial_seed() == 7 and int(st_port.t) == 10
    # JAX carries on for 15 more generations
    st_j = st_mid
    for i in range(10, 25):
        st_j = jax_dream._dream_generation(
            st_j, jax_dream._GenRand(*(v[i] for v in rand)), lnp_jax, 2, 3,
            0.2, 30, None)
    rand_t = to_torch(jax_dream._GenRand(*(v[10:] for v in rand)))
    monkeypatch.setattr(port_dream, "_draw_dream", lambda gen, n, *a: rand_t)
    monkeypatch.setattr(port_dream, "_chunk_for", lambda n: 50)
    _, st_t = port_dream.dream_run(None, lnp_torch, 15, key=1,
                                   init_state=st_port, **kw)
    assert_states_match(st_t, st_j)
    with pytest.raises(ValueError, match="lacks"):
        from_jax_state("DreamState", {"heads": heads})


def test_outlier_reset_matches_jax(cpu_device, rng):
    heads = rng.standard_normal((40, 3))
    lnp = -0.5 * (heads ** 2).sum(1)
    lnp[[3, 17]] = [-60.0, -45.0]
    lnp[8] = lnp.max() + 1.0
    hj, lj, nj = jax_dream.outlier_reset(jnp.asarray(heads), jnp.asarray(lnp))
    ht, lt, nt = port_dream.outlier_reset(torch.tensor(heads),
                                          torch.tensor(lnp))
    assert int(nt) == int(nj) == 2
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(ht[3].numpy(), heads[8])


def test_draw_dream_shapes_ranges_and_seed(cpu_device):
    gen = torch.Generator().manual_seed(3)
    r = port_dream._draw_dream(gen, 6, 40, 5, 3, 0.05, 1e-6, torch.float64)
    assert r.pairs.shape == (6, 40, 6) and r.eps.shape == (6, 40, 5)
    own = torch.arange(40)[None, :, None]
    assert not bool((r.pairs == own).any())
    assert all(len(set(row.tolist())) == 6 for row in r.pairs[0])
    assert int(r.delta.min()) >= 1 and int(r.delta.max()) <= 3
    assert int(r.force.min()) >= 0 and int(r.force.max()) <= 4
    assert float(r.e.abs().max()) <= 0.05 and float(r.e.min()) < 0 < float(
        r.e.max())
    assert float(r.eps.abs().max()) < 1e-5
    for u in (r.u_cr, r.z, r.u_jump, r.u_acc):
        assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    again = port_dream._draw_dream(torch.Generator().manual_seed(3), 6, 40, 5,
                                   3, 0.05, 1e-6, torch.float64)
    assert all(torch.equal(a, b) for a, b in zip(r, again))


def test_sampler_recovers_a_correlated_gaussian(cpu_device, rng):
    # the JAX package's own test holds the covariance to 15%
    cov = np.array([[1.0, 0.6, 0.3], [0.6, 1.0, 0.5], [0.3, 0.5, 1.0]])
    prec = torch.tensor(np.linalg.inv(cov))
    s = port_dream.DreamSampler(lambda x: -0.5 * (x @ prec @ x),
                                rng.standard_normal((64, 3)) * 3.0,
                                n_adapt=100, key=1)
    s.sample_mcmc(500)
    assert s.chain_history.shape == (501, 64, 3)
    tail = s.get_samples(400).numpy()
    assert np.abs(tail.mean(0)).max() < 0.1
    assert np.abs(np.cov(tail.T) - cov).max() / np.abs(cov).max() < 0.15
    assert 0.15 < s.accept_ratio() < 0.6
    assert s.get_chain_samples(10, 2).shape == (10, 3)
    assert s.get_samples(0).shape == (0, 3)


def test_adaptation_threads_across_blocks(cpu_device, rng):
    s = port_dream.DreamSampler(lnp_torch, rng.standard_normal((12, 2)),
                                n_adapt=400, key=3)
    s.sample_mcmc(150).sample_mcmc(250)
    assert int(s._state.t) == 400
    p_adapted = s._state.p_cr.clone()
    assert float((p_adapted - 1 / 3).abs().max()) > 1e-3
    s.sample_mcmc(300)      # past n_adapt: frozen, not reset
    assert int(s._state.t) == 700
    assert torch.equal(s._state.p_cr, p_adapted)
    assert s.n_total == 700 * 12 and s.n_accept == int(s._state.n_accept)
    assert 0.0 < s.accept_ratio() <= 1.0


def test_outlier_correction_in_the_sampler(cpu_device, rng):
    init = rng.standard_normal((20, 2))
    init[-1] = [40.0, 40.0]       # one chain far out in the tail
    s = port_dream.DreamSampler(lambda x: -0.5 * torch.sum(x * x), init,
                                n_adapt=200, key=0, outlier_correct=True,
                                outlier_every=50)
    s.sample_mcmc(300)
    assert s.n_outlier_resets >= 1 and s._gens == 300
    tail = s.get_samples(100).numpy()
    assert abs(tail.mean()) < 0.3 and abs(tail.std() - 1.0) < 0.3


def test_edges(cpu_device, rng):
    heads = torch.tensor(rng.standard_normal((10, 2)))
    h, st = port_dream.dream_run(heads, lnp_torch, 0, key=0)
    assert h.shape == (0, 10, 2) and torch.equal(st.heads, heads)
    with pytest.raises(AssertionError, match="n_chains"):
        port_dream.dream_run(heads[:6], lnp_torch, 5, delta_max=3)
    # unroll belongs to the JAX signature; here it changes nothing
    h1, _ = port_dream.dream_run(heads, lnp_torch, 9, key=4, unroll=8)
    h2, _ = port_dream.dream_run(heads, lnp_torch, 9, key=4)
    assert torch.equal(h1, h2)
    # a generator as the key runs on; a state's counters stay 0-d tensors
    gen = torch.Generator().manual_seed(4)
    h3, st3 = port_dream.dream_run(heads, lnp_torch, 9, key=gen)
    assert torch.equal(h3, h1) and st3.key is gen
    assert st3.n_accept.shape == () and st3.t.dtype == torch.int64


def test_small_populations_are_not_routed_to_the_cpu():
    # numpy heads go to the default device whatever their number: without a
    # GPU every new entry point that takes numpy raises, it does not carry
    # on on the CPU
    if torch.cuda.is_available():
        return
    code = """
import numpy as np, torch, corrla_rs_tpu_torch as p
from corrla_rs_tpu_torch.ops import dream, univariate_rv as rv
x = np.random.default_rng(0).standard_normal((8, 3))
f = lambda v: -0.5 * torch.sum(v * v)
calls = {
    "make_dream_state": lambda: dream.make_dream_state(x, f),
    "dream_run": lambda: p.dream_run(x, f, 3),
    "DreamSampler": lambda: p.DreamSampler(f, x),
    "gelman_rubin": lambda: p.gelman_rubin(np.ones((8, 4, 2))),
    "NormalRv.mlfit": lambda: p.NormalRv(0., 1.).mlfit(x[:, 0]),
    "NormalRv.sample": lambda: p.NormalRv(0., 1.).sample(4),
    "build_kde": lambda: p.build_kde(0.5, x[:, 0]),
}
bad = []
for name, call in calls.items():
    try:
        call()
        bad.append(name)
    except (RuntimeError, AssertionError) as exc:
        if "cuda" not in str(exc).lower():
            bad.append(name + ": " + str(exc))
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
