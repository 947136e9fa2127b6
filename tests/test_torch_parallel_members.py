"""Parity of the port's member- and chain-sharded paths with the JAX package's.

The ``mesh=`` of enkf_analysis, etkf_analysis, enkf_filter, esmda,
smc_sample, hmc_run, nuts_run, particle_filter and cma_es, and the DMDc
ensemble on a DTensor sharded along the members. The port runs in spawned
gloo worlds of 2 and 4 ranks on the CPU (tests/_torch_dist.py, one world a
size for the module); the JAX package runs here on a mesh of the same size
from the 8 virtual CPU devices, and its random draws are handed to the
port's seams. Tolerances are those of the JAX tests each path is held to
(tests/test_parallel.py): HMC and NUTS by those tests' statistics, and
without warmup to the port's own single-device run on the same draws to
1e-10 over 100 generations; their warmup's reductions to 1e-12 on a fixed
history, and its departure from the single-device run shown to start at
rounding. Every replicated result is bitwise equal across the ranks.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_dist import World
from corrla_rs_tpu.parallel.mesh import CHAINS_AXIS, make_mesh
from corrla_rs_tpu.utils.prng import as_key

torch.set_num_threads(1)

SIZES = (2, 4)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    made = {n: World(n, str(tmp_path_factory.mktemp(f"world{n}")))
            for n in SIZES}
    yield made
    for world in made.values():
        world.close()


def normal(key, shape):
    return np.asarray(jax.random.normal(as_key(key), shape, jnp.float64))


def replicated(out):
    """The ranks' digests of their replicated results are one."""
    assert len({r["digest"] for r in out}) == 1


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# the EnKF family (test_parallel.py:545, 567, 583, 607)


def _analysis_setup(rng, n_ens, n, p, r):
    return {"x": rng.standard_normal((n_ens, n)),
            "y": rng.standard_normal(p), "h": rng.standard_normal((p, n)),
            "r": r, "z": normal(5, (n_ens, p))}


@pytest.mark.parametrize("n", SIZES)
def test_enkf_and_etkf_analysis_on_a_mesh(n, worlds, rng):
    from corrla_rs_tpu.ops.enkf import enkf_analysis, etkf_analysis

    a = rng.standard_normal((3, 3))
    setups = [_analysis_setup(rng, 32, 24, 3, 0.3),
              # a full R (obs space, whitened for the ETKF)
              _analysis_setup(rng, 16, 40, 3, a @ a.T + 0.5 * np.eye(3)),
              # p > N with a diagonal R: the ensemble-space Woodbury form
              _analysis_setup(rng, 8, 24, 12, 0.2 + rng.random(12))]
    out = worlds[n].run("enkf_analysis_members", setups)
    mesh = make_mesh(n)
    for st, *runs in zip(setups, *(r["runs"] for r in out)):
        want = np.asarray(enkf_analysis(st["x"], st["y"], st["h"], st["r"],
                                        jax.random.key(5), mesh=mesh))
        want_etkf = np.asarray(etkf_analysis(
            st["x"], st["y"], st["h"], st["r"], inflation=1.05, mesh=mesh))
        for r in runs:
            assert r["placements"] == ["S(0)", "S(0)"]
            assert r["local"] == (st["x"].shape[0] // n, st["x"].shape[1])
            for got in (r["enkf"], r["dtensor"], r["single"]):
                close(got, want, 1e-10, 1e-12)
            close(r["etkf"], want_etkf, 1e-10, 1e-12)
            close(r["etkf"], r["etkf_single"], 1e-10, 1e-12)
    for r in out:
        assert "divide" in r["errors"][0]
        assert "bogus" in r["errors"][1]


def _filter_draws(key, n_steps, n_ens, n, p):
    """enkf_filter's normals by the JAX package's key arithmetic."""
    z_q, z_r, run = [], [], as_key(key)
    for _ in range(n_steps):
        run, k_q, k_r = jax.random.split(run, 3)
        z_q.append(normal(k_q, (n_ens, n)))
        z_r.append(normal(k_r, (n_ens, p)))
    return np.stack(z_q), np.stack(z_r)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("method", ["etkf", "stochastic"])
def test_enkf_filter_on_a_mesh(n, method, worlds, rng):
    from corrla_rs_tpu.ops.enkf import enkf_filter

    a = 0.9 * np.eye(3) + 0.05 * rng.standard_normal((3, 3))
    h = np.eye(3)[:2]
    ys = rng.standard_normal((12, 2))
    x0 = rng.standard_normal((16, 3))
    z_q, z_r = _filter_draws(9, 12, 16, 3, 2)
    want = enkf_filter(x0, ys, lambda x: jnp.tanh(jnp.asarray(a) @ x), h,
                       0.2, jax.random.key(9), method=method, inflation=1.02,
                       q=0.01, mesh=make_mesh(n))
    out = worlds[n].run("enkf_filter_members", x0, ys, a, h, 0.2, 0.01,
                        method, z_q, z_r)
    replicated(out)
    for r in out:
        assert r["placements"] == ["S(0)"]
        for name in ("means", "spread", "ensemble"):
            close(r[name], want[name], 1e-9, 1e-11)
            close(r[name], r["single"][name], 1e-9, 1e-11)


@pytest.mark.parametrize("n", SIZES)
def test_esmda_on_a_mesh(n, worlds, rng):
    from corrla_rs_tpu.ops.enkf import esmda

    g = rng.standard_normal((5, 4))
    y = g @ rng.standard_normal(4)
    x0 = rng.standard_normal((24, 4))
    z, run = [], jax.random.key(11)
    for _ in range(4):
        run, k_pert = jax.random.split(run)
        z.append(normal(k_pert, (24, 5)))
    want = esmda(x0, lambda th: jnp.asarray(g) @ th + 0.1 * th[0] ** 2, y,
                 0.05, jax.random.key(11), n_mda=4, mesh=make_mesh(n))
    out = worlds[n].run("esmda_members", x0, g, y, 0.05, np.stack(z))
    replicated(out)
    for r in out:
        assert r["placements"] == ["S(0)", "S(0)"]
        for name in ("ensemble", "mean", "predicted"):
            close(r[name], want[name], 1e-9, 1e-11)
            close(r[name], r["single"][name], 1e-9, 1e-11)
        close(r["misfit"], want["data_misfit"], 1e-8)
        close(r["misfit"], r["single"]["data_misfit"], 1e-8)


# ---------------------------------------------------------------------------
# SMC (test_parallel.py:627)


def _smc_tables(key, n_stages, n, d, n_mcmc, jitter=1e-12):
    """smc_sample's stage tables by the JAX package's key arithmetic."""
    from corrla_rs_tpu.ops.samplers import pick_others_batched

    run, tables = as_key(key), []
    for _ in range(n_stages):
        k_res, k_mut, run = jax.random.split(run, 3)
        pairs, eps, u_acc = [], [], []
        for k in jax.random.split(k_mut, n_mcmc):
            k_pick, k_jit, k_acc = jax.random.split(k, 3)
            pairs.append(np.asarray(pick_others_batched(k_pick, n, 2)))
            eps.append(np.asarray(jax.random.uniform(k_jit, (n, d),
                                                     jnp.float64, 0.0,
                                                     jitter)))
            u_acc.append(np.asarray(jax.random.uniform(k_acc, (n,),
                                                       jnp.float64)))
        tables.append((np.asarray(jax.random.uniform(k_res, (),
                                                     jnp.float64)),
                       np.stack(pairs).astype(np.int64), np.stack(eps),
                       np.stack(u_acc)))
    return tables


@pytest.mark.parametrize("n", SIZES)
def test_smc_sample_on_a_mesh(n, worlds, rng):
    from corrla_rs_tpu.ops.smc import smc_sample

    mu = np.array([1.0, -0.5])

    def ln_like(x):
        return -0.5 * jnp.sum((x - mu) ** 2) / 0.3 ** 2

    def ln_prior(x):
        return -0.5 * jnp.sum(x ** 2 / 4.0)

    init = rng.standard_normal((128, 2)) * 2.0
    want = smc_sample(ln_like, ln_prior, jnp.asarray(init), n_mcmc=3, key=7,
                      mesh=make_mesh(n, axis_name=CHAINS_AXIS))
    tables = _smc_tables(7, want.n_stages, 128, 2, 3)
    out = worlds[n].run("smc_members", init, mu, tables)
    replicated(out)
    for r in out:
        assert r["placements"] == ["S(0)"] and "divide" in r["error"]
        assert r["n_stages"] == want.n_stages
        close(r["betas"], want.betas, 0.0, 1e-9)
        assert r["log_z"] == pytest.approx(want.log_evidence, abs=1e-8)
        close(r["particles"], want.particles, 1e-8, 1e-10)
        # the sharded run is the single-device one on the same tables
        close(r["particles"], r["single"]["particles"], 1e-8, 1e-10)
        assert r["log_z"] == pytest.approx(r["single"]["log_z"], abs=1e-8)


# ---------------------------------------------------------------------------
# HMC and NUTS (test_parallel.py:513, 658)


def _phase_keys(key, n_warmup, n_steps):
    """The JAX samplers' key of every generation, by phase."""
    from corrla_rs_tpu_torch.ops import hmc as port_hmc

    keys_w = jax.random.split(as_key(key), n_warmup + 1)
    n1, _ = port_hmc._warmup_split(n_warmup, True)
    return {port_hmc.WARMUP_UNIT: keys_w[1:n1 + 1],
            port_hmc.WARMUP_METRIC: keys_w[n1 + 1:],
            port_hmc.SAMPLING: jax.random.split(keys_w[0], n_steps)}


def _hmc_generation(k, n_chains, d):
    k_mom, _, k_acc = jax.random.split(k, 3)
    return (jax.random.normal(k_mom, (n_chains, d), jnp.float64),
            jax.random.uniform(k_acc, (n_chains,), jnp.float64))


def _nuts_chain(key, d, max_depth):
    """One chain's draws of a JAX NUTS generation (the key arithmetic of
    tests/test_torch_mcmc.py's ``nuts_tables``, the leaves as a scan)."""
    n_leaf = 1 << (max_depth - 1)

    def leaf(k_sub, _):
        k_sub, k_sel = jax.random.split(k_sub)
        return k_sub, jax.random.uniform(k_sel, (), jnp.float64)

    k_mom, key = jax.random.split(key)
    right, u_acc, u_leaf = [], [], []
    for depth in range(max_depth):
        key, k_dir, k_sub, k_acc = jax.random.split(key, 4)
        right.append(jax.random.bernoulli(k_dir))
        u_acc.append(jax.random.uniform(k_acc, (), jnp.float64))
        _, row = jax.lax.scan(leaf, k_sub, None, length=n_leaf)
        u_leaf.append(jnp.where(jnp.arange(n_leaf) < (1 << depth), row, 1.0))
    return (jax.random.normal(k_mom, (d,), jnp.float64), jnp.stack(right),
            jnp.stack(u_acc), jnp.stack(u_leaf))


@functools.lru_cache(maxsize=None)
def _jax_tables(sampler, key, n_chains, d, n_warmup, n_steps):
    """The sampler's draw table of every generation, by phase, by the JAX
    package's key arithmetic: HMC (z, n_leap, u_acc) at 32 fixed leapfrog
    steps; NUTS (z, go_right, u_acc, u_leaf) at depth 8."""
    if sampler == "hmc":
        one = jax.jit(jax.vmap(lambda k: _hmc_generation(k, n_chains, d)))
    else:
        one = jax.jit(jax.vmap(lambda k: jax.vmap(
            lambda c: _nuts_chain(c, d, 8))(jax.random.split(k, n_chains))))
    tables = {}
    for phase, keys in _phase_keys(key, n_warmup, n_steps).items():
        cols = [np.asarray(c) for c in one(keys)]
        if sampler == "hmc":
            cols.insert(1, [32] * len(keys))
        tables[phase] = tuple(cols)
    return tables


def _jax_chains(sampler, n_steps, n):
    """(step size, inverse mass, history) of the JAX package's run of the
    chain samplers' test on a mesh of n."""
    from corrla_rs_tpu.ops.hmc import hmc_run
    from corrla_rs_tpu.ops.nuts import nuts_run

    run = {"hmc": hmc_run, "nuts": nuts_run}[sampler]
    res = run(normal(3, (16, 2)), _lnp_sig, n_steps=n_steps, n_warmup=100,
              key=4, mesh=make_mesh(n, axis_name=CHAINS_AXIS))
    return res.step_size, np.asarray(res.inv_mass), np.asarray(res.history)


def _lnp_sig(x):
    return -0.5 * jnp.sum((x / jnp.asarray(SIG)) ** 2)


SIG = np.array([0.5, 2.0])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("sampler,n_steps,burn,vs_single",
                         [("hmc", 200, 50, 0.15), ("nuts", 150, 25, 0.2)])
def test_chain_samplers_on_a_mesh(n, sampler, n_steps, burn, vs_single,
                                  worlds):
    """The statistics of the JAX tests (which hold JAX's sharded run to its
    single-device one), the sharded port on the JAX package's draws: its
    samples, its adapted step size and its inverse mass against the JAX
    sharded run's (NUTS's warmup to 1e-10). Then 100 generations without
    warmup against the single-device port on the same torch draws to
    1e-10. HMC's warmup turns the last bit of a cross-chain sum, whose
    order the sharding changes, into an O(1) difference of the adapted
    step size on this 16-chain target, as a one-ulp nudge does on one
    device (test_chain_warmup_departs_at_rounding)."""
    x0 = normal(3, (16, 2))
    tables = _jax_tables(sampler, 4, 16, 2, 100, n_steps)
    out = worlds[n].run("chains_members", x0, SIG, n_steps, 100, 4, sampler,
                        tables)
    replicated(out)
    step, inv_mass, hist = _jax_chains(sampler, n_steps, n)
    std_jax = hist[burn:].reshape(-1, 2).std(0)
    for r in out:
        assert r["placements"] == ["S(1)", "S(0)"] and "divide" in r["error"]
        std = r["history"][burn:].reshape(-1, 2).std(0)
        close(std, SIG, 0.25)
        close(std, std_jax, vs_single)
        assert r["step"] == pytest.approx(step, rel=0.15)
        if sampler == "nuts":
            # its warmup stays within rounding of JAX's sharded run
            close(r["inv_mass"], inv_mass, 1e-10)
            assert r["step"] == pytest.approx(step, rel=1e-10)
        else:
            # a statistic of the warmup's draws after the departure
            # test_chain_warmup_departs_at_rounding shows: held to the
            # variance band the std's rtol 0.25 gives, (1 +- 0.25)^2
            close(r["inv_mass"], SIG ** 2, 0.5625)
        close(r["cold"][0], r["cold"][1], 0.0, 1e-10)


@pytest.mark.parametrize("n", SIZES)
def test_chain_warmup_reductions(n, worlds, rng):
    """The warmup's cross-chain reductions, the inverse mass from a fixed
    warm history and the mean of a fixed acceptance vector, summed over
    the ranks against one device."""
    hist = rng.standard_normal((66, 16, 2)) * SIG
    a_stat = rng.random(16)
    out = worlds[n].run("chain_reductions", hist, a_stat)
    replicated(out)
    want = hist[33:].reshape(-1, 2).var(0) + 1e-6
    for r in out:
        mass, a_mean = r["single"]
        close(mass, want, 1e-12)
        assert a_mean == pytest.approx(a_stat.mean(), rel=1e-12)
        close(r["inv_mass"], mass, 1e-12)
        assert r["a_mean"] == pytest.approx(a_mean, rel=1e-12)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_chain_warmup_departs_at_rounding(n, sampler, worlds):
    """The witness that the sharded warmup differs from the single-device
    one by rounding alone, on the same torch draws and the chain
    samplers' test target: the two runs agree bit for bit until the first
    generation whose acceptance statistic (a cross-chain sum) differs,
    and there it differs by a few ulps. NUTS stays within rounding over
    the whole warmup; HMC's step size departs from the single-device
    run's as the single-device run's own does when its first statistic
    is moved by one ulp."""
    out = worlds[n].run("warmup_trace", normal(3, (16, 2)), SIG, 10, 100,
                        4, sampler, sampler == "hmc")
    replicated([{"digest": r["sharded"]["trace"].tobytes()} for r in out])
    r = out[0]
    got, single = r["sharded"]["trace"], r["single"]["trace"]
    differs = np.flatnonzero(np.any(got != single, axis=1))
    k = differs[0]
    assert got[k, 0] == single[k, 0]
    assert abs(got[k, 1] - single[k, 1]) <= 4 * np.spacing(single[k, 1])
    dep = np.abs(got[:, 0] / single[:, 0] - 1.0)
    if sampler == "nuts":
        assert dep.max() < 1e-12
        close(r["sharded"]["inv_mass"], r["single"]["inv_mass"], 1e-12)
        assert r["sharded"]["step"] == pytest.approx(r["single"]["step"],
                                                     rel=1e-12)
    else:
        # the same growth as one ulp's on one device, up to generation 20
        dep_nudged = np.abs(r["nudged"]["trace"][:, 0] / single[:, 0] - 1.0)
        assert np.all(dep[:21] <= 10.0 * dep_nudged[:21] + 1e-14)
        assert dep[20] > 1e-8


# ---------------------------------------------------------------------------
# the particle filter (test_parallel.py:741)


def _pf_setup(rng, n_part=64, t_len=15):
    ys = rng.standard_normal((t_len, 1))
    x0 = rng.standard_normal((n_part, 1))
    noise, offsets, run = [], [], jax.random.key(3)
    for _ in range(t_len):
        run, k_prop, k_res = jax.random.split(run, 3)
        noise.append(np.asarray(jax.vmap(
            lambda k: jax.random.normal(k, (1,), jnp.float64))(
                jax.random.split(k_prop, n_part))))
        offsets.append(float(jax.random.uniform(k_res, (), jnp.float64)))
    return x0, ys, noise, np.array(offsets)


@pytest.mark.parametrize("n", SIZES)
def test_particle_filter_on_a_mesh(n, worlds, rng):
    from corrla_rs_tpu.ops.particle import particle_filter

    def propagate(k, x):
        return 0.8 * x + 0.3 * jax.random.normal(k, x.shape, x.dtype)

    def loglik(x, y):
        return -0.5 * jnp.sum((y - x) ** 2) / 0.25

    x0, ys, noise, offsets = _pf_setup(rng)
    out = worlds[n].run("particle_members", x0, ys, noise, offsets)
    for thresh in (0.5, 1.0):
        want = particle_filter(jnp.asarray(x0), ys, propagate, loglik,
                               jax.random.key(3), resample_threshold=thresh,
                               mesh=make_mesh(n))
        replicated([r[thresh] for r in out])
        for r in out:
            got = r[thresh]
            assert got["placements"] == ["S(0)"]
            for name in ("means", "ess", "particles", "log_weights"):
                close(got[name], want[name], 1e-9, 1e-11)
                close(got[name], got["single"][name], 1e-9, 1e-11)
            assert got["loglik"] == pytest.approx(want["loglik"], rel=1e-9)
    for r in out:
        assert "divide" in r["error"]


def test_particle_filter_generators_on_a_mesh(worlds, rng):
    """Each rank draws its process noise from a generator of its own: the
    ranks' clouds are not copies of one another, and the first rank's
    draws are the run's generator's."""
    x0 = rng.standard_normal((64, 2))
    ys = rng.standard_normal((6, 2))
    for n in SIZES:
        out = worlds[n].run("particle_generator", x0, ys)
        for r in out:
            parts = r["particles"].reshape(n, -1, 2)
            assert len({blk.tobytes() for blk in parts}) == n
            assert np.all(np.isfinite(r["means"]))


# ---------------------------------------------------------------------------
# CMA-ES (test_parallel.py:683)


def _canonical_eigh(a):
    """``jnp.linalg.eigh`` with each eigenvector's largest entry made
    positive: LAPACK in torch and XLA choose the signs apart, and the
    candidates follow them, so both packages get this rule."""
    w, v = _JNP_EIGH(a)
    idx = jnp.argmax(jnp.abs(v), axis=-2, keepdims=True)
    return w, v * jnp.sign(jnp.take_along_axis(v, idx, axis=-2))


_JNP_EIGH = jnp.linalg.eigh


@pytest.mark.parametrize("n", SIZES)
def test_cma_es_on_a_mesh(n, worlds, monkeypatch):
    from corrla_rs_tpu.ops.cma import cma_es

    def rosen(x):
        return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                       + (1.0 - x[:-1]) ** 2)

    x0 = np.array([-1.2, 1.0, 0.7])
    n_gens, pop = 120, 16
    draws = np.stack([normal(k, (pop, 3))
                      for k in jax.random.split(as_key(5), n_gens)])
    monkeypatch.setattr(jnp.linalg, "eigh", _canonical_eigh)
    want = cma_es(rosen, x0, sigma0=0.4, n_gens=n_gens, pop_size=pop, key=5,
                  mesh=make_mesh(n))
    out = worlds[n].run("cma_members", x0, draws, n_gens, pop)
    replicated(out)
    for r in out:
        close(r["x_best"], want.x_best, 1e-8, 1e-8)
        assert r["f_best"] == pytest.approx(want.f_best, rel=1e-8, abs=1e-10)
        assert r["f_best"] < 1e-3
        # the population's evaluations split over the ranks: the same run
        close(r["history"], r["single"][2], 1e-12)
        assert "divide" in r["errors"][0] and "traceable" in r["errors"][1]


# ---------------------------------------------------------------------------
# the member-sharded DMDc ensemble (test_parallel.py:372)


def _ensemble_data(rng, n_members=8):
    x = np.linspace(0.0, 10.0, 20)
    t = np.linspace(0.0, 10.0, 40)
    u = np.exp(0.2 * t)[None, :]
    base = np.sin(x[:, None] + 0.2 * t[None, :]) * u
    batch = base[None] + 1e-3 * rng.standard_normal((n_members,) + base.shape)
    return batch, np.broadcast_to(u, (n_members,) + u.shape).copy()


@pytest.mark.parametrize("n", SIZES)
def test_member_sharded_dmdc_ensemble(n, worlds, rng):
    """A DTensor sharded along the members goes through dmdc_fit_ensemble
    and rollout_ensemble and comes back sharded so (before, iterating it
    raised DTensor's refusal to unbind its sharded dim)."""
    from corrla_rs_tpu.models.dmd import dmdc_fit_ensemble
    from corrla_rs_tpu_torch.utils.config import DmdConfig

    batch, u_b = _ensemble_data(rng)
    n_members, _, n_t = batch.shape
    n_x, n_u = batch.shape[1], u_b.shape[1]
    sketch = 6 + DmdConfig().n_oversamples
    keys = jax.random.split(as_key(4), n_members)
    table = {}
    for b, kb in enumerate(keys):
        # a member's two RSVDs sketch [X; U] and X' from the left
        k1, k2 = jax.random.split(kb)
        table[f"4/{b}/0"] = normal(k1, (n_x + n_u, sketch))
        table[f"4/{b}/1"] = normal(k2, (n_x, sketch))
    out = worlds[n].run("ensemble_members", batch, u_b, table)
    members = NamedSharding(make_mesh(n), P("rows"))
    want = np.sort(np.asarray(dmdc_fit_ensemble(
        jax.device_put(jnp.asarray(batch), members),
        jax.device_put(jnp.asarray(u_b), members), n_modes=6, n_iters=15,
        key=4)["lambdas_re"]), axis=1)
    for r in out:
        assert all(p == ["S(0)"] for p in r["placements"].values())
        # sharded against single-device: test_parallel.py:372's 1e-12;
        # against JAX's (its Francis QR against LAPACK's eig, in another
        # order): test_torch_dmd.py's 1e-8
        close(r["lambdas_re"], r["single"], 0.0, 1e-12)
        close(np.sort(r["lambdas_re"], axis=1), want, 0.0, 1e-8)
        for method in ("reduced", "modes"):
            assert r[method + "_placements"] == ["S(0)"]
            close(r[method], r[method + "_single"], 0.0, 1e-10)
            close(r[method + "_shared"], r[method], 0.0, 1e-10)
        err = np.abs(r["reduced"][:, :, 19] - batch[:, :, 20])
        assert err.max() < 5e-2


# ---------------------------------------------------------------------------
# what crosses the ranks (test_sharded_factorizations.py:169, ADVICE r5)


def test_member_sharded_paths_never_gather(worlds, rng):
    n = 4
    n_ens, n_state, p = 64, 512, 3
    x = rng.standard_normal((n_ens, n_state))
    h = rng.standard_normal((p, n_state))
    y = rng.standard_normal(p)
    x0_pf = rng.standard_normal((256, 3))
    ys = rng.standard_normal((5, 3))
    c0 = rng.standard_normal((32, 2))
    out = worlds[n].run("traffic_members", (x, y, h), (x0_pf, ys),
                        np.zeros(3), (c0, np.array([0.5, 2.0])))
    for r in out:
        # the stochastic EnKF: the means and Grams, never one member shard
        shard = n_ens // n * n_state * 8
        budget = 8 * max(p * n_state, p * p, n_state) * 8
        sizes = [b for _, b in r["enkf"]]
        assert sizes and max(sizes) < shard and max(sizes) <= budget
        # the ETKF: the (N, p) anomalies gathered; the state moves in the
        # two all-to-alls, neither more than one rank's block
        assert max(b for _, b in r["etkf"]) <= shard
        assert sum(op == "all_to_all" for op, _ in r["etkf"]) == 2
        # the particle filter: the (N,) weights gathered once a step, and a
        # resample moves at most one rank's rows
        n_pf, d_pf = x0_pf.shape
        pf = r["particle"]
        assert sum(op == "all_gather" for op, _ in pf) == ys.shape[0]
        assert all(b == n_pf * 8 for op, b in pf if op == "all_gather")
        moved = [b for op, b in pf if op == "all_to_all"]
        assert moved and max(moved) <= n_pf // n * d_pf * 8
        assert max(b for op, b in pf if op == "psum") == d_pf * 8
        # CMA-ES: only the (pop,) fitness vector
        assert {(op, b) for op, b in r["cma"]} == {("all_gather", 4 * n * 8)}
        # HMC and NUTS: scalars and the (d,) mass moments
        for name in ("hmc", "nuts"):
            assert {op for op, _ in r[name]} <= {"psum", "pmax"}
            assert max(b for _, b in r[name]) == 2 * 8
