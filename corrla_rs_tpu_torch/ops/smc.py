"""Adaptive tempered Sequential Monte Carlo (SMC) sampler.

Counterpart of ``corrla_rs_tpu/ops/smc.py``. The reference's samplers
(space_samplers.rs) are single-temperature MCMC: they cannot estimate the
model evidence (normalizing constant) and mix poorly on multimodal
posteriors. Tempered SMC (Del Moral, Doucet & Jasra 2006; Chopin 2002)
anneals a particle population from the prior to the posterior through
pi_beta ~ prior * likelihood^beta and, as a free byproduct, returns an
unbiased estimate of the log-evidence log Z = log int prior * likelihood,
the quantity Bayesian model comparison needs.

A stage, all on the population's device:
1. choose the next temperature by BISECTION so that the effective sample
   size of the incremental weights hits ``ess_target * n`` (Jasra et al.
   2011 adaptive tempering): a fixed 50-step bisection with no read;
2. accumulate the evidence increment log mean_i exp(dbeta * lnl_i) (exact
   for the equal-weight population that resampling guarantees);
3. SYSTEMATIC resampling (the lowest-variance standard scheme; one cumsum
   and one ``searchsorted``);
4. rejuvenate with ``n_mcmc`` DEMC mutation steps targeting pi_beta
   (proposals from population differences, self-tuning to the current
   population geometry: the move of ``ops/samplers.demc_step``).

The number of stages depends on the data, so the stage loop runs on the
host and reads the stage's four scalars (beta, evidence increment, ESS,
acceptance) in one transfer a stage. A stage's randomness is drawn at once
through the one seam ``_draw_smc``. ``ln_like`` and ``ln_prior`` take one
(d,) point and are batched with ``torch.func.vmap``.

On a mesh (``mesh=``) the population is sharded along the particles and
every rank makes the same call. The likelihoods and the mutation's
log-probabilities run on the rank's rows; the (n,) log-likelihoods are
all-gathered once a stage, so the temperature, the evidence and the ESS
come from the whole vector, as on one device; each stage's table is drawn
whole on every rank and sliced. The resample moves only the distinct
ancestor rows that change rank (``parallel.mesh._take_rows``), and each
DEMC step all-gathers the (n, d) population its proposals read, as the
JAX package's GSPMD program does.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from corrla_rs_tpu_torch.ops.samplers import pick_others_batched
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["SmcResult", "smc_sample"]


class SmcResult(NamedTuple):
    particles: torch.Tensor      # (n, d) posterior (beta = 1) population
    log_evidence: float          # estimate of log int prior * like
    betas: torch.Tensor          # (n_stages + 1,) temperature ladder, 0 -> 1
    ess: torch.Tensor            # (n_stages,) ESS of each reweighting
    accept_ratios: torch.Tensor  # (n_stages,) mutation acceptance per stage
    n_stages: int


class _StageRand(NamedTuple):
    """Pre-drawn randomness of one stage."""
    u_res: torch.Tensor    # () uniform, the systematic resampler's offset
    pairs: torch.Tensor    # (n_mcmc, n, 2) int, the difference partners
    eps: torch.Tensor      # (n_mcmc, n, d) U(0, jitter) proposal jitter
    u_acc: torch.Tensor    # (n_mcmc, n) uniform (Metropolis accept)


def _draw_smc(gen, stage, n, d, n_mcmc, jitter, dtype) -> _StageRand:
    """All randomness of stage number ``stage`` on the generator's device:
    the one place SMC draws."""
    dev = gen.device
    return _StageRand(
        u_res=torch.rand((), generator=gen, dtype=dtype, device=dev),
        pairs=pick_others_batched(gen, n, 2, n_batch=n_mcmc, device=dev),
        eps=torch.rand((n_mcmc, n, d), generator=gen, dtype=dtype,
                       device=dev) * jitter,
        u_acc=torch.rand((n_mcmc, n), generator=gen, dtype=dtype, device=dev),
    )


def _ess_fraction(dbeta, lnl, n):
    """ESS/n of incremental weights exp(dbeta * lnl), equal input weights."""
    lw = dbeta * lnl
    w = torch.exp(lw - torch.max(lw))
    return torch.sum(w) ** 2 / (n * torch.sum(w ** 2))


def _next_beta(beta, lnl, ess_target, n):
    """Largest dbeta in (0, 1-beta] whose incremental ESS >= target, by a
    50-step bisection (monotone: the ESS decreases with dbeta)."""
    hi0 = 1.0 - beta
    # if even the full remaining step keeps the ESS above target, finish
    full_ok = _ess_fraction(hi0, lnl, n) >= ess_target
    lo, hi = torch.zeros_like(hi0), hi0
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        ok = _ess_fraction(mid, lnl, n) >= ess_target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return beta + torch.where(full_ok, hi0, torch.maximum(lo, 1e-8 * hi0))


def _systematic_resample(u, log_w, n):
    """Systematic resampling indices from log-weights and one uniform."""
    w = torch.exp(log_w - torch.logsumexp(log_w, dim=0))
    pos = (u + torch.arange(n, dtype=w.dtype, device=w.device)) / n
    return torch.searchsorted(torch.cumsum(w, dim=0), pos).clamp(0, n - 1)


def _mutate(rand: _StageRand, x, lnp_x, ln_target, gamma, population):
    """DEMC steps on the tempered target from pre-drawn randomness; returns
    (particles, log-probs, accepted count). ``population(x)`` gives the
    whole population the partners index (``x`` itself without a mesh; on a
    mesh, ``rand`` holds the rank's rows and this is the all-gather)."""
    n_mcmc = rand.u_acc.shape[0]
    n_acc = torch.zeros((), dtype=torch.int64, device=x.device)
    batched = torch.func.vmap(ln_target)
    for s in range(n_mcmc):
        pairs = rand.pairs[s]
        pop = population(x)
        prop = x + gamma * (pop[pairs[:, 0]] - pop[pairs[:, 1]]) + rand.eps[s]
        lnp_p = batched(prop)
        alpha = torch.exp(torch.clamp_max(lnp_p - lnp_x, 0.0))
        alpha = torch.where(torch.isnan(alpha), torch.zeros_like(alpha),
                            alpha)
        acc = rand.u_acc[s] < alpha
        x = torch.where(acc[:, None], prop, x)
        lnp_x = torch.where(acc, lnp_p, lnp_x)
        n_acc = n_acc + torch.sum(acc)
    return x, lnp_x, n_acc


def smc_sample(ln_like: Callable, ln_prior: Callable, init_particles,
               n_mcmc: int = 5, ess_target: float = 0.5, key=0,
               max_stages: int = 100, gamma: float | None = None,
               jitter: float = 1e-12, mesh=None,
               axis_name=None) -> SmcResult:
    """Anneal ``init_particles`` (drawn from the prior) to the posterior.

    ln_like / ln_prior: per-point log-likelihood / log-prior callables
    (same signature as the DEMC/DREAM ``ln_prob_fn``).
    ess_target: per-stage incremental effective-sample-size fraction (0.5
    is standard; higher means more, smaller temperature steps).
    key: int seed or ``torch.Generator`` on the particles' device.

    Returns an SmcResult; ``log_evidence`` estimates
    log int exp(ln_prior) exp(ln_like) dx (so with a normalized prior it is
    the marginal likelihood).

    mesh / axis_name: shard the population along the particles over the
    mesh axis (see the module docstring); ``init_particles`` is a DTensor
    sharded so, or the full array every rank holds, and the axis size must
    divide n. ``particles`` then comes back a DTensor with ``Shard(0)``;
    the rest is replicated.
    """
    from corrla_rs_tpu_torch.parallel.mesh import _member_view

    sh = _member_view(init_particles, mesh, axis_name, "the particle count")
    particles, (n, d) = sh.local, sh.shape
    if gamma is None:
        gamma = 2.38 / (2.0 * d) ** 0.5
    gen = as_generator(key, particles.device)
    like_b = torch.func.vmap(ln_like)
    log_n = math.log(float(n))

    betas, esses, ars = [0.0], [], []
    log_z = 0.0
    beta = particles.new_zeros(())
    for stage in range(max_stages):
        lnl = sh.gather(like_b(particles))
        new_beta = _next_beta(beta, lnl, ess_target, n)
        dbeta = new_beta - beta
        lw = dbeta * lnl
        # evidence increment: log mean exp(dbeta * lnl) (equal weights in)
        logz_inc = torch.logsumexp(lw, dim=0) - log_n
        ess = _ess_fraction(dbeta, lnl, n) * n
        rand = _draw_smc(gen, stage, n, d, int(n_mcmc), jitter,
                         particles.dtype)
        resampled = sh.take(particles,
                            _systematic_resample(rand.u_res, lw, n))
        rand = _StageRand(rand.u_res, rand.pairs[:, sh.rows],
                          rand.eps[:, sh.rows], rand.u_acc[:, sh.rows])

        def ln_target(x, b=new_beta):
            return ln_prior(x) + b * ln_like(x)

        particles, _, n_acc = _mutate(
            rand, resampled, torch.func.vmap(ln_target)(resampled),
            ln_target, gamma, sh.gather)
        ar = sh.sum(n_acc) / (int(n_mcmc) * n)
        beta = new_beta
        # the stage's one read
        beta_f, inc_f, ess_f, ar_f = torch.stack([
            beta.double(), logz_inc.double(), ess.double(),
            ar.double()]).tolist()
        betas.append(beta_f)
        esses.append(ess_f)
        ars.append(ar_f)
        log_z += inc_f
        if beta_f >= 1.0 - 1e-12:
            break
    else:
        raise RuntimeError(
            f"SMC did not reach beta=1 in {max_stages} stages "
            f"(reached {betas[-1]:.4f}); raise max_stages or n_mcmc, or "
            "check the likelihood for pathologies")
    dev = particles.device
    return SmcResult(
        particles=sh.dtensor(particles),
        log_evidence=log_z,
        betas=torch.tensor(betas, dtype=torch.float64, device=dev),
        ess=torch.tensor(esses, dtype=torch.float64, device=dev),
        accept_ratios=torch.tensor(ars, dtype=torch.float64, device=dev),
        n_stages=len(esses),
    )
