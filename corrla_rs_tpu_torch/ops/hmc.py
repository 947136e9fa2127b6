"""Hamiltonian Monte Carlo with dual-averaging adaptation.

Counterpart of ``corrla_rs_tpu/ops/hmc.py``. Every sampler in the reference
(space_samplers.rs), and the DEMC/DREAM/stretch/SMC family built around it
here, is GRADIENT-FREE: cost per effective sample grows quickly with
dimension (random-walk-like mixing). ``torch.func`` gives exact gradients of
any log-density, so the missing member of the family is the gradient-based
one: HMC (Duane 1987; Neal 2011), whose leapfrog trajectories move O(1)
distance per proposal in high dimensions where diffusive samplers move
O(1/sqrt(d)).

Implementation (Stan-style single-phase warmup, then a frozen kernel):
- leapfrog integrator with a diagonal mass matrix;
- step size adapted by Nesterov dual averaging to a target acceptance
  (0.8 default; Hoffman & Gelman 2014, Algorithm 5);
- diagonal mass (inverse metric) estimated from warmup second moments,
  applied for the post-warmup run;
- divergences (non-finite Hamiltonian) auto-rejected and counted.

All chains advance in one batched leapfrog: the value and gradient of
``ln_prob_fn`` (one (d,) point in, a scalar out) come from one
``torch.func.vmap`` of ``torch.func.grad_and_value`` a step. The generations
run in a host loop. The randomness of a chunk of generations is drawn at
once through the one seam ``_draw_hmc``, the jittered trajectory lengths as
a host table, so a generation runs exactly its own number of leapfrog steps
and nothing in the loop reads the device: the step size, the dual-averaging
state and the counters stay 0-d device tensors, read once at the end.

On a mesh (``mesh=``) the chains are sharded and every rank makes the same
call. The chains are independent, so the leapfrog runs on the rank's chains
with no collective; each chunk's table is drawn for all chains from the one
key on every rank and sliced. What crosses ranks is the cross-chain mean of
the acceptance statistic (one scalar all-reduce a generation, while the
step size adapts), the (d,) moments of the mass matrix (two all-reduces,
once) and the counters, once at the end. The history comes back a DTensor
sharded along the chains (``Shard(1)``), the final chains ``Shard(0)``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from corrla_rs_tpu_torch.ops.samplers import _chunk_for
from corrla_rs_tpu_torch.utils.device import as_tensor
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["HmcResult", "hmc_run"]

# dual averaging, Hoffman-Gelman constants
_GAMMA, _T0, _KAPPA = 0.05, 10.0, 0.75
# the phases of a run, as the seam is told them: the warmup on the unit
# metric, the warmup on the adapted metric, the sampling
WARMUP_UNIT, WARMUP_METRIC, SAMPLING = "warmup_unit", "warmup_metric", "sampling"


class HmcResult(NamedTuple):
    history: torch.Tensor       # (n_steps, n_chains, d) post-warmup draws
    final: torch.Tensor         # (n_chains, d)
    accept_ratio: float         # post-warmup mean acceptance probability
    step_size: float            # adapted leapfrog step size
    inv_mass: torch.Tensor      # (d,) adapted diagonal inverse mass
    n_divergent: int            # post-warmup divergence count


class _GenRand(NamedTuple):
    """Pre-drawn randomness (leading axis = generation)."""
    z: torch.Tensor        # (n, n_chains, d) standard normal (momentum)
    n_leap: list           # n ints in [1, n_leapfrog], on the host
    u_acc: torch.Tensor    # (n, n_chains) uniform (Metropolis accept)


def _draw_hmc(gen, phase, start, n_gens, n_chains, d, n_leapfrog,
              jitter_steps, dtype) -> _GenRand:
    """All randomness of generations ``start .. start + n_gens`` of
    ``phase`` on the generator's device: the one place HMC draws. The
    trajectory lengths come back as a host list (one read a chunk); without
    ``jitter_steps`` they are ``n_leapfrog`` and nothing is drawn for
    them."""
    dev = gen.device
    z = torch.randn((n_gens, n_chains, d), generator=gen, dtype=dtype,
                    device=dev)
    if jitter_steps:
        n_leap = torch.randint(1, n_leapfrog + 1, (n_gens,), generator=gen,
                               device=dev).tolist()
    else:
        n_leap = [n_leapfrog] * n_gens
    u_acc = torch.rand((n_gens, n_chains), generator=gen, dtype=dtype,
                       device=dev)
    return _GenRand(z, n_leap, u_acc)


def _kinetic(p, inv_mass):
    return 0.5 * torch.sum(p * p * inv_mass, dim=-1)


def _dual_averaging(advance, n_gens: int, eps0: torch.Tensor,
                    target_accept: float) -> torch.Tensor:
    """One dual-averaging phase at a fixed metric: ``advance(i, eps)`` runs
    generation i at the 0-d step size ``eps`` and returns its acceptance
    statistic. Returns the averaged step size, a 0-d tensor; nothing here
    reads the device."""
    mu = math.log(10.0) + torch.log(eps0)
    log_eps = log_eps_bar = torch.log(eps0)
    h_bar = torch.zeros_like(eps0)
    for i in range(n_gens):
        a_stat = advance(i, torch.exp(log_eps))
        t = i + 1.0
        h_bar = ((1.0 - 1.0 / (t + _T0)) * h_bar
                 + (target_accept - a_stat) / (t + _T0))
        log_eps = mu - math.sqrt(t) / _GAMMA * h_bar
        w = t ** (-_KAPPA)
        log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
    return torch.exp(log_eps_bar)


def _warmup_split(n_warmup: int, adapt_mass: bool):
    """(generations on the unit metric, whether a mass phase follows): with
    a mass re-adapt, 2/3 of the warmup runs on the unit metric."""
    do_mass = adapt_mass and n_warmup >= 20
    return ((2 * n_warmup) // 3 if do_mass else n_warmup), do_mass


def _mass_from(warm_hist: torch.Tensor, sh) -> torch.Tensor:
    """Diagonal inverse mass from the settled half of the unit-metric
    warmup's draws of the chains of ``sh`` (``parallel.mesh._Members`` or
    ``_Whole``): the two (d,) moments summed over the ranks."""
    n1, _, d = warm_hist.shape
    tail = warm_hist[n1 // 2:].reshape(-1, d)
    count = (n1 - n1 // 2) * sh.n
    mean = sh.sum(torch.sum(tail, dim=0)) / count
    return sh.sum(torch.sum((tail - mean) ** 2, dim=0)) / count + 1e-6


def _check_chains(init_chains, mesh, axis_name):
    """(this rank's chains, all of them without a mesh; their
    ``parallel.mesh._Members``, or its ``_Whole`` without a mesh)."""
    from corrla_rs_tpu_torch.parallel.mesh import _member_view

    x0 = as_tensor(init_chains) if mesh is None else init_chains
    if x0.ndim != 2:
        raise ValueError(f"init_chains must be (n_chains, d), got "
                         f"{tuple(x0.shape)}")
    sh = _member_view(x0, mesh, axis_name, "n_chains")
    return sh.local, sh


def hmc_run(init_chains, ln_prob_fn: Callable, n_steps: int,
            n_warmup: int = 500, n_leapfrog: int = 32,
            target_accept: float = 0.8, init_step_size: float = 0.1,
            key=0, adapt_mass: bool = True, jitter_steps: bool = False,
            mesh=None, axis_name=None) -> HmcResult:
    """Run HMC on ``n_chains`` parallel chains.

    init_chains (n_chains, d): overdispersed starting points.
    ln_prob_fn: per-point log density (same contract as the other
    samplers); its gradient comes from ``torch.func.grad_and_value``.
    key: int seed or ``torch.Generator`` on the chains' device.

    Warmup adapts the step size (dual averaging to ``target_accept``) and,
    if ``adapt_mass``, a diagonal inverse mass from the warmup draws' second
    moments; both freeze for the sampling phase, so the post-warmup history
    is a valid MCMC chain set. ``jitter_steps`` draws each generation's
    trajectory length uniformly from 1..n_leapfrog (Neal 2011 §3.2), which
    breaks the periodicity resonances a fixed length has on targets whose
    oscillation period divides eps * n_leapfrog.

    mesh / axis_name: shard the chains over the mesh axis (see the module
    docstring); ``init_chains`` is a DTensor sharded along the chains or
    the full array every rank holds, and the axis size must divide
    n_chains. ``history`` and ``final`` then come back DTensors sharded
    along the chains; the rest is replicated.
    """
    x, sh = _check_chains(init_chains, mesh, axis_name)
    d = x.shape[1]
    n_chains = sh.n
    dtype, dev = x.dtype, x.device
    gen = as_generator(key, dev)
    n_steps, n_warmup, n_leapfrog = int(n_steps), int(n_warmup), int(n_leapfrog)
    value_and_grad = torch.func.vmap(torch.func.grad_and_value(ln_prob_fn))
    chunk = _chunk_for(n_chains)

    def transition(x, lnp_x, g_x, eps, inv_mass, z, n_leap, u_acc):
        """One generation; the gradient is carried through the steps (the
        closing half-kick of a step and the opening one of the next use
        the same gradient: n + 1 evaluations, not 2n)."""
        p0 = z / torch.sqrt(inv_mass)
        x_new, p, g, lnp_new = x, p0, g_x, lnp_x
        for _ in range(n_leap):
            p_half = p + 0.5 * eps * g
            x_new = x_new + eps * (p_half * inv_mass)
            g, lnp_new = value_and_grad(x_new)
            p = p_half + 0.5 * eps * g
        h0 = -lnp_x + _kinetic(p0, inv_mass)
        h1 = -lnp_new + _kinetic(p, inv_mass)
        log_alpha = torch.clamp_max(h0 - h1, 0.0)
        divergent = ~torch.isfinite(log_alpha)
        log_alpha = torch.where(divergent, -math.inf, log_alpha)
        accept = torch.log(u_acc) < log_alpha
        x = torch.where(accept[:, None], x_new, x)
        lnp_x = torch.where(accept, lnp_new, lnp_x)
        g_x = torch.where(accept[:, None], g, g_x)
        # mean Metropolis probability (the dual-averaging statistic)
        return (x, lnp_x, g_x, sh.mean(torch.exp(log_alpha)),
                torch.sum(divergent))

    g_x, lnp_x = value_and_grad(x)
    state = [x, lnp_x, g_x]

    def run_phase(phase, n_gens, inv_mass, eps0=None, eps=None, keep=None):
        """``n_gens`` generations of ``phase``: with ``eps0`` under dual
        averaging (returns the adapted step size), else at the frozen
        ``eps`` (returns the summed acceptance and divergences). ``keep``
        receives every generation's chains."""
        rand = [None]
        totals = [torch.zeros((), dtype=dtype, device=dev),
                  torch.zeros((), dtype=torch.int64, device=dev)]

        def advance(i, eps_i):
            j = i % chunk
            if j == 0:
                r = _draw_hmc(gen, phase, i, min(chunk, n_gens - i),
                              n_chains, d, n_leapfrog, jitter_steps, dtype)
                rand[0] = _GenRand(r.z[:, sh.rows], r.n_leap,
                                   r.u_acc[:, sh.rows])
            r = rand[0]
            x_i, lnp_i, g_i, a_stat, n_div = transition(
                *state, eps_i, inv_mass, r.z[j], r.n_leap[j], r.u_acc[j])
            state[:] = [x_i, lnp_i, g_i]
            if keep is not None:
                keep[i] = x_i
            totals[0] = totals[0] + a_stat
            totals[1] = totals[1] + n_div
            return a_stat

        if eps0 is not None:
            return _dual_averaging(advance, n_gens, eps0, target_accept)
        for i in range(n_gens):
            advance(i, eps)
        return totals

    n1, do_mass = _warmup_split(n_warmup, adapt_mass)
    inv_mass = torch.ones((d,), dtype=dtype, device=dev)
    warm_hist = x.new_empty((n1,) + tuple(x.shape)) if do_mass else None
    eps = run_phase(WARMUP_UNIT, n1, inv_mass,
                    eps0=torch.as_tensor(init_step_size, dtype=dtype,
                                         device=dev), keep=warm_hist)
    if do_mass:
        # metric from the settled half of phase 1, then RE-ADAPT eps under
        # the new metric (a unit-metric eps is wrong for it: Stan's windowed
        # warmup re-tunes after every metric update)
        inv_mass = _mass_from(warm_hist, sh)
        eps = run_phase(WARMUP_METRIC, n_warmup - n1, inv_mass, eps0=eps)
    history = x.new_empty((n_steps,) + tuple(x.shape))
    acc_sum, div_sum = run_phase(SAMPLING, n_steps, inv_mass, eps=eps,
                                 keep=history)
    # the acceptance statistic is already the all-chains mean
    acc, eps_f, n_div = torch.stack([
        acc_sum.double() / max(n_steps, 1), eps.double(),
        sh.sum(div_sum).double()]).tolist()
    return HmcResult(history=sh.dtensor(history, 1),
                     final=sh.dtensor(state[0]),
                     accept_ratio=acc if n_steps else math.nan,
                     step_size=eps_f, inv_mass=inv_mass,
                     n_divergent=int(n_div))
