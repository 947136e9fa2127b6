"""NUTS: the No-U-Turn Sampler, iterative and batched over chains.

Counterpart of ``corrla_rs_tpu/ops/nuts.py``. HMC (``ops/hmc.py``) needs a
trajectory length; NUTS (Hoffman & Gelman 2014) removes that last tuning
knob by doubling the trajectory until it starts to turn back on itself, then
multinomially sampling a point proportional to the target density along the
trajectory (Betancourt 2017's multinomial scheme, as in Stan and numpyro,
not the original slice-sampler form).

This is the ITERATIVE formulation: a doubling loop (bounded by
``max_depth``) whose body expands the trajectory by 2^depth leapfrog steps
in a random direction, detecting U-turns inside the new subtree with the
power-of-two checkpoint trick: every prefix block of size 2^k is exactly an
internal node of the recursion, and a leaf finishing such a block checks
(start state, end state, block momentum sum) against fixed-size
(max_depth, d) buffers.

The JAX package runs a per-chain ``while_loop`` inside a per-chain
``while_loop`` under ``vmap``. torch cannot batch a data-dependent loop, so
here every chain advances in lockstep under explicit masks: all state is
(n_chains, ...), the checkpoint buffers (n_chains, max_depth, d), and every
update is a ``torch.where`` on the chain's live flag. All chains of a
generation are at the same depth and the same leaf, so which checkpoint
levels start or complete at a leaf is known on the host. The gradient is
evaluated for all chains a leaf, live or not. "Any chain still live" is read
once a doubling, never once a leaf: a leaf whose chains are all dead costs
a little work and no synchronisation.

The trap of a masked loop: a dead chain's arithmetic still runs and may
meet NaN or inf (a diverged trajectory keeps integrating); every carried
quantity is therefore selected by the mask, never blended with it.

On a mesh (``mesh=``) the chains are sharded as in ``ops/hmc.py``, with the
same draws sliced by chain and the same reductions, and one more: "any
chain still live" is a max over all ranks, read once a doubling, so every
rank takes the same doublings and the same collectives, also a rank whose
own chains have all stopped.

The randomness of a chunk of generations is drawn at once through the one
seam ``_draw_nuts``: a table a generation of the momenta (C, d), the
directions and the across-doubling accept uniforms (C, max_depth), and the
leaf uniforms (C, max_depth, 2^(max_depth - 1)); a doubling at depth j reads
the first 2^j of its row.

Warmup matches ``ops/hmc.py``: Nesterov dual averaging of the step size to
a target acceptance (the Stan statistic: the mean Metropolis ratio over
visited leaves) and a diagonal inverse mass from warmup second moments.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from corrla_rs_tpu_torch.ops.hmc import (
    SAMPLING,
    WARMUP_METRIC,
    WARMUP_UNIT,
    _check_chains,
    _dual_averaging,
    _mass_from,
    _warmup_split,
)
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["NutsResult", "nuts_run"]

_DELTA_MAX = 1000.0  # Stan's divergence threshold on H - H0
# elements of the leaf-uniform table drawn at once
_TABLE_ELEMS = 1 << 24


class NutsResult(NamedTuple):
    history: torch.Tensor     # (n_steps, n_chains, d)
    final: torch.Tensor       # (n_chains, d)
    accept_ratio: float       # mean leaf Metropolis statistic, post-warmup
    step_size: float
    inv_mass: torch.Tensor    # (d,)
    n_divergent: int          # post-warmup divergent trajectories
    mean_tree_depth: float    # post-warmup doublings per generation


class _GenRand(NamedTuple):
    """Pre-drawn randomness (leading axis = generation)."""
    z: torch.Tensor          # (n, C, d) standard normal (momentum)
    go_right: torch.Tensor   # (n, C, max_depth) bool, a doubling's direction
    u_acc: torch.Tensor      # (n, C, max_depth) uniform, across doublings
    u_leaf: torch.Tensor     # (n, C, max_depth, 2^(max_depth-1)) uniform


def _draw_nuts(gen, phase, start, n_gens, n_chains, d, max_depth,
               dtype) -> _GenRand:
    """All randomness of generations ``start .. start + n_gens`` of
    ``phase`` on the generator's device: the one place NUTS draws."""
    dev = gen.device
    c = (n_gens, n_chains)

    def uniform(shape):
        return torch.rand(shape, generator=gen, dtype=dtype, device=dev)

    return _GenRand(
        z=torch.randn(c + (d,), generator=gen, dtype=dtype, device=dev),
        go_right=uniform(c + (max_depth,)) < 0.5,
        u_acc=uniform(c + (max_depth,)),
        u_leaf=uniform(c + (max_depth, 1 << max(max_depth - 1, 0))),
    )


def _uturn(p_lo, p_hi, rho, inv_mass):
    """Generalized U-turn criterion (Stan): the segment is turning when the
    momentum at either end points against the segment's total momentum in
    the M^-1 metric: rho^T M^-1 p < 0 (ONE inv_mass factor: applying it to
    both arguments would test in M^-2). Batched over the leading axis."""
    v = rho * inv_mass
    return (torch.sum(v * p_lo, dim=-1) < 0.0) | (
        torch.sum(v * p_hi, dim=-1) < 0.0)


def _select(mask, new, old):
    """``new`` where the chain's flag is set, else ``old``."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)),
                       new, old)


def _build_subtree(value_and_grad, live, x, p, g, v_eps, inv_mass, h0,
                   depth: int, max_depth: int, u_leaf):
    """Expand 2^depth leapfrog steps from (x, p) with the signed step
    ``v_eps`` (C,), for the chains flagged ``live``; a chain stops early
    at a U-turn inside the subtree or a divergence.

    Returns (x_end, p_end, g_end, x_prop, lsw, rho, turning, divergent,
    sum_alpha, n_alpha), each batched over chains. Fixed-size checkpoint
    buffers detect every internal-node U-turn of the recursion."""
    n_chains, d = x.shape
    ck_p = x.new_zeros((n_chains, max_depth, d))
    ck_rho0 = x.new_zeros((n_chains, max_depth, d))   # rho before the block
    x_prop = x
    lsw = x.new_full((n_chains,), -math.inf)
    rho = torch.zeros_like(x)
    turning = torch.zeros_like(live)
    divergent = torch.zeros_like(live)
    s_alpha = x.new_zeros((n_chains,))
    n_alpha = x.new_zeros((n_chains,))
    step = v_eps[:, None]
    for i in range(1 << depth):
        act = live & ~turning & ~divergent
        # one leapfrog step with the gradient carried across leaves
        p_half = p + 0.5 * step * g
        x_new = x + step * (p_half * inv_mass)
        g_new, lnp_new = value_and_grad(x_new)
        p_new = p_half + 0.5 * step * g_new
        x, p, g = (_select(act, x_new, x), _select(act, p_new, p),
                   _select(act, g_new, g))
        # a level-k block starts at leaf i when i % 2^k == 0: its left
        # endpoint is THIS leaf (after the step) and its momentum sum
        # starts from rho before this leaf is added. Level 0 is the leaf
        # itself, whose own momentum never points against itself.
        for k in range(1, depth + 1):
            if i & ((1 << k) - 1) == 0:
                ck_p[:, k] = _select(act, p, ck_p[:, k])
                ck_rho0[:, k] = _select(act, rho, ck_rho0[:, k])
        dh = -lnp_new + 0.5 * torch.sum(p_new * p_new * inv_mass, dim=-1) - h0
        finite = torch.isfinite(dh)
        divergent = divergent | (act & (~finite | (dh > _DELTA_MAX)))
        log_w = torch.where(finite, -dh, -math.inf)
        # streaming multinomial proposal within the subtree
        new_lsw = torch.logaddexp(lsw, log_w)
        take = act & (torch.log(u_leaf[:, i]) < log_w - new_lsw)
        x_prop = _select(take, x, x_prop)
        lsw = torch.where(act, new_lsw, lsw)
        rho = _select(act, rho + p, rho)
        # acceptance statistic (Stan): mean min(1, exp(-dh)) over leaves
        s_alpha = torch.where(
            act, s_alpha + torch.exp(torch.clamp_max(-dh, 0.0)), s_alpha)
        n_alpha = n_alpha + act
        # completed blocks: level k completes when (i + 1) % 2^k == 0
        for k in range(1, depth + 1):
            if (i + 1) & ((1 << k) - 1) == 0:
                turning = turning | (act & _uturn(
                    ck_p[:, k], p, rho - ck_rho0[:, k], inv_mass))
    return x, p, g, x_prop, lsw, rho, turning, divergent, s_alpha, n_alpha


def _nuts_generation(value_and_grad, x_cur, eps, inv_mass, max_depth: int,
                     z, go_right, u_acc, u_leaf, sh):
    """One NUTS generation for the chains of ``sh`` (on a mesh, the
    rank's).
    Returns (x_new (C, d), a_stat (C,), divergent (C,), depth (C,))."""
    p0 = z / torch.sqrt(inv_mass)
    g0, lnp0 = value_and_grad(x_cur)
    h0 = -lnp0 + 0.5 * torch.sum(p0 * p0 * inv_mass, dim=-1)
    n_chains = x_cur.shape[0]
    x_l = x_r = x_prop = x_cur
    p_l = p_r = rho = p0
    g_l = g_r = g0
    lsw = torch.zeros_like(h0)
    live = torch.ones((n_chains,), dtype=torch.bool, device=x_cur.device)
    divergent = torch.zeros_like(live)
    s_a = torch.zeros_like(h0)
    n_a = torch.zeros_like(h0)
    last_depth = torch.zeros((n_chains,), dtype=torch.int64,
                             device=x_cur.device)
    for depth in range(max_depth):
        if depth and not bool(sh.max(live.any().to(torch.int32))):
            break
        right = go_right[:, depth]
        (x_e, p_e, g_e, x_psub, lsw_sub, rho_sub, turn_sub, div_sub, s_a2,
         n_a2) = _build_subtree(
            value_and_grad, live, _select(right, x_r, x_l),
            _select(right, p_r, p_l), _select(right, g_r, g_l),
            torch.where(right, eps, -eps), inv_mass, h0, depth, max_depth,
            u_leaf[:, depth])
        s_a = s_a + s_a2
        n_a = n_a + n_a2
        to_l, to_r = live & ~right, live & right
        x_l, p_l, g_l = (_select(to_l, x_e, x_l), _select(to_l, p_e, p_l),
                         _select(to_l, g_e, g_l))
        x_r, p_r, g_r = (_select(to_r, x_e, x_r), _select(to_r, p_e, p_r),
                         _select(to_r, g_e, g_r))
        ok = live & ~turn_sub & ~div_sub
        # biased progressive sampling across doublings
        take = ok & (torch.log(u_acc[:, depth]) < lsw_sub - lsw)
        x_prop = _select(take, x_psub, x_prop)
        lsw = torch.where(ok, torch.logaddexp(lsw, lsw_sub), lsw)
        rho = _select(live, rho + rho_sub, rho)
        stop = turn_sub | div_sub | _uturn(p_l, p_r, rho, inv_mass)
        divergent = divergent | (live & div_sub)
        last_depth = torch.where(live & ~stop, depth + 1,
                                 torch.where(live, depth, last_depth))
        live = live & ~stop
    return x_prop, s_a / n_a.clamp_min(1.0), divergent, last_depth


def nuts_run(init_chains, ln_prob_fn: Callable, n_steps: int,
             n_warmup: int = 500, max_depth: int = 8,
             target_accept: float = 0.8, init_step_size: float = 0.1,
             key=0, adapt_mass: bool = True, mesh=None,
             axis_name=None) -> NutsResult:
    """Run NUTS on parallel chains (same contract as ``ops/hmc.hmc_run``,
    minus the trajectory-length knob NUTS exists to remove).

    key: int seed or ``torch.Generator`` on the chains' device.
    mesh / axis_name: shard the chains over the mesh axis, as in
    ``hmc_run`` (see the module docstring); ``history`` and ``final`` then
    come back DTensors sharded along the chains."""
    x, sh = _check_chains(init_chains, mesh, axis_name)
    d = x.shape[1]
    n_chains = sh.n
    dtype, dev = x.dtype, x.device
    gen = as_generator(key, dev)
    n_steps, n_warmup, max_depth = int(n_steps), int(n_warmup), int(max_depth)
    value_and_grad = torch.func.vmap(torch.func.grad_and_value(ln_prob_fn))
    chunk = max(1, min(50, _TABLE_ELEMS // max(
        n_chains * max_depth * (1 << max(max_depth - 1, 0)), 1)))
    chains = [x]

    def run_phase(phase, n_gens, inv_mass, eps0=None, eps=None, keep=None):
        """As ``hmc_run``'s: under dual averaging from ``eps0``, or frozen
        at ``eps`` (then returns the summed statistic, divergences and
        depths)."""
        rand = [None]
        totals = [torch.zeros((), dtype=dtype, device=dev),
                  torch.zeros((), dtype=torch.int64, device=dev),
                  torch.zeros((), dtype=dtype, device=dev)]

        def advance(i, eps_i):
            j = i % chunk
            if j == 0:
                rand[0] = _draw_nuts(gen, phase, i, min(chunk, n_gens - i),
                                     n_chains, d, max_depth, dtype)
                rand[0] = _GenRand(*(r[:, sh.rows] for r in rand[0]))
            x_new, a_stat, divergent, depth = _nuts_generation(
                value_and_grad, chains[0], eps_i, inv_mass, max_depth,
                *(r[j] for r in rand[0]), sh=sh)
            chains[0] = x_new
            if keep is not None:
                keep[i] = x_new
            a_mean = sh.mean(a_stat)
            totals[0] = totals[0] + a_mean
            totals[1] = totals[1] + torch.sum(divergent)
            # the summed depths; over all chains at the end
            totals[2] = totals[2] + torch.sum(depth.to(dtype))
            return a_mean

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
        # phase 2 RE-ADAPTS eps under the new metric (as in ops/hmc.py)
        inv_mass = _mass_from(warm_hist, sh)
        eps = run_phase(WARMUP_METRIC, n_warmup - n1, inv_mass, eps0=eps)
    history = x.new_empty((n_steps,) + tuple(x.shape))
    acc, dv, dp = run_phase(SAMPLING, n_steps, inv_mass, eps=eps,
                            keep=history)
    dv, dp = sh.sum(dv), sh.sum(dp) / n_chains
    acc_f, eps_f, dv_f, dp_f = torch.stack(
        [acc.double(), eps.double(), dv.double(), dp.double()]).tolist()
    n = n_steps if n_steps else math.nan
    return NutsResult(history=sh.dtensor(history, 1),
                      final=sh.dtensor(chains[0]),
                      accept_ratio=acc_f / n, step_size=eps_f,
                      inv_mass=inv_mass, n_divergent=int(dv_f),
                      mean_tree_depth=dp_f / n)
