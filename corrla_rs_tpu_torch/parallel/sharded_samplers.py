"""Multi-device DEMC, DREAM and stretch samplers: the chain population
sharded over a mesh axis.

Counterpart of ``corrla_rs_tpu/parallel/sharded_samplers.py``. Each DEMC
proposal reads the heads of two random *other* chains
(space_samplers.rs:326-347), so chains cannot advance independently: every
generation all-gathers the (n_chains, d) heads, which are small, while the
histories stay sharded. DREAM also all-reduces its crossover statistics, so
every rank adapts alike; the stretch move all-gathers the frozen
complementary half for each of its two half-updates.

Every rank makes the same call. The randomness of a chunk of generations is
drawn for the whole population through the single-device modules' seams
(``samplers._draw_demc``, ``dream._draw_dream``,
``ensemble_mcmc._draw_stretch``) from the same key on every rank, and each
rank takes its chains' rows, as JAX draws global per-chain keys and slices
the shard's part. A sharded run is then the single-device run for the same
draws. The generations run in a host loop that reads nothing from the
device; the accept counts are all-reduced once, at the end.

Returns (history (n_steps, n_chains, d) and final heads (n_chains, d) as
DTensors sharded along the chains, accept ratio).
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops import dream as _dream
from corrla_rs_tpu_torch.ops import ensemble_mcmc as _ens
from corrla_rs_tpu_torch.ops import samplers as _samplers
from corrla_rs_tpu_torch.parallel.mesh import (
    CHAINS_AXIS,
    _all_gather,
    _dtensor,
    _local,
    _members,
    _psum,
    make_mesh,
)
from corrla_rs_tpu_torch.utils.device import as_tensor
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["demc_run_sharded", "dream_run_sharded", "stretch_run_sharded"]


def _setup(mesh, axis_name, n_rows, what="n_chains"):
    """(mesh, axis, this rank's slice of the ``n_rows`` chains) after the
    divisibility check."""
    mesh = mesh if mesh is not None else make_mesh(axis_name=CHAINS_AXIS)
    return (mesh,) + _members(mesh, axis_name, n_rows, what)


def _results(hist_l, heads_l, n_acc, mesh, axis, n_steps, n_chains):
    n_acc = _psum(n_acc, mesh, axis)
    d = heads_l.shape[1]
    return (_dtensor(hist_l, mesh, axis, 1, (n_steps, n_chains, d)),
            _dtensor(heads_l, mesh, axis, 0, (n_chains, d)),
            int(n_acc) / (n_steps * n_chains))


def demc_run_sharded(init_heads, ln_prob_fn, n_steps: int, gamma: float,
                     var_epsilon: float, key=0, prop_fixup_fn=None,
                     mesh=None, axis_name=None):
    """DEMC over a chain-sharded mesh (see ops.samplers for the algorithm).

    ``init_heads`` is a DTensor sharded along the chains or the full heads
    on every rank; the mesh axis size must divide n_chains. ``key`` is an
    int seed or a ``torch.Generator`` in the same state on every rank.
    Returns (history (n_steps, n_chains, ndim), final_heads, accept_ratio).
    """
    n_chains, ndim = init_heads.shape
    mesh, axis, rows = _setup(mesh, axis_name, n_chains)
    heads, _ = _local(init_heads, mesh, axis)
    state = _samplers._init_state(heads, ln_prob_fn, key)
    n_steps = int(n_steps)
    hist = heads.new_empty((n_steps,) + heads.shape)
    chunk = _samplers._chunk_for(n_chains)
    for start in range(0, n_steps, chunk):
        n_gen = min(chunk, n_steps - start)
        pairs, jitter, u_acc = (r[:, rows] for r in _samplers._draw_demc(
            state.key, n_gen, n_chains, ndim, var_epsilon, heads.dtype,
            heads.device))
        for i in range(n_gen):
            state = _samplers._demc_step_pre(
                state, (pairs[i], jitter[i], u_acc[i]), ln_prob_fn, gamma,
                prop_fixup_fn,
                population=_all_gather(state.heads, mesh, axis))
            hist[start + i] = state.heads
    return _results(hist, state.heads, state.n_accept, mesh, axis, n_steps,
                    n_chains)


def dream_run_sharded(init_heads, ln_prob_fn, n_steps: int, key=0,
                      delta_max: int = 3, n_cr: int = 3,
                      gamma_jump_prob: float = 0.2, b: float = 0.05,
                      b_star: float = 1e-6, n_adapt: int = 0,
                      prop_fixup_fn=None, mesh=None, axis_name=None):
    """DREAM over a chain-sharded mesh (see ops.dream for the algorithm).

    Heads are all-gathered each generation; the crossover-adaptation
    statistics are all-reduced so every rank adapts alike (after the
    ``n_adapt`` generations the probabilities are frozen, and each rank's
    statistics stay its own). Returns (history (n_steps, n_chains, d),
    final_heads, accept_ratio).
    """
    n_chains, d = init_heads.shape
    mesh, axis, rows = _setup(mesh, axis_name, n_chains)
    assert n_chains >= 2 * delta_max + 1
    heads, _ = _local(init_heads, mesh, axis)
    state = _dream.make_dream_state(heads, ln_prob_fn, n_cr=n_cr, key=key)
    n_steps = int(n_steps)
    hist = heads.new_empty((n_steps,) + heads.shape)

    def psum(stats):
        return _psum(stats, mesh, axis)

    chunk = _samplers._chunk_for(n_chains)
    for start in range(0, n_steps, chunk):
        n_gen = min(chunk, n_steps - start)
        rand = _dream._draw_dream(state.key, n_gen, n_chains, d, delta_max,
                                  b, b_star, heads.dtype)
        rand = _dream._GenRand(*(r[:, rows] for r in rand))
        for i in range(n_gen):
            state = _dream._dream_generation(
                state, _dream._GenRand(*(r[i] for r in rand)), ln_prob_fn,
                delta_max, n_cr, gamma_jump_prob, n_adapt, prop_fixup_fn,
                population=_all_gather(state.heads, mesh, axis),
                reduce=psum if start + i < n_adapt else None)
            hist[start + i] = state.heads
    return _results(hist, state.heads, state.n_accept, mesh, axis, n_steps,
                    n_chains)


def stretch_run_sharded(init_walkers, ln_prob_fn, n_steps: int,
                        a: float = 2.0, key=0, mesh=None, axis_name=None):
    """Affine-invariant stretch sampler over a walker-sharded mesh
    (see ops.ensemble_mcmc for the algorithm).

    Both red-black halves are split over the mesh axis, so every rank
    updates walkers in both half-stages; the frozen complementary half is
    all-gathered for each. The mesh axis size must divide n_walkers / 2.
    ``init_walkers`` is the full (n_walkers, d) array on every rank. Returns
    (history (n_steps, n_walkers, d), final_walkers, accept_ratio) in the
    single-device walker order (first half, then second half), the history
    and the walkers as DTensors sharded along the walkers: each rank's
    block of that order is gathered once, after the last generation.
    """
    n, d = init_walkers.shape
    if n < 4 or n % 2:
        raise ValueError(f"need an even n_walkers >= 4, got {n}")
    half = n // 2
    mesh, axis, rows = _setup(mesh, axis_name, half, "n_walkers/2")
    n_local = rows.stop - rows.start
    walkers = (init_walkers if isinstance(init_walkers, torch.Tensor)
               else as_tensor(init_walkers, device="cpu"))
    # this rank's rows of each half
    halves, _ = _local(walkers.reshape(2, half, d), mesh, axis, dim=1)
    w0, w1 = halves[0], halves[1]
    gen = as_generator(key, w0.device)
    vlnp = torch.func.vmap(ln_prob_fn)
    l0, l1 = vlnp(w0), vlnp(w1)
    n_steps = int(n_steps)
    # the history, and the final walkers as one more step
    hist = w0.new_empty((n_steps + 1, 2, n_local, d))
    n_acc = torch.zeros((), dtype=torch.int64, device=w0.device)
    a = float(a)
    chunk = _samplers._chunk_for(n)
    for start in range(0, n_steps, chunk):
        n_gen = min(chunk, n_steps - start)
        rand = _ens._draw_stretch(gen, n_gen, half, w0.dtype)
        p, z, acc = (x[:, :, rows] for x in rand)
        for i in range(n_gen):
            w0, l0, a0 = _ens._half_update(
                w0, l0, _all_gather(w1, mesh, axis), p[i, 0], z[i, 0],
                acc[i, 0], ln_prob_fn, a)
            w1, l1, a1 = _ens._half_update(
                w1, l1, _all_gather(w0, mesh, axis), p[i, 1], z[i, 1],
                acc[i, 1], ln_prob_fn, a)
            n_acc = n_acc + a0 + a1
            hist[start + i, 0], hist[start + i, 1] = w0, w1
    hist[n_steps, 0], hist[n_steps, 1] = w0, w1
    # walker-major for the gather, (n_local, n_steps + 1, 2, d): every
    # rank's rows of both halves, then this rank's block of the flat order
    full = _all_gather(hist.movedim(2, 0), mesh, axis).movedim(0, 2)
    ours = full.reshape(n_steps + 1, n, d)[:, 2 * rows.start:2 * rows.stop]
    return _results(ours[:-1].contiguous(), ours[-1].contiguous(), n_acc,
                    mesh, axis, n_steps, n)
