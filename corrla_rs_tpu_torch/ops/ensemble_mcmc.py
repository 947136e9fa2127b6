"""Affine-invariant ensemble MCMC (Goodman-Weare stretch move).

Counterpart of ``corrla_rs_tpu/ops/ensemble_mcmc.py``. The reference's only
MCMC is plain DEMC (space_samplers.rs:252-418), whose efficiency collapses
on strongly anisotropic or correlated targets unless gamma is hand-tuned.
The stretch move (Goodman & Weare 2010, the ``emcee`` algorithm of
Foreman-Mackey et al. 2013) is AFFINE-INVARIANT: its performance is the same
under any linear reparameterization x -> Ax + b, so badly scaled targets
cost nothing and the single tuning constant ``a`` (default 2.0) almost never
needs changing.

One generation uses the parallel red-black split (emcee's "parallel stretch
move"): the first half of the ensemble updates using partners drawn from
the frozen second half, then vice versa, which preserves detailed balance
while each half advances as one batch.

As in ``ops/dream.py``, the randomness of a chunk of generations is drawn at
once through the one seam ``_draw_stretch``; a generation is then a pure
function of the state and its pre-drawn randomness, and the generations run
in a host loop that reads nothing from the device. ``ln_prob_fn`` takes one
(d,) point and is batched with ``torch.func.vmap``. Numpy walkers go to
``utils.device.default_device()`` whatever their number.

z-draw: inverse CDF of g(z) ~ 1/sqrt(z) on [1/a, a]:
    z = ((a - 1) u + 1)^2 / a,  u ~ U(0, 1).
Acceptance: ln q = (d - 1) ln z + lnp(y) - lnp(x).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from corrla_rs_tpu_torch.ops.samplers import _chunk_for
from corrla_rs_tpu_torch.utils.device import as_tensor
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["EnsembleState", "stretch_run", "EnsembleSampler"]


class EnsembleState(NamedTuple):
    walkers: torch.Tensor    # (n_walkers, ndim)
    lnp: torch.Tensor        # (n_walkers,)
    key: torch.Generator
    n_accept: torch.Tensor   # scalar int64, on the walkers' device
    n_reject: torch.Tensor   # scalar int64


class _GenRand(NamedTuple):
    """Pre-drawn randomness (leading axis = generation; two half-updates
    each)."""
    partners: torch.Tensor   # (n, 2, half) int in [0, half)
    u_z: torch.Tensor        # (n, 2, half) uniform for the z inverse CDF
    u_acc: torch.Tensor      # (n, 2, half) uniform for the Metropolis accept


def _draw_stretch(gen, n_gens, half, dtype) -> _GenRand:
    """All randomness of ``n_gens`` generations in three batched draws on
    the generator's device: the one place the stretch move draws."""
    dev = gen.device
    shape = (n_gens, 2, half)
    return _GenRand(
        partners=torch.randint(0, half, shape, generator=gen, device=dev),
        u_z=torch.rand(shape, generator=gen, dtype=dtype, device=dev),
        u_acc=torch.rand(shape, generator=gen, dtype=dtype, device=dev),
    )


def _half_update(walkers, lnps, other, rand_p, rand_z, rand_acc, ln_prob_fn,
                 a):
    """Stretch-update one half against the (frozen) other half."""
    ndim = walkers.shape[1]
    z = ((a - 1.0) * rand_z + 1.0) ** 2 / a                   # (half,)
    partners = other[rand_p]                                  # (half, ndim)
    prop = partners + z[:, None] * (walkers - partners)
    lnp_prop = torch.func.vmap(ln_prob_fn)(prop)
    ln_q = (ndim - 1.0) * torch.log(z) + lnp_prop - lnps
    alpha = torch.exp(torch.clamp_max(ln_q, 0.0))
    alpha = torch.where(torch.isnan(alpha), torch.zeros_like(alpha), alpha)
    accepts = rand_acc < alpha
    return (torch.where(accepts[:, None], prop, walkers),
            torch.where(accepts, lnp_prop, lnps), torch.sum(accepts))


def _stretch_gen(state: EnsembleState, rand: _GenRand, ln_prob_fn,
                 a: float) -> EnsembleState:
    """One full generation: update the first half against the second, then
    the second against the FRESH first half (emcee Algorithm 3)."""
    n = state.walkers.shape[0]
    half = n // 2
    w0, l0, acc0 = _half_update(
        state.walkers[:half], state.lnp[:half], state.walkers[half:],
        rand.partners[0], rand.u_z[0], rand.u_acc[0], ln_prob_fn, a)
    w1, l1, acc1 = _half_update(
        state.walkers[half:], state.lnp[half:], w0,
        rand.partners[1], rand.u_z[1], rand.u_acc[1], ln_prob_fn, a)
    return EnsembleState(
        torch.cat([w0, w1]), torch.cat([l0, l1]), state.key,
        state.n_accept + acc0 + acc1,
        state.n_reject + (n - acc0 - acc1))


def stretch_run(init_walkers, ln_prob_fn: Callable, n_steps: int,
                a: float = 2.0, key=0, unroll: int = 4):
    """Run ``n_steps`` stretch-move generations.

    init_walkers (n_walkers, ndim): n_walkers must be even and should be
    >= 2*ndim (emcee guidance) with nondegenerate spread, since the ensemble
    can only propose within the affine hull of its walkers. ``key`` is an
    int seed or a ``torch.Generator`` on the walkers' device.

    Returns (history (n_steps, n_walkers, ndim), final EnsembleState).
    Resumable: pass ``state.walkers``/``state.key`` back in. ``unroll`` is
    accepted for the JAX package's signature and ignored: the generations
    run in a host loop, which has nothing to unroll.
    """
    heads = as_tensor(init_walkers)
    n, ndim = heads.shape
    if n < 4 or n % 2:
        raise ValueError(f"need an even n_walkers >= 4, got {n}")
    zero = torch.zeros((), dtype=torch.int64, device=heads.device)
    state = EnsembleState(heads, torch.func.vmap(ln_prob_fn)(heads),
                          as_generator(key, heads.device), zero, zero)
    n_steps = int(n_steps)
    history = heads.new_empty((n_steps, n, ndim))
    # the chunk bounds the memory of the pre-drawn tensors
    chunk = _chunk_for(n)
    a = float(a)
    for start in range(0, n_steps, chunk):
        n_gen = min(chunk, n_steps - start)
        rand = _draw_stretch(state.key, n_gen, n // 2, heads.dtype)
        for i in range(n_gen):
            state = _stretch_gen(state, _GenRand(*(r[i] for r in rand)),
                                 ln_prob_fn, a)
            history[start + i] = state.walkers
    return history, state


class EnsembleSampler:
    """Stateful wrapper mirroring the DeMcSampler surface
    (``ops/samplers.py``): ``sample_mcmc`` appends to an in-memory history,
    ``get_samples(n_tail)`` reads it out walker-interleaved (the reference's
    chain-round-robin ordering, space_samplers.rs:309-323). ``key`` is an
    int seed or a ``torch.Generator``; its stream runs on from call to
    call. The counters are read once a call.
    """

    def __init__(self, ln_prob_fn: Callable, init_walkers, a: float = 2.0,
                 key=0):
        self.ln_prob_fn = ln_prob_fn
        self.a = float(a)
        self._init = as_tensor(init_walkers)
        self._key = as_generator(key, self._init.device)
        self._history = None
        self._state = None
        self._prev_acc = 0
        self._prev_rej = 0

    def sample_mcmc(self, n_samples: int):
        """Advance by ceil(n_samples / n_walkers) generations."""
        n_w = self._init.shape[0]
        n_gens = -(-int(n_samples) // n_w)
        start = (self._state.walkers if self._state is not None
                 else self._init)
        hist, state = stretch_run(start, self.ln_prob_fn, n_gens,
                                  a=self.a, key=self._key)
        # counters restart at 0 per stretch_run; accumulate across calls
        state = state._replace(
            n_accept=state.n_accept + self._prev_acc,
            n_reject=state.n_reject + self._prev_rej,
        )
        self._prev_acc, self._prev_rej = torch.stack(
            [state.n_accept, state.n_reject]).tolist()
        self._history = (hist if self._history is None
                         else torch.cat([self._history, hist]))
        self._state = state
        return self

    def accept_ratio(self) -> float:
        if self._state is None:
            return 0.0
        acc = float(self._prev_acc)
        return acc / max(acc + float(self._prev_rej), 1.0)

    @property
    def chain_history(self) -> torch.Tensor:
        return self._history

    def get_samples(self, n_tail: int) -> torch.Tensor:
        """Last n_tail generations, walker-interleaved:
        (n_tail * n_walkers, ndim)."""
        h = self._history[-int(n_tail):]
        t, n, d = h.shape
        return h.reshape(t * n, d)
