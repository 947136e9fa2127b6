"""Constrained-space samplers: Dirichlet rejection and DEMC MCMC.

Counterpart of ``corrla_rs_tpu/ops/samplers.py`` (parity with reference
space_samplers.rs):

- ``constr_dirichlet_sample`` (space_samplers.rs:64-126): x with
  sum_i x_i = c_scale and lb_i <= x_i <= ub_i, by rejection. Whole chunks of
  Dirichlet rows are drawn on the device; the accepted rows of each chunk
  are kept in chunk order until ``n_samples`` are found. Reading how many a
  chunk gave synchronises once a chunk. Too few after ``max_zshots`` chunks
  raises (the reference silently returns zero rows). ``backend="host"``
  runs the multithreaded C++ sampler of ``native.py``.
- ``DeMcSampler`` (space_samplers.rs:252-418): differential-evolution
  MCMC. Proposal x' = x + gamma (x_a - x_b) + U(0, eps) from two random
  *other* chains (space_samplers.rs:326-347), optional proposal fixup,
  Metropolis accept (space_samplers.rs:400-417). All chains advance
  together (``demc_run``, the reference's ``sample_mcmc_par``) or one after
  another within a generation (``demc_run_serial``, its ``sample_mcmc``).
  Randomness is drawn ahead for a chunk of generations (``_chunk_for``);
  each generation is then a few small launches with no synchronisation.
  ``get_samples`` interleaves chains round-robin like space_samplers.rs:309-323.

Log-probability functions map one (d,) sample to a scalar; the samplers map
them over the chains with ``torch.func.vmap``, so they must use operations
that vmap can batch (the library's own use ``torch.where``, with no Python
branch on values). The draws go through two seams, ``_draw_dirichlet`` and
``_draw_demc``, and a generation from given draws is ``_demc_step_pre``:
the parity tests feed both packages the same draws there.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from corrla_rs_tpu_torch.utils.config import DemcConfig, DirichletSamplerConfig
from corrla_rs_tpu_torch.utils.device import as_tensor
from corrla_rs_tpu_torch.utils.prng import as_generator

_DEMC_CFG = DemcConfig()
_DIRICHLET_CFG = DirichletSamplerConfig()

__all__ = [
    "constr_dirichlet_sample",
    "ln_prior_uniform",
    "ln_like_dirichlet",
    "ln_like_sum",
    "DeMcSampler",
    "DemcState",
    "demc_run",
    "demc_run_serial",
    "demc_step",
    "pick_others_batched",
]


def _broadcast_alphas(alphas, ndim: int) -> np.ndarray:
    """Alpha validation/broadcast, parity with space_samplers.rs:76-95."""
    if alphas is None:
        return np.ones((ndim,))
    a = np.atleast_1d(np.asarray(alphas, dtype=np.float64))
    if a.shape[0] == 1:
        return np.broadcast_to(a, (ndim,))
    if a.shape[0] != ndim:
        raise ValueError(
            "Number of shape parameters to Dirichlet sampler must be ndim "
            "or 1 for the sym case"
        )
    return a


def _seed_int(key) -> int:
    """An int seed for the host sampler: the seed itself, or a draw from
    the generator."""
    if isinstance(key, torch.Generator):
        return int(torch.randint(0, 1 << 62, (1,), generator=key,
                                 device=key.device))
    return 0 if key is None else int(key)


def _draw_dirichlet(gen, n_rows: int, alphas: torch.Tensor, uniform: bool,
                    dtype, device) -> torch.Tensor:
    """(n_rows, ndim) Dirichlet(alphas) rows: the one place the rejection
    fill draws. Dirichlet(1, ..., 1) is normalised exponentials; the
    general case normalises Gamma(alpha_i) deviates."""
    ndim = alphas.shape[0]
    if uniform:
        e = torch.empty((n_rows, ndim), dtype=dtype, device=device)
        e.exponential_(generator=gen)
    else:
        # the public Gamma sampler (torch.distributions.Gamma) takes no
        # generator; only the private torch._standard_gamma does
        conc = alphas.to(dtype=dtype, device=device).expand(n_rows, ndim)
        e = torch._standard_gamma(conc.contiguous(), generator=gen)
    return e / e.sum(dim=1, keepdim=True)


def _rejection_fill(gen, bounds, alphas, n_samples, max_zshots, chunk_size,
                    c_scale, uniform):
    """Accepted rows of successive chunks, in chunk order, up to
    n_samples; returns (rows, count)."""
    lo, hi = bounds[:, 0], bounds[:, 1]
    parts, count, shot = [], 0, 0
    while count < n_samples and shot < max_zshots:
        zs = _draw_dirichlet(gen, chunk_size, alphas, uniform, bounds.dtype,
                             bounds.device) * c_scale
        ok = ((lo <= zs) & (zs <= hi)).all(dim=1)
        take = zs[ok][: n_samples - count]
        parts.append(take)
        count += take.shape[0]
        shot += 1
    rows = (torch.cat(parts) if parts
            else bounds.new_zeros((0, bounds.shape[0])))
    return rows, count


def constr_dirichlet_sample(bounds, n_samples: int,
                            max_zshots: int = _DIRICHLET_CFG.max_zshots,
                            chunk_size: int = _DIRICHLET_CFG.chunk_size,
                            c_scale: float = _DIRICHLET_CFG.c_scale,
                            alphas=None, key=0, backend: str = "device",
                            device=None) -> torch.Tensor:
    """Rejection-sample the bounded simplex sum(x) = c_scale: (n_samples,
    ndim), f64 unless ``bounds`` is a float tensor of another dtype.

    Parity with space_samplers.rs:64-126, raising if ``max_zshots`` chunks
    of ``chunk_size`` rows were too few. ``key`` is an int seed or a
    ``torch.Generator``; ``device`` is where numpy bounds go (default
    ``utils.device.default_device()``). backend='host' runs the C++
    streaming sampler (``native.py``) and returns its rows on that device.
    """
    if isinstance(bounds, torch.Tensor) and bounds.is_floating_point():
        b = bounds if device is None else bounds.to(device)
    else:
        b = as_tensor(np.asarray(bounds, dtype=np.float64), device=device)
    ndim = b.shape[0]
    if backend == "host":
        from corrla_rs_tpu_torch import native

        rows = native.cs_dirichlet_rejection_host(
            b.cpu().numpy().astype(np.float64), int(n_samples),
            int(max_zshots), int(chunk_size), float(c_scale),
            _broadcast_alphas(alphas, ndim), seed=_seed_int(key),
        )
        return torch.as_tensor(rows, dtype=b.dtype, device=b.device)
    a = _broadcast_alphas(alphas, ndim)
    uniform = bool(np.all(a == 1.0))
    out, count = _rejection_fill(
        as_generator(key, b.device), b, torch.tensor(a, device=b.device),
        int(n_samples), int(max_zshots), int(chunk_size), float(c_scale),
        uniform,
    )
    if count < n_samples:
        raise RuntimeError(
            f"constr_dirichlet_sample: only {count}/{n_samples} valid "
            f"samples found within max_zshots={max_zshots} chunks of "
            f"{chunk_size}; loosen bounds or raise max_zshots/chunk_size"
        )
    return out


# ---------------------------------------------------------------------------
# Log-probability combinators (space_samplers.rs:154-250)
# ---------------------------------------------------------------------------

def _const(cache: dict, value: np.ndarray, like: torch.Tensor):
    """``value`` as a tensor of ``like``'s dtype and device, made once."""
    key = (like.dtype, like.device)
    if key not in cache:
        cache[key] = torch.as_tensor(value, dtype=like.dtype,
                                     device=like.device)
    return cache[key]


def ln_prior_uniform(bounds) -> Callable:
    """Flat prior on an open box: 0 inside, -inf outside.

    Parity with LnPriorUniform (space_samplers.rs:175-199, strict
    inequalities).
    """
    b_np = np.asarray(bounds, dtype=np.float64)
    cache: dict = {}

    def lnp(x):
        b = _const(cache, b_np, x)
        ok = ((b[:, 0] < x) & (x < b[:, 1])).all()
        return torch.where(ok, x.new_zeros(()), x.new_full((), -math.inf))

    return lnp


def ln_like_dirichlet(alphas) -> Callable:
    """Dirichlet log-pdf. Parity with LnLikeDirichlet
    (space_samplers.rs:202-229), computed in log space."""
    from scipy.special import gammaln

    a_np = np.atleast_1d(np.asarray(alphas, dtype=np.float64))
    ln_beta = float(np.sum(gammaln(a_np)) - gammaln(np.sum(a_np)))
    cache: dict = {}

    def lnp(x):
        a = _const(cache, a_np, x)
        return torch.sum((a - 1.0) * torch.log(x)) - ln_beta

    return lnp


def ln_like_sum(*fns: Callable) -> Callable:
    """Posterior numerator: sum of log terms. space_samplers.rs:232-250."""

    def lnp(x):
        total = 0.0
        for f in fns:
            total = total + f(x)
        return total

    return lnp


# ---------------------------------------------------------------------------
# DEMC
# ---------------------------------------------------------------------------

class DemcState(NamedTuple):
    heads: torch.Tensor      # (n_chains, ndim)
    head_lnp: torch.Tensor   # (n_chains,)
    key: torch.Generator
    n_accept: torch.Tensor   # scalar int64, on the heads' device
    n_reject: torch.Tensor   # scalar int64


def _chunk_for(n_chains: int) -> int:
    """Generations per chunk of pre-drawn randomness (the JAX package's
    ``ops.dream._chunk_for``): big chunks for small populations, small
    ones for large populations, whose chunk tensors are (chunk, n, d)."""
    return max(5, min(50, 25600 // max(n_chains, 1)))


def pick_others_batched(gen, n_chains: int, k: int,
                        n_batch: int | None = None,
                        device=None) -> torch.Tensor:
    """(n_chains, k) random indices, distinct per row and != the row index
    ((n_batch, n_chains, k) with ``n_batch``).

    O(k^2) work a chain: sequential draws from shrinking ranges, each
    shifted past the sorted indices already excluded.
    """
    device = gen.device if device is None else device
    shape = (n_chains,) if n_batch is None else (n_batch, n_chains)
    c = torch.arange(n_chains, device=device).expand(shape)
    chosen = []
    for j in range(k):
        r = torch.randint(0, n_chains - 1 - j, shape, generator=gen,
                          device=device)
        exc = torch.sort(torch.stack([c] + chosen, dim=-1), dim=-1).values
        for m in range(j + 1):
            r = r + (r >= exc[..., m])
        chosen.append(r)
    return torch.stack(chosen, dim=-1)


def _draw_demc(gen, n_gen: int, n_chains: int, ndim: int, var_epsilon: float,
               dtype, device):
    """Randomness of ``n_gen`` generations, drawn at once: the partner
    pairs (n_gen, n_chains, 2), the U(0, var_epsilon) jitter
    (n_gen, n_chains, ndim) and the acceptance uniforms (n_gen, n_chains)."""
    pairs = pick_others_batched(gen, n_chains, 2, n_batch=n_gen,
                                device=device)
    jitter = torch.rand((n_gen, n_chains, ndim), generator=gen, dtype=dtype,
                        device=device) * var_epsilon
    u_acc = torch.rand((n_gen, n_chains), generator=gen, dtype=dtype,
                       device=device)
    return pairs, jitter, u_acc


def _demc_step_pre(state: DemcState, rand, ln_prob_fn, gamma: float,
                   prop_fixup_fn=None, population=None) -> DemcState:
    """One DEMC generation from pre-drawn randomness ``rand`` = (pairs
    (n, 2), jitter (n, d), u_acc (n,)).

    Proposal parity with space_samplers.rs:326-358; all chains propose from
    the same generation of heads (the reference's ``sample_mcmc_par``,
    space_samplers.rs:377-393). ``population``: the heads the pairs index,
    where ``state`` holds a shard of them (default ``state.heads``).
    """
    n_chains = state.heads.shape[0]
    pairs, jitter, u_acc = rand
    heads = state.heads
    pop = heads if population is None else population
    delta = pop[pairs[:, 0]] - pop[pairs[:, 1]]
    prop = heads + gamma * delta + jitter
    if prop_fixup_fn is not None:
        prop = torch.func.vmap(prop_fixup_fn)(prop)
    lnp_prop = torch.func.vmap(ln_prob_fn)(prop)
    # alpha = clip(exp(lnp' - lnp), 0, 1) (space_samplers.rs:400-408)
    alpha = torch.exp(torch.clamp_max(lnp_prop - state.head_lnp, 0.0))
    alpha = torch.where(torch.isnan(alpha), torch.zeros_like(alpha), alpha)
    accepts = u_acc < alpha
    n_acc = accepts.sum()
    return DemcState(
        torch.where(accepts[:, None], prop, heads),
        torch.where(accepts, lnp_prop, state.head_lnp),
        state.key, state.n_accept + n_acc,
        state.n_reject + (n_chains - n_acc),
    )


def demc_step(state: DemcState, ln_prob_fn, gamma: float, var_epsilon: float,
              prop_fixup_fn=None) -> DemcState:
    """Advance every chain one DEMC step, drawing from ``state.key``."""
    n_chains, ndim = state.heads.shape
    pairs, jitter, u_acc = _draw_demc(state.key, 1, n_chains, ndim,
                                      var_epsilon, state.heads.dtype,
                                      state.heads.device)
    return _demc_step_pre(state, (pairs[0], jitter[0], u_acc[0]),
                          ln_prob_fn, gamma, prop_fixup_fn)


def _init_state(init_heads, ln_prob_fn, key) -> DemcState:
    heads = as_tensor(init_heads)
    zero = torch.zeros((), dtype=torch.int64, device=heads.device)
    return DemcState(heads, torch.func.vmap(ln_prob_fn)(heads),
                     as_generator(key, heads.device), zero, zero)


def demc_run(init_heads, ln_prob_fn, n_steps: int, gamma: float,
             var_epsilon: float, key, prop_fixup_fn=None, unroll: int = 4):
    """Run n_steps generations of DEMC on all chains; returns (history,
    state). history: (n_steps, n_chains, ndim), one generation a step.
    ``key`` is an int seed or a ``torch.Generator`` on the heads' device.
    ``unroll`` is accepted for the JAX package's signature and ignored: the
    generations run in a host loop, which has nothing to unroll."""
    state = _init_state(init_heads, ln_prob_fn, key)
    n_chains, ndim = state.heads.shape
    n_steps = int(n_steps)
    history = state.heads.new_empty((n_steps, n_chains, ndim))
    chunk = _chunk_for(n_chains)
    for start in range(0, n_steps, chunk):
        n_gen = min(chunk, n_steps - start)
        pairs, jitter, u_acc = _draw_demc(state.key, n_gen, n_chains, ndim,
                                          var_epsilon, state.heads.dtype,
                                          state.heads.device)
        for i in range(n_gen):
            state = _demc_step_pre(state, (pairs[i], jitter[i], u_acc[i]),
                                   ln_prob_fn, gamma, prop_fixup_fn)
            history[start + i] = state.heads
    return history, state


def demc_run_serial(init_heads, ln_prob_fn, n_steps: int, gamma: float,
                    var_epsilon: float, key, prop_fixup_fn=None):
    """Serial-update DEMC: within a generation, chain c's proposal reads the
    heads of chains < c already updated this generation, the semantics of
    the reference's serial ``sample_mcmc`` (space_samplers.rs:361-374). A
    loop over chains inside the loop over generations: O(n_chains) small
    launches a generation, for declared-behaviour parity; ``demc_run`` is
    the fast path."""
    state = _init_state(init_heads, ln_prob_fn, key)
    heads, lnps = state.heads.clone(), state.head_lnp.clone()
    n_chains, ndim = heads.shape
    n_steps = int(n_steps)
    history = heads.new_empty((n_steps, n_chains, ndim))
    n_acc = state.n_accept
    chunk = _chunk_for(n_chains)
    for start in range(0, n_steps, chunk):
        n_gen = min(chunk, n_steps - start)
        pairs, jitter, u_acc = _draw_demc(state.key, n_gen, n_chains, ndim,
                                          var_epsilon, heads.dtype,
                                          heads.device)
        for i in range(n_gen):
            for c in range(n_chains):
                a, b = pairs[i, c, 0], pairs[i, c, 1]
                prop = heads[c] + gamma * (heads[a] - heads[b]) + jitter[i, c]
                if prop_fixup_fn is not None:
                    prop = prop_fixup_fn(prop)
                lnp_prop = ln_prob_fn(prop)
                alpha = torch.exp(torch.clamp_max(lnp_prop - lnps[c], 0.0))
                alpha = torch.where(torch.isnan(alpha),
                                    torch.zeros_like(alpha), alpha)
                accept = u_acc[i, c] < alpha
                heads[c] = torch.where(accept, prop, heads[c])
                lnps[c] = torch.where(accept, lnp_prop, lnps[c])
                n_acc = n_acc + accept
            history[start + i] = heads
    n_rej = n_steps * n_chains - n_acc
    return history, DemcState(heads, lnps, state.key, n_acc, n_rej)


class DeMcSampler:
    """Differential-evolution MCMC over parallel chains.

    Mirrors DeMcSampler (space_samplers.rs:252-418): >= 3 chains, gamma,
    var_epsilon, optional proposal fixup, acceptance bookkeeping, and the
    round-robin ``get_samples`` readout. ``ln_prob_fn`` maps one (d,)
    sample to a scalar log-probability. ``key`` is an int seed or a
    ``torch.Generator``; ``device`` is where numpy ``init_chains`` go
    (default ``utils.device.default_device()``).

    ``sample_mcmc(n, mode=...)``: "parallel" (default) advances all chains
    generation-synchronously (the reference's ``sample_mcmc_par``);
    "serial" reproduces the reference's serial ``sample_mcmc`` update order.
    """

    def __init__(self, ln_prob_fn: Callable, init_chains,
                 gamma: float = _DEMC_CFG.gamma,
                 var_epsilon: float = _DEMC_CFG.var_epsilon,
                 prop_fixup_fn: Callable | None = None,
                 key=0, config: DemcConfig | None = None, device=None):
        heads = as_tensor(init_chains, device=device)
        if heads.ndim != 2 or heads.shape[0] < 3:
            raise ValueError(f"need (n_chains >= 3, ndim) chains, got "
                             f"{tuple(heads.shape)}")
        self.n_chains, self.ndim = heads.shape
        if config is not None:
            gamma, var_epsilon = config.gamma, config.var_epsilon
        self.gamma = float(gamma)
        self.var_epsilon = float(var_epsilon)
        self.ln_prob_fn = ln_prob_fn
        self.prop_fixup_fn = prop_fixup_fn
        self._key = as_generator(key, heads.device)
        self._heads = heads
        self._history = [heads[None, :, :]]  # list of (n_steps, n_chains, d)
        self.n_accept = 0
        self.n_reject = 0

    def sample_mcmc(self, n_samples: int, mode: str = "parallel"):
        """Draw n_samples generations on all chains. mode="serial" uses the
        reference's sequential within-generation update order."""
        runner = demc_run_serial if mode == "serial" else demc_run
        history, state = runner(
            self._heads, self.ln_prob_fn, int(n_samples), self.gamma,
            self.var_epsilon, self._key, self.prop_fixup_fn,
        )
        self._heads = state.heads
        self._history.append(history)
        self.n_accept += int(state.n_accept)
        self.n_reject += int(state.n_reject)
        return self

    def sample_mcmc_par(self, n_samples: int):
        """The reference's parallel variant, the default ``sample_mcmc``
        path (space_samplers.rs:377-393)."""
        return self.sample_mcmc(n_samples, mode="parallel")

    def accept_ratio(self) -> float:
        """Global acceptance ratio. space_samplers.rs:396-398."""
        total = self.n_accept + self.n_reject
        return self.n_accept / total if total else 0.0

    @property
    def chain_history(self) -> torch.Tensor:
        """(n_generations, n_chains, ndim) including the seed generation."""
        return torch.cat(self._history, dim=0)

    def get_chain_samples(self, n_tail: int, chain_id: int) -> torch.Tensor:
        """Last n_tail samples of one chain. space_samplers.rs:300-305."""
        return self.chain_history[-n_tail:, chain_id, :]

    def get_samples(self, n_tail: int) -> torch.Tensor:
        """Last n_tail generations, chains interleaved round-robin
        (generation-major, chain-minor), parity with space_samplers.rs:309-323.

        n_tail=0 returns an empty array, the reference's actual behaviour
        (its docstring claims "all samples" but its output buffer is sized
        n_tail * n_chains, space_samplers.rs:314)."""
        if n_tail == 0:
            return self._heads.new_zeros((0, self.ndim))
        tail = self.chain_history[-n_tail:]  # (n_tail, n_chains, d)
        return tail.reshape(n_tail * self.n_chains, self.ndim)
