"""DREAM: DiffeRential Evolution Adaptive Metropolis.

Counterpart of ``corrla_rs_tpu/ops/dream.py``. The reference README
advertises DREAM (readme.md:44) but only implements plain DEMC
(space_samplers.rs:252-418). This module is the sampler of Vrugt et al. 2009
("Accelerating Markov chain Monte Carlo simulation by differential evolution
with self-adaptive randomized subspace sampling"):

- multi-pair proposals: delta ~ U{1..delta_max} chain-pair differences
- subspace sampling: each dimension updated with probability CR
- adaptive crossover: nCR candidate CR values with selection probabilities
  adapted from normalized jump distances during burn-in
- gamma = 2.38 / sqrt(2 delta d') with unit-gamma mode jumps at probability
  p_gamma1 (default 0.2, i.e. every ~5th generation)
- (1+e) multiplicative and eps additive proposal noise

All chains advance together, one generation after another in a host loop.
The randomness of a chunk of generations is drawn at once through the one
seam ``_draw_dream``; a generation is then ``_dream_generation``, a pure
function of the state and its pre-drawn randomness, of a few dozen small
launches with no synchronisation. ``ln_prob_fn`` and ``prop_fixup_fn`` take
one (d,) point and are batched with ``torch.func.vmap``. A population runs
where its heads are: numpy heads go to ``utils.device.default_device()``
whatever their number.

Optional Vrugt-style outlier-chain correction (``outlier_reset`` /
``DreamSampler(outlier_correct=True)``) runs only inside the burn-in window;
adaptation freezes after ``n_adapt`` generations so the stationary chain is a
valid MCMC.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from corrla_rs_tpu_torch.ops.samplers import _chunk_for, pick_others_batched
from corrla_rs_tpu_torch.utils.config import DreamConfig
from corrla_rs_tpu_torch.utils.device import as_tensor
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = [
    "DreamState", "make_dream_state", "dream_run", "DreamSampler",
    "outlier_reset",
]

# Library-wide defaults (utils.config is the single source of truth).
_CFG = DreamConfig()


class DreamState(NamedTuple):
    heads: torch.Tensor       # (n_chains, d)
    head_lnp: torch.Tensor    # (n_chains,)
    key: torch.Generator
    p_cr: torch.Tensor        # (n_cr,) crossover selection probabilities
    jump_dist: torch.Tensor   # (n_cr,) accumulated normalized jump distance
    n_id: torch.Tensor        # (n_cr,) uses per CR value
    n_accept: torch.Tensor    # scalar int64, on the heads' device
    t: torch.Tensor           # generation counter, scalar int64


class _GenRand(NamedTuple):
    """Pre-drawn per-generation randomness (leading axis = generation)."""
    pairs: torch.Tensor      # (n, 2*delta_max) int
    delta: torch.Tensor      # (n,) int in [1, delta_max]
    u_cr: torch.Tensor       # (n,) uniform for the CR inverse-CDF draw
    z: torch.Tensor          # (n, d) uniform (subspace mask)
    force: torch.Tensor      # (n,) int in [0, d)
    u_jump: torch.Tensor     # (n,) uniform (unit-gamma mode jumps)
    e: torch.Tensor          # (n, d) uniform in [-b, b]
    eps: torch.Tensor        # (n, d) b_star * normal
    u_acc: torch.Tensor      # (n,) uniform (metropolis accept)


def _draw_dream(gen, n_gens, n_chains, d, delta_max, b, b_star,
                dtype) -> _GenRand:
    """All randomness of ``n_gens`` generations in nine batched draws on the
    generator's device: the one place DREAM draws."""
    dev = gen.device
    g = (n_gens, n_chains)

    def uniform(shape):
        return torch.rand(shape, generator=gen, dtype=dtype, device=dev)

    return _GenRand(
        pairs=pick_others_batched(gen, n_chains, 2 * delta_max,
                                  n_batch=n_gens, device=dev),
        delta=torch.randint(1, delta_max + 1, g, generator=gen, device=dev),
        u_cr=uniform(g),
        z=uniform(g + (d,)),
        force=torch.randint(0, d, g, generator=gen, device=dev),
        u_jump=uniform(g),
        e=(2.0 * uniform(g + (d,)) - 1.0) * b,
        eps=b_star * torch.randn(g + (d,), generator=gen, dtype=dtype,
                                 device=dev),
        u_acc=uniform(g),
    )


def _cr_histogram(cr_ids, jds, n_cr, dtype):
    """Per-CR-bin (jump-distance sum, use count) by one-hot masked
    reductions: they sum in a fixed order, which ``index_add_`` on a GPU
    does not, run to run."""
    bins = torch.arange(n_cr, device=cr_ids.device)
    onehot = (cr_ids[:, None] == bins[None, :]).to(dtype)
    return torch.sum(onehot * jds[:, None], dim=0), torch.sum(onehot, dim=0)


def _dream_generation(state: DreamState, rand: _GenRand, ln_prob_fn,
                      delta_max, n_cr, gamma_jump_prob, n_adapt,
                      prop_fixup_fn, population=None,
                      reduce=None) -> DreamState:
    """One DREAM generation from pre-drawn randomness (see _draw_dream).

    Where ``state`` holds a shard of the chains: ``population`` is all the
    heads (the pairs index them, their spread normalizes the jumps), and
    ``reduce`` sums the (2, n_cr) stack of the crossover histogram over the
    shards."""
    heads = state.heads
    n_chains, d = heads.shape
    dtype, dev = heads.dtype, heads.device
    pop = heads if population is None else population
    # chain spread for jump-distance normalization (guard zeros)
    chain_std = torch.std(pop, dim=0, correction=0) + 1e-30

    pair_mask = (
        torch.arange(delta_max, device=dev)[None, :] < rand.delta[:, None]
    ).to(dtype)[..., None]                            # (n, dm, 1)
    a_idx = rand.pairs[:, :delta_max]
    b_idx = rand.pairs[:, delta_max:]
    diff = torch.sum((pop[a_idx] - pop[b_idx]) * pair_mask, dim=1)  # (n, d)

    # crossover draw via the inverse CDF of the (adapting) p_cr, from the
    # pre-drawn uniforms
    cdf = torch.cumsum(state.p_cr, dim=0)[:-1]
    cr_ids = torch.sum(rand.u_cr[:, None] > cdf[None, :], dim=1)
    cr = (cr_ids.to(dtype) + 1.0) / n_cr
    mask = rand.z < cr[:, None]
    # guarantee at least one updated dimension per chain
    mask = mask | (torch.arange(d, device=dev)[None, :] == rand.force[:, None])
    d_eff = torch.sum(mask.to(dtype), dim=1)

    gamma = 2.38 / torch.sqrt(2.0 * rand.delta.to(dtype) * d_eff)
    unit_jump = rand.u_jump < gamma_jump_prob
    gamma = torch.where(unit_jump, torch.ones_like(gamma), gamma)

    step = (1.0 + rand.e) * gamma[:, None] * diff + rand.eps
    prop = torch.where(mask, heads + step, heads)
    if prop_fixup_fn is not None:
        prop = torch.func.vmap(prop_fixup_fn)(prop)

    lnp_prop = torch.func.vmap(ln_prob_fn)(prop)
    alpha = torch.exp(torch.clamp_max(lnp_prop - state.head_lnp, 0.0))
    alpha = torch.where(torch.isnan(alpha), torch.zeros_like(alpha), alpha)
    accepts = rand.u_acc < alpha
    xs = torch.where(accepts[:, None], prop, heads)
    lnps = torch.where(accepts, lnp_prop, state.head_lnp)
    # squared normalized jump distance of the realized moves
    jds = torch.sum(((xs - heads) / chain_std) ** 2, dim=1)

    # crossover adaptation (burn-in only)
    jd_add, id_add = _cr_histogram(cr_ids, jds, n_cr, dtype)
    if reduce is not None:
        jd_add, id_add = reduce(torch.stack([jd_add, id_add]))
    jump_dist = state.jump_dist + jd_add
    n_id = state.n_id + id_add
    mean_jump = jump_dist / n_id.clamp_min(1.0)
    p_cr_new = mean_jump / torch.sum(mean_jump).clamp_min(1e-30)
    p_cr_new = p_cr_new.clamp_min(0.05 / n_cr)  # keep every CR alive
    p_cr_new = p_cr_new / torch.sum(p_cr_new)
    p_cr = torch.where(state.t < n_adapt, p_cr_new, state.p_cr)

    return DreamState(
        xs, lnps, state.key, p_cr, jump_dist, n_id,
        state.n_accept + torch.sum(accepts), state.t + 1,
    )


def make_dream_state(init_heads, ln_prob_fn: Callable, n_cr: int = _CFG.n_cr,
                     key=0) -> DreamState:
    """Fresh DREAM state: uniform CR probabilities, zeroed adaptation
    statistics, generation counter at 0. ``key`` is an int seed or a
    ``torch.Generator`` on the heads' device."""
    heads = as_tensor(init_heads)
    zero = torch.zeros((), dtype=torch.int64, device=heads.device)
    return DreamState(
        heads, torch.func.vmap(ln_prob_fn)(heads),
        as_generator(key, heads.device),
        heads.new_ones((n_cr,)) / n_cr,
        heads.new_zeros((n_cr,)),
        heads.new_zeros((n_cr,)),
        zero, zero,
    )


def dream_run(init_heads, ln_prob_fn: Callable, n_steps: int, key=0,
              delta_max: int = _CFG.delta_max, n_cr: int = _CFG.n_cr,
              gamma_jump_prob: float = _CFG.gamma_jump_prob,
              b: float = _CFG.b, b_star: float = _CFG.b_star,
              n_adapt: int = _CFG.n_adapt, prop_fixup_fn=None,
              unroll: int | None = None,
              init_state: DreamState | None = None):
    """Run n_steps DREAM generations; returns (history, final_state).

    history: (n_steps, n_chains, d). ``n_adapt``: generations of crossover
    adaptation (0 = fixed uniform CR probabilities; for a valid stationary
    chain discard at least the first n_adapt generations).

    ``init_state``: resume from a previous run's final ``DreamState``:
    heads, adapted CR probabilities, jump statistics and the generation
    counter all carry over (``init_heads`` is ignored); the random stream is
    re-seeded from ``key``. This is how DreamSampler threads adaptation
    across blocks instead of restarting it.

    ``unroll`` is accepted for the JAX package's signature and ignored: the
    generations run in a host loop, which has nothing to unroll.
    """
    if init_state is None:
        state = make_dream_state(init_heads, ln_prob_fn, n_cr=n_cr, key=key)
    else:
        state = init_state._replace(
            key=as_generator(key, init_state.heads.device))
    n_chains, d = state.heads.shape
    assert n_chains >= 2 * delta_max + 1, (
        "DREAM needs n_chains >= 2*delta_max + 1"
    )
    n_steps = int(n_steps)
    history = state.heads.new_empty((n_steps, n_chains, d))
    # the chunk bounds the memory of the pre-drawn tensors, (chunk, n, d) each
    chunk = _chunk_for(n_chains)
    for start in range(0, n_steps, chunk):
        n_gen = min(chunk, n_steps - start)
        rand = _draw_dream(state.key, n_gen, n_chains, d, delta_max, b,
                           b_star, state.heads.dtype)
        for i in range(n_gen):
            state = _dream_generation(
                state, _GenRand(*(r[i] for r in rand)), ln_prob_fn,
                delta_max, n_cr, gamma_jump_prob, n_adapt, prop_fixup_fn,
            )
            history[start + i] = state.heads
    return history, state


def outlier_reset(heads, head_lnp):
    """Vrugt-style outlier-chain correction (burn-in only).

    Chains whose head log-density falls below Q1 - 2*IQR are relocated to
    the best chain's state. Breaks detailed balance, so apply only during
    burn-in (DreamSampler does this automatically within its n_adapt
    window). Returns (new_heads, new_lnp, n_reset).
    """
    q = torch.quantile(head_lnp, head_lnp.new_tensor([0.25, 0.75]))
    thresh = q[0] - 2.0 * (q[1] - q[0])
    is_outlier = head_lnp < thresh
    best = torch.argmax(head_lnp)
    new_heads = torch.where(is_outlier[:, None], heads[best][None, :], heads)
    new_lnp = torch.where(is_outlier, head_lnp[best], head_lnp)
    return new_heads, new_lnp, torch.sum(is_outlier)


class DreamSampler:
    """Stateful wrapper mirroring the DeMcSampler surface (get_samples,
    accept_ratio) with DREAM proposals.

    ``outlier_correct=True`` applies the IQR outlier-chain test every
    ``outlier_every`` generations while still inside the ``n_adapt``
    burn-in window (stuck chains relocate to the best chain, standard
    DREAM practice; never applied after burn-in, so the stationary chain
    remains a valid MCMC). ``key`` is an int seed or a ``torch.Generator``
    on the chains' device; its stream runs on from block to block."""

    def __init__(self, ln_prob_fn: Callable, init_chains,
                 delta_max: int = _CFG.delta_max, n_cr: int = _CFG.n_cr,
                 gamma_jump_prob: float = _CFG.gamma_jump_prob,
                 b: float = _CFG.b, b_star: float = _CFG.b_star,
                 n_adapt: int = _CFG.n_adapt,
                 prop_fixup_fn: Callable | None = None, key=0,
                 outlier_correct: bool = False, outlier_every: int = 100,
                 config: DreamConfig | None = None):
        heads = as_tensor(init_chains)
        self.n_chains, self.ndim = heads.shape
        self.ln_prob_fn = ln_prob_fn
        cfg = config or DreamConfig(
            delta_max=delta_max, n_cr=n_cr, gamma_jump_prob=gamma_jump_prob,
            b=b, b_star=b_star, n_adapt=n_adapt,
        )
        self.cfg = dict(
            delta_max=cfg.delta_max, n_cr=cfg.n_cr,
            gamma_jump_prob=cfg.gamma_jump_prob, b=cfg.b, b_star=cfg.b_star,
            n_adapt=cfg.n_adapt,
        )
        self.prop_fixup_fn = prop_fixup_fn
        self.outlier_correct = bool(outlier_correct)
        self.outlier_every = int(outlier_every)
        self._key = as_generator(key, heads.device)
        self._heads = heads
        # the full DreamState threads across blocks: the adapted p_cr, jump
        # statistics and the generation counter persist, so adaptation
        # continues across _run_block calls and FREEZES (rather than
        # resetting to uniform) once state.t reaches n_adapt
        self._state: DreamState | None = None
        self._history = [heads[None, :, :]]
        self.n_accept = 0
        self.n_total = 0
        self.n_outlier_resets = 0
        self._gens = 0  # generations drawn so far (adaptation is global)

    def _run_block(self, block: int):
        history, state = dream_run(
            self._heads, self.ln_prob_fn, block, key=self._key,
            prop_fixup_fn=self.prop_fixup_fn, init_state=self._state,
            **self.cfg,
        )
        self._state = state
        self._heads = state.heads
        self._history.append(history)
        # the state's count is cumulative; read it once a block
        self.n_accept = int(state.n_accept)
        self.n_total += block * self.n_chains
        self._gens += block

    def sample_mcmc(self, n_samples: int):
        n = int(n_samples)
        done = 0
        while done < n:
            adapt_left = max(self.cfg["n_adapt"] - self._gens, 0)
            if self.outlier_correct and adapt_left > 0:
                block = min(self.outlier_every, n - done, adapt_left)
            else:
                block = n - done
            self._run_block(block)
            done += block
            if self.outlier_correct and self._gens <= self.cfg["n_adapt"]:
                new_heads, new_lnp, n_reset = outlier_reset(
                    self._state.heads, self._state.head_lnp
                )
                self._state = self._state._replace(
                    heads=new_heads, head_lnp=new_lnp
                )
                self._heads = new_heads
                self.n_outlier_resets += int(n_reset)
        return self

    def accept_ratio(self) -> float:
        return self.n_accept / self.n_total if self.n_total else 0.0

    @property
    def chain_history(self) -> torch.Tensor:
        return torch.cat(self._history, dim=0)

    def get_chain_samples(self, n_tail: int, chain_id: int) -> torch.Tensor:
        return self.chain_history[-n_tail:, chain_id, :]

    def get_samples(self, n_tail: int) -> torch.Tensor:
        if n_tail == 0:
            return self._heads.new_zeros((0, self.ndim))
        tail = self.chain_history[-n_tail:]
        return tail.reshape(n_tail * self.n_chains, self.ndim)
