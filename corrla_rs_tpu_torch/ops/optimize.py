"""Optimizers for maximum-likelihood fitting.

Counterpart of ``corrla_rs_tpu/ops/optimize.py``, which replaces the
reference's argmin-crate solver zoo (univariate_rv.rs:24-99): method 0 =
gradient descent with a backtracking line search (SteepestDescent parity),
1 = particle swarm, 2 = BFGS. As in the JAX package, gradients are exact
(``torch.func.grad``) instead of forward finite differences
(univariate_rv.rs:136-154), and the particle swarm polishes its best
particle with a BFGS descent.

The quadratic out-of-bounds penalty matches OptMleProblem::cost
(univariate_rv.rs:126-135). ``mlefit_ps_fallback`` retries a failed fit with
particle swarm (univariate_rv.rs:87-99).

torch has no one-call BFGS, so ``_bfgs`` is a small dense one: inverse-Hessian
updates, a backtracking Armijo line search, the gradient's largest entry
below 1e-5 as the stopping rule. It reaches the same minimum as the JAX
package's ``jax.scipy.optimize.minimize`` by other iterates. Every loop here
runs on the host and reads a few scalars an iteration from the device: these
are small problems, and on a GPU they are bound by the host.

A cost function maps one (d,) parameter tensor to a scalar with operations
that ``torch.func`` can differentiate and batch. Parameters take the dtype of
a floating ``p_init`` tensor, else float64, and live on ``device`` (default
``utils.device.default_device()``, or where ``p_init`` already is).
"""
from __future__ import annotations

from typing import Callable

import torch

from corrla_rs_tpu_torch.utils.device import default_device
from corrla_rs_tpu_torch.utils.log import get_logger
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["penalized_cost", "mlefit", "mlefit_ps_fallback", "particle_swarm"]


def _param(p, like: torch.Tensor | None = None) -> torch.Tensor:
    """``p`` as a parameter tensor: on ``like``'s device and dtype, or its
    own if it is a floating tensor, else float64 on the default device."""
    if like is not None:
        return torch.as_tensor(p, dtype=like.dtype, device=like.device)
    if isinstance(p, torch.Tensor) and p.is_floating_point():
        return p
    return torch.as_tensor(p, dtype=torch.float64, device=default_device())


def _bounds_like(p_bounds, p: torch.Tensor):
    """(lb, ub) as tensors of ``p``'s dtype and device."""
    return _param(p_bounds[0], p), _param(p_bounds[1], p)


def penalized_cost(cost_fn: Callable, p_bounds) -> Callable:
    """cost + 10 * sum(min(p-lb,0)^2 + max(p-ub,0)^2). univariate_rv.rs:126-135."""
    cache: dict = {}

    def cost(p):
        key = (p.dtype, p.device)
        if key not in cache:
            cache[key] = _bounds_like(p_bounds, p)
        lb, ub = cache[key]
        pen = 10.0 * torch.sum(torch.clamp_max(p - lb, 0.0) ** 2)
        pen = pen + 10.0 * torch.sum(torch.clamp_min(p - ub, 0.0) ** 2)
        return cost_fn(p) + pen

    return cost


def _steepest_descent(cost, p0, max_iters=40, n_backtrack=20):
    """Gradient descent with a backtracking line search: a fixed
    ``max_iters`` x ``n_backtrack`` loop that takes the first step size
    1, 1/2, 1/4, ... that lowers the cost, with no read from the device."""
    grad = torch.func.grad(cost)
    p, f = p0, cost(p0)
    for _ in range(max_iters):
        g = grad(p)
        p_best, f_best = p, f
        done = torch.zeros((), dtype=torch.bool, device=p.device)
        for j in range(n_backtrack):
            p_try = p - 0.5 ** j * g
            f_try = cost(p_try)
            better = (f_try < f) & ~done
            p_best = torch.where(better, p_try, p_best)
            f_best = torch.where(better, f_try, f_best)
            done = done | better
        p, f = p_best, f_best
    return p


def _bfgs(cost, p0, gtol: float = 1e-5, max_iters: int | None = None,
          n_backtrack: int = 60):
    """Dense BFGS with a backtracking Armijo line search; returns (p, f).

    Stops when max |grad| <= gtol, when the decrease a step could still
    win falls below the rounding of the cost (the attainable accuracy),
    when no step of the line search lowers the cost, or after ``max_iters``
    (default 200 a dimension) iterations. A trial point whose cost is not finite
    is rejected like one that is too high, and so is one whose cost only
    equals the current one: a step shrunk until the cost rounds to the same
    value is no decrease, and accepting it would repeat the same search
    until ``max_iters``. The inverse-Hessian update is skipped where the
    curvature s.y is not safely positive.
    """
    value_and_grad = torch.func.grad_and_value(cost)

    def evaluate(p):
        g, f = value_and_grad(p)
        return f.detach(), g.detach()

    p = p0.detach()
    d = p.numel()
    if max_iters is None:
        max_iters = 200 * d
    eye = torch.eye(d, dtype=p.dtype, device=p.device)
    eps = torch.finfo(p.dtype).eps
    h = eye
    f, g = evaluate(p)
    # first step of about unit length, as no curvature is known yet
    step0 = 1.0 / max(float(g.abs().sum()), 1.0)
    for it in range(max_iters):
        if not bool(torch.isfinite(g).all()) or float(g.abs().max()) <= gtol:
            break
        dirn = -(h @ g)
        slope = float(g @ dirn)
        if not slope < 0.0:
            h, dirn = eye, -g
            slope = -float(g @ g)
        # -slope = g.H.g is twice the decrease a full step can win: below
        # the rounding of f itself no line search can see it, and without
        # this stop each further "iteration" is a run of halvings that ends
        # on rounding's luck (a sum over 1e5 samples leaves max |grad| at
        # 1e-4, above gtol, for thousands of evaluations)
        if it and -slope <= 4.0 * eps * max(abs(float(f)), 1.0):
            break
        t = step0 if it == 0 else 1.0
        for _ in range(n_backtrack):
            p_new = p + t * dirn
            f_new, g_new = evaluate(p_new)
            # False for NaN, and for a cost that did not go down
            if bool((f_new <= f + 1e-4 * t * slope) & (f_new < f)):
                break
            t *= 0.5
        else:
            break
        s, y = p_new - p, g_new - g
        sy = float(s @ y)
        if sy > 1e-10 * float(torch.linalg.vector_norm(s)
                              * torch.linalg.vector_norm(y)):
            if it == 0:
                h = eye * (sy / float(y @ y))
            rho = 1.0 / sy
            v = eye - rho * torch.outer(s, y)
            h = v @ h @ v.mT + rho * torch.outer(s, s)
        p, f, g = p_new, f_new, g_new
    return p, f


def _draw_swarm(key, n_particles: int, d: int, n_iters: int, dtype, device):
    """The swarm's uniforms: the start positions (n_particles, d) and the
    two (n_iters, n_particles, d) blocks of the velocity updates. The one
    place the swarm draws."""
    gen = as_generator(key, device)
    shape = (n_particles, d)
    x0 = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    r1 = torch.rand((n_iters,) + shape, generator=gen, dtype=dtype,
                    device=device)
    r2 = torch.rand((n_iters,) + shape, generator=gen, dtype=dtype,
                    device=device)
    return x0, r1, r2


def particle_swarm(cost: Callable, p_bounds, key, n_particles: int = 40,
                   n_iters: int = 100, polish: bool = True):
    """Global-ish PSO over a box; the population is batched with
    ``torch.func.vmap``.

    Standard constriction coefficients (w=0.7298, c1=c2=1.4962). With
    ``polish`` a BFGS descent from the swarm best follows (improvement over
    the reference's bare argmin ParticleSwarm, univariate_rv.rs:43-60).
    ``key`` is an int seed or a ``torch.Generator``.
    """
    lb = _param(p_bounds[0])
    ub = _param(p_bounds[1], lb)
    d = lb.shape[0]
    u0, r1, r2 = _draw_swarm(key, n_particles, d, n_iters, lb.dtype,
                             lb.device)
    batched = torch.func.vmap(cost)
    x = u0 * (ub - lb) + lb
    v = torch.zeros_like(x)
    f = batched(x)
    pbest, pf = x, f
    g_idx = torch.argmin(f)
    gbest, gf = x[g_idx], f[g_idx]
    w, c1, c2 = 0.7298, 1.4962, 1.4962
    for i in range(n_iters):
        v = w * v + c1 * r1[i] * (pbest - x) + c2 * r2[i] * (gbest[None, :] - x)
        x = torch.minimum(torch.maximum(x + v, lb), ub)
        f = batched(x)
        improved = f < pf
        pbest = torch.where(improved[:, None], x, pbest)
        pf = torch.where(improved, f, pf)
        b = torch.argmin(pf)
        gbest = torch.where(pf[b] < gf, pbest[b], gbest)
        gf = torch.minimum(pf[b], gf)
    if polish:
        p_pol, f_pol = _bfgs(cost, gbest)
        better = torch.isfinite(f_pol) & (f_pol < gf)
        gbest = torch.where(better, p_pol, gbest)
    return gbest


def mlefit(cost_fn: Callable, p_init, p_bounds, method: int = 2, key=0):
    """Minimize a (penalized) cost. Parity with mlefit dispatch
    (univariate_rv.rs:24-83): 0=SteepestDescent, 1=ParticleSwarm, 2=BFGS."""
    cost = penalized_cost(cost_fn, p_bounds)
    p0 = _param(p_init)
    if method == 0:
        return _steepest_descent(cost, p0)
    if method == 1:
        return particle_swarm(cost, _bounds_like(p_bounds, p0), key)
    if method == 2:
        return _bfgs(cost, p0)[0]
    raise ValueError("Supply valid method: 0=SD, 1=PS, 2=BFGS")


def mlefit_ps_fallback(cost_fn: Callable, p_init, p_bounds, method: int = 2,
                       key=0):
    """mlefit with particle-swarm retry on failure (non-finite params or
    cost). Parity with univariate_rv.rs:87-99. An invalid ``method`` raises
    (the reference panics, univariate_rv.rs:78-80) rather than silently
    falling back."""
    if method not in (0, 1, 2):
        raise ValueError("Supply valid method: 0=SD, 1=PS, 2=BFGS")
    cost = penalized_cost(cost_fn, p_bounds)
    p0 = _param(p_init)
    try:
        p = mlefit(cost_fn, p0, p_bounds, method, key)
        if bool(torch.isfinite(p).all() & torch.isfinite(cost(p))):
            return p
    except (FloatingPointError, ValueError, ArithmeticError) as exc:
        # Numeric optimizer failure -> retry with particle swarm (parity
        # with the reference's fallback). Programming errors in the user's
        # cost function (shape mismatches, typos -> TypeError etc.)
        # propagate instead of surfacing as a slow, possibly wrong PS fit.
        get_logger().warning(
            "mlefit(method=%d) failed numerically (%s); retrying with "
            "particle swarm", method, exc,
        )
    return particle_swarm(cost, _bounds_like(p_bounds, p0), key)
