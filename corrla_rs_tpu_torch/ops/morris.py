"""Morris elementary-effects screening.

Counterpart of ``corrla_rs_tpu/ops/morris.py``: r trajectories of d + 1
model evaluations give per-input measures

    mu_star_i = mean |EE_i|   (overall importance; Campolongo 2007)
    sigma_i   = std EE_i      (nonlinearity / interaction strength)

with EE_i = (f(x + delta e_i) - f(x)) / delta along each trajectory.

The trajectories are built on the device from one seam, ``_draw_morris``,
which returns every draw they need: the start levels, each trajectory's
permutation of the coordinates and the step signs (the JAX package splits
its key three ways and permutes under ``vmap``). All r * (d + 1) points
are evaluated in one batched model call; the effects are a reshape, a
difference and a scatter.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops.design import _box, _device
from corrla_rs_tpu_torch.utils.device import as_tensor
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["morris_trajectories", "morris_screening"]


def _draw_morris(key, n_traj: int, d: int, n_levels: int, device):
    """(levels (r, d) int64 in [0, p/2), order (r, d) int64, each row a
    permutation of range(d), signs (r, d) float64 of +-1) on ``device``."""
    gen = as_generator(key, device)
    levels = torch.randint(0, n_levels // 2, (n_traj, d), generator=gen,
                           device=device)
    order = torch.argsort(torch.rand((n_traj, d), generator=gen,
                                     device=device), dim=1)
    up = torch.rand((n_traj, d), generator=gen, device=device) < 0.5
    signs = torch.where(up, 1.0, -1.0).to(torch.float64)
    return levels, order, signs


def morris_trajectories(bounds, n_traj: int, key=0, n_levels: int = 4,
                        device=None):
    """Morris (1991) one-at-a-time trajectories on a p-level grid.

    Returns ``(points (r, d+1, d), signs (r, d), order (r, d))`` tensors on
    ``device`` (default ``utils.device.default_device()``): each trajectory
    starts at a random grid point and moves one coordinate by +-delta a
    step (delta = p / (2(p-1))) in a random coordinate order, with starts
    that keep every step inside the box. ``signs[t, j]`` is the direction
    coordinate ``order[t, j]`` moved at step j of trajectory t.
    """
    dev = _device(device)
    d, lo, span = _box(bounds, dev)
    p = int(n_levels)
    if p < 2 or p % 2:
        raise ValueError(f"n_levels must be even and >= 2, got {n_levels}")
    delta = p / (2.0 * (p - 1.0))

    lev, order, signs = _draw_morris(key, int(n_traj), d, p, dev)
    # start levels in {0, 1/(p-1), ..., (p/2 - 1)/(p-1)} (so +delta stays
    # in [0, 1]); a negative step instead starts reflected at 1 - level
    levels = lev.to(torch.float64) / (p - 1.0)
    start = torch.where(signs > 0, levels, 1.0 - levels)

    # step matrix: row j moves coordinate order[j] in its stored direction
    eye = torch.eye(d, dtype=torch.float64, device=dev)
    step_signs = torch.gather(signs, 1, order)             # (r, d)
    steps = eye[order] * (step_signs[:, :, None] * delta)   # (r, d, d)
    offsets = torch.cat(
        [torch.zeros((int(n_traj), 1, d), dtype=torch.float64, device=dev),
         torch.cumsum(steps, dim=1)], dim=1)                # (r, d+1, d)
    unit = start[:, None, :] + offsets
    return lo + unit * span, signs, order


def morris_screening(f, bounds, n_traj: int = 64, key=0, n_levels: int = 4,
                     device=None):
    """Elementary-effects screening of ``f`` over a box.

    f: vectorized model, (n, d) tensor -> (n,), evaluated once on the
    stacked (r * (d+1), d) design. Returns a dict of tensors: ``mu`` (mean
    EE), ``mu_star`` (mean |EE|, the importance ranking), ``sigma`` (std EE,
    ddof 1), each (d,), and ``ee`` (r, d), the raw effects.
    """
    if n_traj < 2:
        raise ValueError(
            f"n_traj must be >= 2 (sigma uses ddof=1), got {n_traj}"
        )
    pts, signs, order = morris_trajectories(
        bounds, n_traj, key=key, n_levels=n_levels, device=device
    )
    d = pts.shape[-1]
    _, _lo, span = _box(bounds, pts.device)
    p = int(n_levels)
    delta = p / (2.0 * (p - 1.0))

    y = as_tensor(f(pts.reshape(n_traj * (d + 1), d)),
                  device=pts.device).reshape(n_traj, d + 1)
    # the EE of step j belongs to coordinate order[t, j]; it is normalized
    # by the step in physical units so mu_star compares across ranges
    step_signs = torch.gather(signs, 1, order)
    diffs = (y[:, 1:] - y[:, :-1]) / (step_signs * delta * span[order])
    ee = torch.zeros((n_traj, d), dtype=diffs.dtype, device=pts.device)
    ee.scatter_(1, order, diffs)
    mu = ee.mean(dim=0)
    mu_star = ee.abs().mean(dim=0)
    sigma = ee.std(dim=0, correction=1)
    return {"mu": mu, "mu_star": mu_star, "sigma": sigma, "ee": ee}
