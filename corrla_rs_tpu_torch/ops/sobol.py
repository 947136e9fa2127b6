"""Variance-based global sensitivity: Sobol' indices.

Counterpart of ``corrla_rs_tpu/ops/sobol.py``: first-order and total-effect
indices with the Saltelli (2010) / Jansen (1999) pick-freeze estimators

    S1_i = mean(f(B) * (f(AB_i) - f(A))) / Var(f)       (first order)
    ST_i = 0.5 * mean((f(A) - f(AB_i))^2) / Var(f)      (total effect)

with all (d + 2) * n model evaluations stacked into one batched call.

Sampling plans: ``plan="uniform"`` draws its two (n, d) uniform matrices
through this module's seam ``_draw_uniform`` (on the device);
``plan="sobol"`` is a scrambled Sobol' sequence from ``scipy.stats.qmc``
seeded by ``ops.design._seed_from_key``, as in the JAX package. The
bootstrap resamples evaluation rows with no new model evaluations: its
(n_boot, n) index table comes from the seam ``_draw_boot_indices``, and the
replicates are batched gathers and reductions over blocks of replicates.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops.design import _box, _device, _seed_from_key
from corrla_rs_tpu_torch.utils.device import as_tensor
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["saltelli_plan", "sobol_indices"]

# gathered evaluations a block of bootstrap replicates holds
_BOOT_BLOCK_ELEMS = 1 << 27


def _draw_uniform(key, n: int, d: int, device):
    """(ua, ub): two (n, d) float64 uniform matrices on ``device``, the
    A and B halves of the uniform plan."""
    gen = as_generator(key, device)
    ua = torch.rand((n, d), generator=gen, dtype=torch.float64,
                    device=device)
    ub = torch.rand((n, d), generator=gen, dtype=torch.float64,
                    device=device)
    return ua, ub


def _draw_boot_indices(key, n_boot: int, n: int, device):
    """(n_boot, n) int64 row indices in [0, n), one bootstrap resample a
    row."""
    gen = as_generator(key, device)
    return torch.randint(0, n, (int(n_boot), n), generator=gen,
                         device=device)


def saltelli_plan(bounds, n_base: int, key=0, plan: str = "uniform",
                  device=None):
    """(A, B, AB) sample matrices for the pick-freeze estimators.

    bounds: (d, 2) [lo, hi] per input. Returns ``(a (n, d), b (n, d),
    ab (d, n, d))`` float64 tensors on ``device`` (default
    ``utils.device.default_device()``), ``ab[i]`` = A with column i from B.
    plan: 'uniform' (i.i.d. uniforms) or 'sobol' (scrambled Sobol', first d
    dimensions to A and the next d to B).
    """
    dev = _device(device)
    d, lo, span = _box(bounds, dev)

    if plan == "sobol":
        from scipy.stats import qmc

        u = qmc.Sobol(2 * d, scramble=True,
                      seed=_seed_from_key(key)).random(n_base)
        u = torch.as_tensor(u, device=dev)
        ua, ub = u[:, :d], u[:, d:]
    elif plan == "uniform":
        ua, ub = _draw_uniform(key, int(n_base), d, dev)
    else:
        raise ValueError(f"plan must be 'uniform' or 'sobol', got {plan!r}")

    a = lo + ua * span
    b = lo + ub * span
    eye = torch.eye(d, dtype=torch.bool, device=dev)
    # ab[i] = a with column i from b
    ab = torch.where(eye[:, None, :], b[None, :, :], a[None, :, :])
    return a, b, ab


def _estimate(f_a, f_b, f_ab):
    """(mu, var, s1, st) of evaluation rows; leading dims batch (the
    bootstrap replicates)."""
    mu = 0.5 * (f_a.mean(dim=-1) + f_b.mean(dim=-1))
    var = 0.5 * (f_a.var(dim=-1, correction=0)
                 + f_b.var(dim=-1, correction=0))
    var = var.clamp_min(torch.finfo(f_a.dtype).tiny)
    s1 = (f_b[..., None, :] * (f_ab - f_a[..., None, :])).mean(dim=-1) \
        / var[..., None]
    st = 0.5 * ((f_a[..., None, :] - f_ab) ** 2).mean(dim=-1) \
        / var[..., None]
    return mu, var, s1, st


def sobol_indices(f, bounds, n_base: int, key=0, plan: str = "uniform",
                  n_boot: int = 0, boot_key=1, device=None):
    """First-order and total-effect Sobol' indices of ``f`` over a box.

    f: vectorized model, (n, d) tensor -> (n,) or (n, 1), evaluated once on
    the stacked ((d + 2) * n_base, d) design. Returns a dict of tensors:
    ``s1`` (d,), ``st`` (d,), ``var``, ``mean``; with ``n_boot`` > 0 also
    the 2.5/97.5% bootstrap bands ``s1_lo/s1_hi/st_lo/st_hi``.
    """
    a, b, ab = saltelli_plan(bounds, n_base, key=key, plan=plan,
                             device=device)
    n, d = a.shape
    x_all = torch.cat([a, b, ab.reshape(d * n, d)], dim=0)
    y_all = as_tensor(f(x_all), device=a.device).reshape(-1)
    if y_all.shape[0] != (d + 2) * n:
        raise ValueError(
            f"model returned {y_all.shape[0]} outputs for {(d + 2) * n} "
            "inputs; f must be vectorized (n, d) -> (n,)"
        )
    f_a = y_all[:n]
    f_b = y_all[n:2 * n]
    f_ab = y_all[2 * n:].reshape(d, n)

    mu, var, s1, st = _estimate(f_a, f_b, f_ab)
    out = {"mean": mu, "var": var, "s1": s1, "st": st}

    if n_boot > 0:
        idx = _draw_boot_indices(boot_key, n_boot, n, a.device)  # (B, n)
        # replicates in blocks of about _BOOT_BLOCK_ELEMS gathered values
        # (all 200 of a 2^20-row plan in 8-D at once would take 13 GB)
        step = max(1, _BOOT_BLOCK_ELEMS // ((d + 2) * n))
        parts = [_estimate(f_a[blk], f_b[blk],
                           f_ab[:, blk].transpose(0, 1))[2:]
                 for blk in idx.split(step)]
        s1_bs = torch.cat([p[0] for p in parts])
        st_bs = torch.cat([p[1] for p in parts])
        qs = torch.tensor([0.025, 0.975], dtype=s1_bs.dtype,
                          device=s1_bs.device)
        s1_q = torch.quantile(s1_bs, qs, dim=0)
        st_q = torch.quantile(st_bs, qs, dim=0)
        out.update(
            s1_lo=s1_q[0], s1_hi=s1_q[1], st_lo=st_q[0], st_hi=st_q[1]
        )
    return out
