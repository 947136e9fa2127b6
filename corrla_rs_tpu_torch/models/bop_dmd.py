"""Bagged DMD: eigenvalue and mode uncertainty by ensemble resampling.

Counterpart of ``corrla_rs_tpu/models/bop_dmd.py`` (the BOP-DMD bagging
idea, Sashidhar & Kutz 2022): B exact-DMD models are fitted on random
subsets of the snapshot pairs, and their spread gives eigenvalue scatter,
mode bands and forecast intervals.

Member b's seeds are the two children of the (b+1)-th child of ``key``
(``ops.random_svd._split_seed``, as the JAX package splits its keys); its
pair subset, drawn without replacement, comes from this module's one seam,
``_draw_subset``, and its randomized SVD draws through
``ops.random_svd._draw_sketch``. The JAX package fits all members in one
``jit(vmap)``; the port fits them one after another, since a member's
subset of a large trajectory is large (all 64 subsets of 200,000 x 1,000
f32 pairs would take about 82 GB at once), and collects every member's
r x r reduced operator for one batched ``ops.eig.eig`` (``torch.linalg.eig``
on the device) in place of the JAX package's Francis-QR ``eig_device``.
Each member's results are those of the batched form: its eigenvector
scaling differs, but every member mode is rescaled onto the reference
mode by least squares before any statistic. The alignment (scipy's
``linear_sum_assignment``) and the band statistics run on the host, as in
the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from corrla_rs_tpu_torch.models.dmd import DMD
from corrla_rs_tpu_torch.ops import random_svd as _rsvd
from corrla_rs_tpu_torch.ops.eig import eig
from corrla_rs_tpu_torch.utils.checkpoint import register_model_class
from corrla_rs_tpu_torch.utils.device import as_tensor
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["BaggedDmd", "bagged_dmd"]


def _draw_subset(seed_or_gen, n_pairs: int, n_sub: int, device):
    """``n_sub`` distinct pair indices of ``range(n_pairs)``, int64 on
    ``device``: the one place a member's subset is drawn."""
    gen = as_generator(seed_or_gen, device)
    return torch.randperm(n_pairs, generator=gen, device=device)[:n_sub]


def _fit_member(x1, x2, key, n_pairs, n_sub, n_modes, n_iters, n_os):
    """One member: subset -> RSVD -> (reduced operator (r, r), exact-mode
    prefactor X2 V S^-1 (n, r))."""
    k_sub, k_svd = _rsvd._split_seed(key, 2, x1.device)
    idx = _draw_subset(k_sub, n_pairs, n_sub, x1.device)
    x1s = x1[:, idx]
    x2s = x2[:, idx]
    u, s, vt = _rsvd.random_svd(x1s, n_modes, n_iters, n_os, key=k_svd)
    del x1s
    s_inv = torch.where(s > torch.finfo(s.dtype).eps * s[0],
                        1.0 / s, torch.zeros_like(s))
    # A~ = U^T X2 V S^-1 ; exact modes Phi = X2 V S^-1 W
    x2vs = x2s @ (vt.mT * s_inv[None, :])             # (n, r)
    return u.mT @ x2vs, x2vs


def _align(lam_ref, lam_mem):
    """Optimal assignment of one member's eigenvalues onto the reference
    spectrum (least total complex distance)."""
    from scipy.optimize import linear_sum_assignment

    cost = np.abs(lam_mem[None, :] - lam_ref[:, None])
    _, cols = linear_sum_assignment(cost)
    return cols


@register_model_class
class BaggedDmd:
    """Result container for :func:`bagged_dmd`.

    ``lambdas_ref`` (r,) full-data reference spectrum; ``lambdas_all`` (B, r)
    member spectra aligned to the reference; ``lambdas_mean`` /
    ``lambdas_std`` (r,); ``modes_ref_re``/``modes_ref_im`` (n, r) tensors;
    ``modes_all_re``/``modes_all_im`` (B, n, r), ``modes_mean`` /
    ``modes_std`` (n, r) host arrays (member modes least-squares rescaled
    onto the reference mode before the statistics).
    """

    def predict(self, x_0, n_steps: int) -> np.ndarray:
        """Bagged-mean spectral forecast (n, n_steps)."""
        mean, _, _ = self.predict_interval(x_0, n_steps)
        return mean

    def predict_interval(self, x_0, n_steps: int, lo: float = 2.5,
                         hi: float = 97.5):
        """(mean, lo_band, hi_band) each (n, n_steps): pointwise
        percentiles of the member spectral forecasts."""
        if isinstance(x_0, torch.Tensor):
            x_0 = x_0.detach().cpu().numpy()
        x0 = np.asarray(x_0, np.float64).reshape(-1)
        if x0.size != self.n_state:
            raise ValueError(
                f"x_0 must have {self.n_state} entries, got {x0.size}"
            )
        t = np.arange(1, int(n_steps) + 1)
        preds = np.empty(
            (self.n_members, self.n_state, t.size), np.float64
        )
        for b in range(self.n_members):
            phi = self.modes_all_re[b] + 1j * self.modes_all_im[b]
            lam = self.lambdas_all[b]
            b0, _, _, _ = np.linalg.lstsq(phi, x0, rcond=None)
            coefs = (lam[None, :] ** t[:, None]) * b0[None, :]  # (T, r)
            preds[b] = np.real(coefs @ phi.T).T
        return (
            preds.mean(axis=0),
            np.percentile(preds, lo, axis=0),
            np.percentile(preds, hi, axis=0),
        )


def bagged_dmd(x_data, n_modes: int, n_members: int = 64,
               subset_frac: float = 0.8, n_iters: int = 10, key=0,
               n_oversamples: int = 8, device=None) -> BaggedDmd:
    """Fit B exact-DMD models on random snapshot-pair subsets.

    x_data: (n, m) trajectory columns (m-1 pairs); ``subset_frac`` of the
    pairs (without replacement) go into each member. ``device`` is where
    numpy input goes. See :class:`BaggedDmd` for the returned statistics.
    """
    if not 0.0 < subset_frac <= 1.0:
        raise ValueError(
            f"subset_frac must be in (0, 1], got {subset_frac}"
        )
    if n_members < 2:
        raise ValueError(f"n_members must be >= 2, got {n_members}")
    x = as_tensor(x_data, device=device)
    if x.ndim != 2 or x.shape[1] < 3:
        raise ValueError(
            f"x_data must be (n, m >= 3), got {tuple(x.shape)}"
        )
    n, m = x.shape
    n_pairs = m - 1
    r = int(n_modes)
    n_sub = max(int(round(subset_frac * n_pairs)), r + 1)
    n_sub = min(n_sub, n_pairs)
    x1, x2 = x[:, :-1], x[:, 1:]

    keys = _rsvd._split_seed(key, int(n_members) + 1, x.device)
    parts = [_fit_member(x1, x2, k, n_pairs, n_sub, r, int(n_iters),
                         int(n_oversamples)) for k in keys[1:]]
    a_all = torch.stack([a for a, _ in parts])
    x2vs = torch.stack([p for _, p in parts])
    del parts
    lam, w = eig(a_all)                                # one batched eig
    modes = x2vs.to(w.dtype) @ w                       # (B, n, r) complex
    lam_all = lam.cpu().numpy()
    mo_re = modes.real.to(x.dtype).cpu().numpy()
    mo_im = modes.imag.to(x.dtype).cpu().numpy()
    del modes, x2vs

    # full-data reference fit for alignment
    ref = DMD(x, r, n_iters=int(n_iters), key=keys[0])
    lam_ref = ref.lambdas
    phi_ref = ref.modes_re.cpu().numpy() + 1j * ref.modes_im.cpu().numpy()

    out = BaggedDmd.__new__(BaggedDmd)
    out.n_state = int(n)
    out.n_members = int(n_members)
    out.n_modes = r
    out.lambdas_ref = lam_ref
    out.modes_ref_re = ref.modes_re
    out.modes_ref_im = ref.modes_im
    aligned_lam = np.empty_like(lam_all)
    aligned_re = np.empty_like(mo_re)
    aligned_im = np.empty_like(mo_im)
    for b in range(int(n_members)):
        cols = _align(lam_ref, lam_all[b])
        aligned_lam[b] = lam_all[b][cols]
        phi_b = (mo_re[b] + 1j * mo_im[b])[:, cols]
        # least-squares complex rescale of each mode onto the reference
        # (per-fit mode scale and phase are arbitrary)
        denom = np.sum(np.abs(phi_b) ** 2, axis=0)
        denom = np.where(denom > 0, denom, 1.0)
        c = np.sum(np.conj(phi_b) * phi_ref, axis=0) / denom
        phi_b = phi_b * c[None, :]
        aligned_re[b] = np.real(phi_b)
        aligned_im[b] = np.imag(phi_b)
    out.lambdas_all = aligned_lam
    out.modes_all_re = aligned_re
    out.modes_all_im = aligned_im
    out.lambdas_mean = aligned_lam.mean(axis=0)
    out.lambdas_std = np.sqrt(
        np.mean(np.abs(aligned_lam - out.lambdas_mean[None, :]) ** 2,
                axis=0)
    )
    phi_all = aligned_re + 1j * aligned_im
    out.modes_mean = phi_all.mean(axis=0)
    out.modes_std = np.sqrt(
        np.mean(np.abs(phi_all - out.modes_mean[None]) ** 2, axis=0)
    )
    return out
