"""Physics-informed DMD (piDMD).

Counterpart of ``corrla_rs_tpu/models/pidmd.py`` (Baddoo, Herrmann, McKeon &
Brunton 2023): the DMD regression restricted to a matrix manifold, each
family with a closed form (X1, X2 the snapshot pair matrices):

- 'orthogonal': A = U_p V_p^T from the polar SVD of X2 X1^T (orthogonal
  Procrustes), on the rank-r POD-reduced pair;
- 'symmetric' / 'skewsymmetric': in the left-singular basis of
  X1 = U S V^T with Y = U^T X2 V, A~_ij = (s_j Y_ij +/- s_i Y_ji) /
  (s_j^2 + s_i^2);
- 'diagonal': a_i = <x2_i, x1_i> / ||x1_i||^2 row by row;
- 'circulant': diagonalised by the DFT, one gain a wavenumber
  lam_k = <F_k X1, F_k X2> / ||F_k X1||^2, with the DFT rows as two real
  (n_x, n_x) cos/sin matrices, as the JAX package forms them. Their angles
  are taken from (k j mod n_x), which keeps them exact in float32 where
  2 pi k j / n_x would round at large n_x.

The reduced families use the port's randomized SVD and the host eigensolver
on the r x r core, as ``models.dmd`` does; their lifted modes are formed on
the device in float64. Rollouts are step loops on the device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from corrla_rs_tpu_torch.ops.eig import eig_host
from corrla_rs_tpu_torch.ops.random_svd import random_svd
from corrla_rs_tpu_torch.utils.checkpoint import register_model_class
from corrla_rs_tpu_torch.utils.device import _host_f64 as _host
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["PiDmd"]

_FAMILIES = ("orthogonal", "symmetric", "skewsymmetric", "diagonal",
             "circulant")


def _reduced_kernel(x, n_modes, n_iters, n_os, family, key):
    """POD-projected constrained operator: (u (n_x, r), a_til (r, r) on
    the manifold)."""
    x1, x2 = x[:, :-1], x[:, 1:]
    u, s, vt = random_svd(x1, n_modes, n_iters, n_os, key=key)
    if family == "orthogonal":
        # Procrustes on the reduced pair: the polar part of
        # (U^T X2)(U^T X1)^T
        m = (u.mT @ x2) @ (u.mT @ x1).mT
        uu, _, vv = torch.linalg.svd(m, full_matrices=False)
        return u, uu @ vv
    # X1 = U S V^T exactly on the retained subspace; Y = U^T X2 V
    y = (u.mT @ x2) @ vt.mT
    s2 = torch.clamp_min(s[None, :] ** 2 + s[:, None] ** 2,
                         torch.finfo(s.dtype).tiny)
    if family == "symmetric":
        return u, (s[None, :] * y + s[:, None] * y.mT) / s2
    return u, (s[None, :] * y - s[:, None] * y.mT) / s2


def _diagonal_kernel(x):
    x1, x2 = x[:, :-1], x[:, 1:]
    num = torch.sum(x2 * x1, dim=1)
    den = torch.clamp_min(torch.sum(x1 * x1, dim=1),
                          torch.finfo(x.dtype).tiny)
    return num / den


def _dft_parts(n_x: int, dtype, device):
    """(C, S) with F = C + iS the DFT matrix: cos and -sin of
    2 pi (k j mod n_x) / n_x."""
    k = torch.arange(n_x, device=device)
    kj = (k[:, None] * k[None, :]) % n_x
    ang = (2.0 * math.pi / n_x) * kj.to(torch.float64)
    return torch.cos(ang).to(dtype), (-torch.sin(ang)).to(dtype)


def _circulant_kernel(x):
    """Per-wavenumber complex gain (lam_re, lam_im) of the circulant LS
    fit."""
    c, s = _dft_parts(x.shape[0], x.dtype, x.device)
    x1, x2 = x[:, :-1], x[:, 1:]
    a_re, a_im = c @ x1, s @ x1                  # F X1
    b_re, b_im = c @ x2, s @ x2                  # F X2
    # lam_k = <F_k X1, F_k X2> / ||F_k X1||^2  (conj on X1)
    den = torch.clamp_min(torch.sum(a_re ** 2 + a_im ** 2, dim=1),
                          torch.finfo(x.dtype).tiny)
    num_re = torch.sum(a_re * b_re + a_im * b_im, dim=1)
    num_im = torch.sum(a_re * b_im - a_im * b_re, dim=1)
    return num_re / den, num_im / den


@register_model_class
class PiDmd:
    """Physics-informed DMD: ``PiDmd(x, n_modes, family=...)``.

    x: (n_x, n_t) snapshot columns; family: one of 'orthogonal',
    'symmetric', 'skewsymmetric' (constraining the rank-``n_modes``
    POD-reduced operator), 'diagonal' or 'circulant' (constraining the
    raw-state operator; ``n_modes`` is ignored). ``device`` is where numpy
    input goes.

    After fit: ``lambdas`` (complex host array), on the manifold's spectrum
    locus by construction; ``predict_multiple`` rolls the constrained
    operator. For the reduced families, ``modes_re``/``modes_im`` (n_x, r)
    hold the lifted eigenvectors and ``a_til`` the reduced operator.
    """

    def __init__(self, x_data, n_modes: int = 0,
                 family: str = "orthogonal", n_iters: int = 10, key=0,
                 n_oversamples: int = 8, device=None):
        if family not in _FAMILIES:
            raise ValueError(
                f"family must be one of {_FAMILIES}, got {family!r}"
            )
        x = as_tensor(x_data, device=device)
        if x.ndim != 2 or x.shape[1] < 3:
            raise ValueError(
                f"x_data must be (n_x, n_t >= 3), got {tuple(x.shape)}"
            )
        self.family = family
        self.n_state = int(x.shape[0])
        if family in ("orthogonal", "symmetric", "skewsymmetric"):
            r = int(n_modes)
            if not 1 <= r <= min(self.n_state, int(x.shape[1]) - 1):
                raise ValueError(
                    f"n_modes must be in [1, min(n_x, n_t-1)], got "
                    f"{n_modes}"
                )
            self.n_modes = r
            u, a_til = _reduced_kernel(x, r, int(n_iters),
                                       int(n_oversamples), family, key)
            self.u = u
            self.a_til = a_til
            lam, w = eig_host(_host(a_til))
            self.lambdas = lam
            w = torch.as_tensor(w, device=x.device)
            u64 = u.to(torch.float64)
            self.modes_re = (u64 @ w.real).to(x.dtype)
            self.modes_im = (u64 @ w.imag).to(x.dtype)
        elif family == "diagonal":
            self.n_modes = self.n_state
            self.gains = _diagonal_kernel(x)
            self.lambdas = _host(self.gains).astype(np.complex128)
        else:  # circulant
            self.n_modes = self.n_state
            self.lam_re, self.lam_im = _circulant_kernel(x)
            self.lambdas = _host(self.lam_re) + 1j * _host(self.lam_im)

    def _state(self):
        return self.u if hasattr(self, "u") else (
            self.gains if hasattr(self, "gains") else self.lam_re)

    def predict_multiple(self, x_0, n_steps: int) -> torch.Tensor:
        """(n_x, n_steps) rollout of the constrained operator from x_0
        (n_x,) or (n_x, 1)."""
        like = self._state()
        x0 = as_tensor(x_0, device=like.device, dtype=like.dtype).reshape(-1)
        if x0.shape[0] != self.n_state:
            raise ValueError(
                f"x_0 must have {self.n_state} entries, got "
                f"{tuple(x0.shape)}"
            )
        n = int(n_steps)
        if self.family in ("orthogonal", "symmetric", "skewsymmetric"):
            zs = x0.new_empty((self.a_til.shape[0], n))
            z = self.u.mT @ x0
            for j in range(n):
                z = self.a_til @ z
                zs[:, j] = z
            return self.u @ zs
        if self.family == "diagonal":
            p = self.gains[:, None] ** torch.arange(
                1, n + 1, device=x0.device)[None, :]
            return x0[:, None] * p
        # circulant: powers of the per-wavenumber gains in DFT space
        n_x = self.n_state
        c, s = _dft_parts(n_x, x0.dtype, x0.device)
        z_re, z_im = c @ x0, s @ x0
        lam = _host(self.lam_re) + 1j * _host(self.lam_im)
        pows = lam[:, None] ** np.arange(1, n + 1)[None, :]   # (n_x, n)
        z = (_host(z_re) + 1j * _host(z_im))[:, None] * pows
        # inverse DFT row k -> sum_j exp(+2pi i k j / n) / n
        zr = torch.as_tensor(np.ascontiguousarray(z.real), dtype=x0.dtype,
                             device=x0.device)
        zi = torch.as_tensor(np.ascontiguousarray(z.imag), dtype=x0.dtype,
                             device=x0.device)
        return (c.mT @ zr - (-s).mT @ zi) / n_x
