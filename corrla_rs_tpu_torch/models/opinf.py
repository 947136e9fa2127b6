"""Operator inference (OpInf): non-intrusive projection-based ROMs.

Counterpart of ``corrla_rs_tpu/models/opinf.py`` (Peherstorfer & Willcox
2016): the quadratic ROM

    d/dt xhat = c + A xhat + H kron2(xhat) + B u

on POD coordinates xhat = Vr^T x, learned from snapshots by one regularized
least squares over D = [1, Xhat^T, kron2(Xhat)^T, U^T] with a separate
Tikhonov weight for the quadratic block (McQuarrie, Huang & Willcox 2021).
The POD basis comes from the port's ``random_svd`` (its sketch through
``ops.random_svd._draw_sketch``); the normal equations are formed and solved
on the device. The RK4 rollout of ``simulate_reduced`` is a host loop of
small launches in the r-dimensional space (the JAX package's ``lax.scan``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from corrla_rs_tpu_torch.ops.mat_utils import fd_derivative as _fd_derivative
from corrla_rs_tpu_torch.ops.random_svd import random_svd
from corrla_rs_tpu_torch.utils.checkpoint import register_model_class
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["OpInf", "kron2_compressed"]


@functools.lru_cache(maxsize=32)
def _pair_indices(r: int, device: torch.device):
    """(i, j) index tensors of the pairs i <= j, made once a (r, device):
    a rollout step must not copy them to the device again."""
    ii, jj = np.triu_indices(r)
    return (torch.as_tensor(ii, device=device),
            torch.as_tensor(jj, device=device))


def kron2_compressed(x):
    """Unique-pair quadratic features: for state(s) x (.., r) return
    (.., r(r+1)/2) with entries x_i x_j for i <= j."""
    x = as_tensor(x)
    ii, jj = _pair_indices(int(x.shape[-1]), x.device)
    return x[..., ii] * x[..., jj]


@register_model_class
class OpInf:
    """Quadratic operator-inference ROM.

    n_modes: reduced dimension r; reg_linear / reg_quadratic: Tikhonov
    penalties of the [c, A, B] and the H columns; include_constant /
    include_quadratic: model-form flags; n_iters / n_oversamples: the
    randomized SVD of the basis.

    fit(x, dt, x_dot=None, u=None): snapshots x are (n_t, n_x), rows time
    samples; u (n_t, m) optional inputs. After fit: ``basis_`` (n_x, r),
    operators ``c_``, ``a_``, ``h_`` (r, r(r+1)/2), ``b_``, as tensors on the
    data's device (numpy goes to ``device``, default the default device).
    """

    def __init__(self, n_modes: int, reg_linear: float = 1e-8,
                 reg_quadratic: float = 1e-6, include_constant: bool = True,
                 include_quadratic: bool = True, n_iters: int = 10,
                 n_oversamples: int = 10):
        self.n_modes = int(n_modes)
        self.reg_linear = float(reg_linear)
        self.reg_quadratic = float(reg_quadratic)
        self.include_constant = bool(include_constant)
        self.include_quadratic = bool(include_quadratic)
        self.n_iters = int(n_iters)
        self.n_oversamples = int(n_oversamples)
        self.n_control = 0
        self.basis_ = None
        self.c_ = None
        self.a_ = None
        self.h_ = None
        self.b_ = None
        self.singular_values_ = None

    # -- fitting -----------------------------------------------------
    def fit(self, x, dt: float = 1.0, x_dot=None, u=None, key=0,
            basis=None, device=None):
        x = as_tensor(x, device=device)
        n_t, n_x = x.shape
        r = self.n_modes
        dev, dtype = x.device, x.dtype
        if basis is not None:
            vr = as_tensor(basis, device=dev)
            if tuple(vr.shape) != (n_x, r):
                raise ValueError(f"basis must be ({n_x}, {r}), got "
                                 f"{tuple(vr.shape)}")
            s = None
        else:
            # snapshots are rows -> right singular vectors span state space
            _u, s, vt = random_svd(x, r, self.n_iters, self.n_oversamples,
                                   key=key)
            vr = vt.mT                                # (n_x, r)
        self.basis_ = vr
        self.singular_values_ = s
        xhat = x @ vr                                 # (n_t, r)
        if x_dot is not None:
            xdot_hat = as_tensor(x_dot, device=dev) @ vr
        else:
            xdot_hat = _fd_derivative(xhat, dt)

        blocks = []
        regs = []

        def reg(n, val):
            return torch.full((n,), val, dtype=dtype, device=dev)

        if self.include_constant:
            blocks.append(torch.ones((n_t, 1), dtype=dtype, device=dev))
            regs.append(reg(1, self.reg_linear))
        blocks.append(xhat)
        regs.append(reg(r, self.reg_linear))
        if self.include_quadratic:
            q = kron2_compressed(xhat)
            blocks.append(q)
            regs.append(reg(q.shape[1], self.reg_quadratic))
        if u is not None:
            u = as_tensor(u, device=dev)
            if u.ndim < 2:
                u = u.reshape(1, -1)
            if u.shape[0] != n_t:
                raise ValueError(f"u rows {u.shape[0]} != snapshots {n_t}")
            self.n_control = int(u.shape[1])
            blocks.append(u)
            regs.append(reg(u.shape[1], self.reg_linear))
        else:
            self.n_control = 0
        d = torch.cat(blocks, dim=1)                  # (n_t, p)
        lam = torch.cat(regs)
        # per-column-block ridge: (D^T D + diag(lam^2)) O^T = D^T Xdot
        gram = d.mT @ d + torch.diag(lam ** 2)
        rhs = d.mT @ xdot_hat
        ops = torch.linalg.solve(gram, rhs).mT        # (r, p)

        col = 0
        if self.include_constant:
            self.c_ = ops[:, 0]
            col = 1
        else:
            self.c_ = torch.zeros((r,), dtype=dtype, device=dev)
        self.a_ = ops[:, col: col + r]
        col += r
        if self.include_quadratic:
            nq = r * (r + 1) // 2
            self.h_ = ops[:, col: col + nq]
            col += nq
        else:
            self.h_ = torch.zeros((r, r * (r + 1) // 2), dtype=dtype,
                                  device=dev)
        self.b_ = (ops[:, col:] if self.n_control
                   else torch.zeros((r, 0), dtype=dtype, device=dev))
        return self

    # -- evaluation --------------------------------------------------
    def _rhs_reduced(self, xhat, u=None):
        out = (self.c_ + (self.a_ @ xhat[..., None])[..., 0]
               + (self.h_ @ kron2_compressed(xhat)[..., None])[..., 0])
        if self.n_control and u is not None:
            out = out + (self.b_ @ u[..., None])[..., 0]
        return out

    def _state(self, v):
        return as_tensor(v, device=self.basis_.device,
                         dtype=self.basis_.dtype)

    def reduce(self, x):
        """Project full states (n, n_x) to reduced coordinates (n, r)."""
        return self._state(x) @ self.basis_

    def lift(self, xhat):
        """Reduced coordinates back to the full space."""
        return self._state(xhat) @ self.basis_.mT

    def simulate_reduced(self, xhat0, n_steps: int, dt: float, u=None):
        """RK4 rollout in the reduced space: (n_steps + 1, r)."""
        if self.basis_ is None:
            raise ValueError("fit() first")
        xhat0 = self._state(xhat0)
        n_steps = int(n_steps)
        us = None
        if self.n_control:
            if u is None:
                raise ValueError("model was fit with control; pass u")
            us = self._state(u)[:n_steps]
            if us.shape[0] < n_steps:
                raise ValueError(f"need u for {n_steps} steps")
        traj = torch.empty((n_steps + 1,) + tuple(xhat0.shape),
                           dtype=xhat0.dtype, device=xhat0.device)
        traj[0] = xhat0
        xk = xhat0
        for k in range(n_steps):
            uc = us[k] if us is not None else None
            k1 = self._rhs_reduced(xk, uc)
            k2 = self._rhs_reduced(xk + 0.5 * dt * k1, uc)
            k3 = self._rhs_reduced(xk + 0.5 * dt * k2, uc)
            k4 = self._rhs_reduced(xk + dt * k3, uc)
            xk = xk + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            traj[k + 1] = xk
        return traj

    def predict(self, x0, n_steps: int, dt: float, u=None):
        """Full-space forecast from a full initial state: project, integrate
        the learned ROM, lift. (n_steps + 1, n_x)."""
        xhat0 = self.basis_.mT @ self._state(x0)
        traj = self.simulate_reduced(xhat0, n_steps, dt, u=u)
        return self.lift(traj)
