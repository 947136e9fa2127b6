"""SINDy: sparse identification of nonlinear dynamics.

Counterpart of ``corrla_rs_tpu/models/sindy.py`` (Brunton, Proctor & Kutz
2016; SINDYc with a control input; the weak form of Messenger & Bortz 2021):
the state derivative is regressed onto a library of candidate features
Theta(x) and the coefficients are sparsified by sequentially thresholded
least squares (STLSQ).

- The feature library is one batched power-product over all monomial
  exponent tuples, ``prod(x[:, None, :] ** E[None])``, on the device.
- STLSQ runs a fixed number of sweeps with no early exit, as the JAX
  package's ``fori_loop`` does; each sweep solves all d_out targets as one
  batched ``torch.linalg.solve`` of shape (d_out, f, f), with the inactive
  rows and columns replaced by the identity (A = M G M + (I - M), b' = M b):
  exact zeros for pruned features, static shapes, nothing read back.
- ``simulate`` integrates the identified ODE with fixed-step RK4 (or
  iterates the map) in a host loop of small launches.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from corrla_rs_tpu_torch.ops.mat_utils import fd_derivative as _fd_derivative
from corrla_rs_tpu_torch.utils.checkpoint import register_model_class
from corrla_rs_tpu_torch.utils.device import _host_f64, as_tensor

__all__ = ["Sindy", "polynomial_exponents", "evaluate_library"]


def polynomial_exponents(n_dim: int, degree: int,
                         include_bias: bool = True) -> np.ndarray:
    """All monomial exponent tuples over ``n_dim`` variables up to
    ``degree``, graded-lexicographic. Returns an int array (n_feat, n_dim);
    row 0 is the bias (all zeros) when ``include_bias``.
    """
    rows = []
    lo = 0 if include_bias else 1
    for deg in range(lo, degree + 1):
        # multisets of size deg over n_dim variables
        for combo in itertools.combinations_with_replacement(
                range(n_dim), deg):
            e = np.zeros(n_dim, dtype=np.int32)
            for i in combo:
                e[i] += 1
            rows.append(e)
    if not rows:
        raise ValueError("empty feature library (degree < 1 and no bias)")
    return np.stack(rows)


def evaluate_library(x, exponents, trig_freqs: int = 0):
    """Theta(x): monomial features (+ optional sin/cos harmonics).

    x (n, d) -> (n, n_feat [+ 2*trig_freqs*d]). One batched power-product;
    x**0 is 1 exactly, and its gradient is 0 even at x = 0 (the input is
    guarded as well as the output).
    """
    x = as_tensor(x)
    e = as_tensor(exponents, device=x.device, dtype=x.dtype)   # (f, d)
    xb = x[:, None, :]                                          # (n, 1, d)
    zero = e[None] == 0
    xb_safe = torch.where(zero, torch.ones_like(xb), xb)
    pw = torch.where(zero, torch.ones_like(xb_safe), xb_safe ** e[None])
    theta = torch.prod(pw, dim=-1)                              # (n, f)
    if trig_freqs:
        ks = torch.arange(1, trig_freqs + 1, dtype=x.dtype, device=x.device)
        ang = x[:, None, :] * ks[None, :, None]                 # (n, K, d)
        ang = ang.reshape(x.shape[0], -1)
        theta = torch.cat([theta, torch.sin(ang), torch.cos(ang)], dim=1)
    return theta


def _stlsq(theta, y, threshold, ridge, n_sweeps):
    """Sequentially thresholded least squares with per-target masks.

    theta (n, f), y (n, d_out) -> (w (f, d_out), mask (f, d_out) bool), in
    normal-equation form: G = Theta^T Theta is (f, f) whatever n.
    """
    f = theta.shape[1]
    g = theta.mT @ theta                    # (f, f)
    b = theta.mT @ y                        # (f, d_out)
    eye = torch.eye(f, dtype=theta.dtype, device=theta.device)

    def solve_masked(mask):
        m = mask.mT.to(theta.dtype)         # (d_out, f)
        # inactive rows/cols replaced by identity => exact 0 coefficients
        a = (m[:, :, None] * g[None] * m[:, None, :]
             + (1.0 - m)[:, :, None] * eye[None]
             + ridge * torch.diag_embed(m))
        return torch.linalg.solve(a, (m * b.mT)[..., None])[..., 0].mT

    mask = torch.ones(b.shape, dtype=torch.bool, device=b.device)
    for _ in range(int(n_sweeps)):
        mask = solve_masked(mask).abs() >= threshold
    w = solve_masked(mask)
    # final consistency: features the last solve pushed under threshold
    # are reported inactive and zeroed
    mask = w.abs() >= threshold
    return torch.where(mask, w, torch.zeros_like(w)), mask


def weak_test_functions(n_samples: int, n_windows: int,
                        window_frac: float = 0.2, poly_order: int = 4):
    """Compactly supported polynomial bump test functions for weak-form
    identification: phi(t) = ((t-a)(b-t))^p on K windows, zero at the
    ends. Returns (phi (K, n), dphi (K, n)) as float64 host arrays sampled
    on the trajectory grid (dphi in index units; multiply by 1/dt
    outside)."""
    n = int(n_samples)
    k = int(n_windows)
    w = max(int(window_frac * n), 2 * poly_order + 2)
    w = min(w, n - 1)
    if k > 1 and n - w - 1 < 1:
        raise ValueError(
            f"trajectory too short for weak-form windows: n={n} allows "
            f"only one distinct window of width {w} (the weak system "
            "would be rank-1); add samples or shrink window_frac/"
            "poly_order")
    starts = np.linspace(0, n - w - 1, k).astype(int)
    t = np.arange(n, dtype=np.float64)
    phi = np.zeros((k, n))
    dphi = np.zeros((k, n))
    p = poly_order
    for i, a in enumerate(starts):
        b = a + w
        mask = (t >= a) & (t <= b)
        u = t[mask]
        base = (u - a) * (b - u)
        phi[i, mask] = base ** p
        dphi[i, mask] = p * base ** (p - 1) * ((b - u) - (u - a))
        # normalize each row for balanced rows in the weak system
        scale = np.linalg.norm(phi[i])
        phi[i] /= scale
        dphi[i] /= scale
    return phi, dphi


def _monomial_name(e, names):
    parts = []
    for i, p in enumerate(e):
        if p == 1:
            parts.append(names[i])
        elif p > 1:
            parts.append(f"{names[i]}^{int(p)}")
    return " ".join(parts) if parts else "1"


def _rows(v, device=None, dtype=None):
    """``jnp.atleast_2d`` of a tensor: a 1-D input becomes one row."""
    v = as_tensor(v, device=device, dtype=dtype)
    return v.reshape(1, -1) if v.ndim < 2 else v


@register_model_class
class Sindy:
    """Sparse nonlinear system identification (SINDy / SINDYc).

    degree: polynomial library degree; threshold: the STLSQ threshold;
    ridge: Tikhonov weight on the active block; n_sweeps: the fixed number
    of sweeps; trig_freqs adds sin(k x_i), cos(k x_i); discrete fits the map
    x_{k+1} = Theta(x_k) W instead of the ODE.

    After ``fit``: ``coefficients_`` (n_feat, d) and ``mask_`` tensors,
    ``feature_names_``, plus ``equations()`` / ``predict`` / ``simulate``.
    """

    def __init__(self, degree: int = 3, threshold: float = 0.1,
                 ridge: float = 1e-6, n_sweeps: int = 10,
                 include_bias: bool = True, trig_freqs: int = 0,
                 discrete: bool = False):
        self.degree = int(degree)
        self.threshold = float(threshold)
        self.ridge = float(ridge)
        self.n_sweeps = int(n_sweeps)
        self.include_bias = bool(include_bias)
        self.trig_freqs = int(trig_freqs)
        self.discrete = bool(discrete)
        self.n_dim = None
        self.n_control = 0
        self.coefficients_ = None
        self.mask_ = None
        self.feature_names_ = None
        self._exponents = None

    # -- fitting -----------------------------------------------------
    def fit(self, x, x_dot=None, u=None, dt: float = 1.0,
            weak: bool = False, n_windows: int = 100,
            window_frac: float = 0.2, device=None):
        """Identify dynamics from a trajectory x (n, d) sampled every
        ``dt``; x_dot optional derivatives (continuous time), else
        finite-differenced; u (n, m) optional controls (SINDYc). weak=True
        integrates against compactly supported test functions instead of
        differentiating the data (continuous time only). ``device`` is
        where numpy input goes."""
        if weak:
            if self.discrete:
                raise ValueError("weak=True is continuous-time only")
            if x_dot is not None:
                raise ValueError("weak=True derives its own targets; "
                                 "x_dot is meaningless")
            return self._fit_weak(x, u, dt, n_windows, window_frac, device)
        x = _rows(x, device=device)
        dev = x.device
        n, d = x.shape
        self.n_dim = d
        if self.discrete:
            if x_dot is not None:
                raise ValueError("x_dot is meaningless for discrete=True")
            y = x[1:]
            z = x[:-1]
            u_lib = None if u is None else as_tensor(u, device=dev)[: n - 1]
        else:
            y = (as_tensor(x_dot, device=dev) if x_dot is not None
                 else _fd_derivative(x, dt))
            z = x
            u_lib = None if u is None else as_tensor(u, device=dev)
        if u_lib is not None:
            u_lib = _rows(u_lib)
            if u_lib.shape[0] != z.shape[0]:
                raise ValueError(
                    f"u rows {u_lib.shape[0]} != state rows {z.shape[0]}")
            self.n_control = int(u_lib.shape[1])
            z = torch.cat([z, u_lib.to(z.dtype)], dim=1)
        else:
            self.n_control = 0

        expts = polynomial_exponents(
            d + self.n_control, self.degree, self.include_bias)
        self._exponents = torch.as_tensor(expts, device=dev)
        theta = evaluate_library(z, self._exponents, self.trig_freqs)
        w, mask = _stlsq(theta, y, self.threshold, self.ridge,
                         self.n_sweeps)
        self.coefficients_ = w
        self.mask_ = mask
        self.feature_names_ = self._make_names(expts, d)
        return self

    def _fit_weak(self, x, u, dt, n_windows, window_frac, device=None):
        x = _rows(x, device=device)
        dev = x.device
        n, d = x.shape
        self.n_dim = d
        z = x
        if u is not None:
            u_lib = _rows(u, device=dev)
            if u_lib.shape[0] != n:
                raise ValueError(
                    f"u rows {u_lib.shape[0]} != state rows {n}")
            self.n_control = int(u_lib.shape[1])
            z = torch.cat([x, u_lib.to(x.dtype)], dim=1)
        else:
            self.n_control = 0
        expts = polynomial_exponents(
            d + self.n_control, self.degree, self.include_bias)
        self._exponents = torch.as_tensor(expts, device=dev)
        theta = evaluate_library(z, self._exponents, self.trig_freqs)
        phi, dphi = weak_test_functions(n, n_windows, window_frac)
        phi = torch.as_tensor(phi, dtype=theta.dtype, device=dev)
        dphi = torch.as_tensor(dphi, dtype=theta.dtype, device=dev)
        # weak system: (phi Theta) W dt = -(dphi/dt) x dt = -dphi x
        g = (phi @ theta) * dt                     # (K, f)
        b = -(dphi @ x)                            # (K, d)
        w, mask = _stlsq(g, b, self.threshold, self.ridge, self.n_sweeps)
        self.coefficients_ = w
        self.mask_ = mask
        self.feature_names_ = self._make_names(expts, d)
        return self

    def _make_names(self, expts, d):
        names = [f"x{i}" for i in range(d)] + [
            f"u{j}" for j in range(self.n_control)]
        out = [_monomial_name(e, names) for e in expts]
        # evaluate_library emits all sin blocks (k-major, dim-minor), then
        # all cos blocks: the names follow that column order
        ks = range(1, self.trig_freqs + 1)
        out += [f"sin({k} {nm})" for k in ks for nm in names]
        out += [f"cos({k} {nm})" for k in ks for nm in names]
        return out

    # -- evaluation --------------------------------------------------
    def _rhs(self, x, u=None):
        z = x if u is None else torch.cat([x, u.to(x.dtype)], dim=-1)
        zz = z.reshape(1, -1) if z.ndim == 1 else z
        th = evaluate_library(zz, self._exponents, self.trig_freqs)
        out = th @ self.coefficients_
        return out[0] if z.ndim == 1 else out

    def _state(self, v):
        return as_tensor(v, device=self.coefficients_.device,
                         dtype=self.coefficients_.dtype)

    def predict(self, x, u=None):
        """x_dot (continuous) or x_next (discrete) at the given states."""
        if self.coefficients_ is None:
            raise ValueError("fit() first")
        if self.n_control and u is None:
            raise ValueError("model was fit with control; pass u")
        return self._rhs(self._state(x),
                         None if u is None else self._state(u))

    def simulate(self, x0, n_steps: int, dt: float = 1.0, u=None):
        """Roll the identified model forward: (n_steps + 1, d) trajectory
        including x0. Continuous models use fixed-step RK4; discrete models
        iterate the map. ``u`` (n_steps, m) is held constant over each
        step."""
        if self.coefficients_ is None:
            raise ValueError("fit() first")
        x0 = self._state(x0)
        n_steps = int(n_steps)
        us = None
        if self.n_control:
            if u is None:
                raise ValueError("model was fit with control; pass u")
            u = self._state(u)
            if u.shape[0] < n_steps:
                raise ValueError(f"need u for {n_steps} steps, got "
                                 f"{u.shape[0]}")
            us = u[:n_steps]

        traj = torch.empty((n_steps + 1,) + tuple(x0.shape),
                           dtype=x0.dtype, device=x0.device)
        traj[0] = x0
        xk = x0
        for k in range(n_steps):
            uc = us[k] if us is not None else None
            if self.discrete:
                xk = self._rhs(xk, uc)
            else:
                k1 = self._rhs(xk, uc)
                k2 = self._rhs(xk + 0.5 * dt * k1, uc)
                k3 = self._rhs(xk + 0.5 * dt * k2, uc)
                k4 = self._rhs(xk + dt * k3, uc)
                xk = xk + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            traj[k + 1] = xk
        return traj

    def score(self, x, x_dot=None, u=None, dt: float = 1.0):
        """R^2 of the derivative (or next-state) regression on held data."""
        x = _rows(self._state(x))
        if self.discrete:
            y = x[1:]
            pred = self.predict(
                x[:-1], None if u is None else self._state(u)[:-1])
        else:
            y = (self._state(x_dot) if x_dot is not None
                 else _fd_derivative(x, dt))
            pred = self.predict(x, u)
        ss_res = torch.sum((y - pred) ** 2)
        ss_tot = torch.sum((y - torch.mean(y, dim=0)) ** 2)
        return float(1.0 - ss_res / ss_tot)

    def equations(self, precision: int = 3):
        """Human-readable identified equations, one string per state dim."""
        if self.coefficients_ is None:
            raise ValueError("fit() first")
        w = _host_f64(self.coefficients_)
        lhs = ("x{i}[k+1]" if self.discrete else "d x{i}/dt")
        eqs = []
        for i in range(w.shape[1]):
            terms = [
                f"{w[j, i]:+.{precision}g} {self.feature_names_[j]}"
                for j in range(w.shape[0]) if w[j, i] != 0.0
            ]
            rhs = " ".join(terms) if terms else "0"
            eqs.append(f"{lhs.format(i=i)} = {rhs}")
        return eqs
