"""Steady-state Kalman filtering for identified LTI models.

Counterpart of ``corrla_rs_tpu/ops/kalman.py`` (no reference analogue). It
closes the loop on the system-identification chain: a realization
(A, B, C, D) predicts from a KNOWN state, but operating data only gives
inputs and outputs. The Kalman filter supplies the state estimate, the
innovations sequence (the model-validation residual: white iff the model
and the noise covariances are right), and the innovations log-likelihood
(the evidence for comparing identified orders and noise levels).

The steady-state filter covariance solves the DARE by a fixed-iteration
Riccati recursion (convergence is linear with ratio |lambda_max(A-KCA)|^2,
so about 200 iterations is far past f64 for any reasonably damped system),
and the filter itself is one loop over the record whose per-step work is
three small matrix-vector products; the feedthrough D u and the input B u
of the whole record are formed once. Nothing in either loop reads the
device. There is no randomness here.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["dare", "kalman_filter", "kalman_smooth", "dlqr"]


def _mat(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` as a tensor, beside ``like`` (its device and dtype) if given."""
    if like is None:
        return as_tensor(x)
    return as_tensor(x, device=like.device, dtype=like.dtype)


def _ndim(x) -> int:
    return x.ndim if isinstance(x, torch.Tensor) else np.ndim(x)


def _cov(x, n: int, like: torch.Tensor) -> torch.Tensor:
    """A covariance given as a scalar (sigma^2 I) or a matrix."""
    if _ndim(x) == 0:
        return float(x) * torch.eye(n, dtype=like.dtype, device=like.device)
    return torch.atleast_2d(_mat(x, like))


def _dare_iterate(a, c, q, r, n_iters):
    p = q + torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    for _ in range(n_iters):
        cp = c @ p                                  # (q, n)
        s = cp @ c.mT + r                           # innovation covariance
        k = torch.linalg.solve(s, cp).mT            # P C^T S^{-1}  (n, q)
        p_new = a @ (p - k @ cp) @ a.mT + q         # both updates
        p = 0.5 * (p_new + p_new.mT)
    return p


def dare(a, c, q, r, n_iters: int = 200):
    """Steady-state PREDICTED-state error covariance P of the Kalman filter
    for x' = A x + w (cov Q), y = C x + v (cov R): the stabilizing solution
    of the filter DARE

      P = A (P - P C^T (C P C^T + R)^{-1} C P) A^T + Q

    by fixed-iteration Riccati recursion (it matches
    ``scipy.linalg.solve_discrete_are(a.T, c.T, q, r)``)."""
    a = _mat(a)
    c = torch.atleast_2d(_mat(c, a))
    q = _mat(q, a)
    r = torch.atleast_2d(_mat(r, a))
    n = a.shape[0]
    if a.shape != (n, n) or q.shape != (n, n) or c.shape[1] != n \
            or r.shape != (c.shape[0], c.shape[0]):
        raise ValueError(
            f"shape mismatch: a {tuple(a.shape)}, c {tuple(c.shape)}, "
            f"q {tuple(q.shape)}, r {tuple(r.shape)}"
        )
    return _dare_iterate(a, c, q, r, int(n_iters))


def dlqr(a, b, q, r, n_iters: int = 200):
    """Discrete-time infinite-horizon LQR for x' = A x + B u with cost
    sum x^T Q x + u^T R u: returns (k_gain, p) with u = -K x and P the
    stabilizing solution of the CONTROL DARE

      P = A^T (P - P B (B^T P B + R)^{-1} B^T P) A + Q.

    By filter/control duality this is :func:`dare` on the transposed system
    (A -> A^T, C -> B^T), so the same Riccati recursion serves both;
    K = (B^T P B + R)^{-1} B^T P A. It closes the identification chain:
    identify -> estimate (``kalman_filter``) -> control.
    """
    a = _mat(a)
    n = int(a.shape[0])
    b = _mat(b, a)
    if b.ndim == 1:
        b = b[:, None]
    # validate with CONTROL-side names (errors surfacing from dare() would
    # talk about 'c' on the transposed system) and broadcast scalar costs
    # as kalman_filter broadcasts scalar covariances
    if b.shape[0] != n:
        raise ValueError(f"b must be ({n}, n_u), got {tuple(b.shape)}")
    n_u = int(b.shape[1])
    q_mat, r_mat = _cov(q, n, a), _cov(r, n_u, a)
    if q_mat.shape != (n, n) or r_mat.shape != (n_u, n_u):
        raise ValueError(
            f"q must be ({n}, {n}) and r ({n_u}, {n_u}), got "
            f"{tuple(q_mat.shape)} / {tuple(r_mat.shape)}"
        )
    p = dare(a.mT, b.mT, q_mat, r_mat, n_iters=n_iters)
    btp = b.mT @ p
    return torch.linalg.solve(btp @ b + r_mat, btp @ a), p


def _kf_loop(a, c, k, x0, bu, du, y):
    """Predictor-form steady-state filter: carries the PREDICTED state
    x_t|t-1; per step e_t = y_t - C x - D u_t, the filtered state
    x_t|t = x + K e_t, the next prediction x' = A x_t|t + B u_t. Columns
    of ``bu``, ``du`` and ``y`` are the record's steps."""
    t_len = y.shape[1]
    xs = x0.new_empty((t_len, x0.shape[0]))
    es = x0.new_empty((t_len, y.shape[0]))
    resid = (y - du).mT.contiguous()
    bu = bu.mT.contiguous()
    xh = x0
    for t in range(t_len):
        es[t] = resid[t] - c @ xh
        xs[t] = xh + k @ es[t]
        xh = a @ xs[t] + bu[t]
    return xs.mT, es.mT


def kalman_filter(a, b, c, d, q, r, u_seq, y_seq, x0=None,
                  n_dare_iters: int = 200, _with_mats: bool = False):
    """Steady-state Kalman filter over an input-output record.

    a/b/c/d: the realization (pass ``d=None`` for no feedthrough); q/r:
    process / measurement noise covariances (scalars broadcast to
    sigma^2 I); u_seq (n_u, T), y_seq (n_y, T); x0: initial predicted state
    (default 0).

    Returns a dict: ``x_filt`` (n, T) filtered states, ``innovations``
    (n_y, T), ``gain`` (n, n_y) the steady-state Kalman gain,
    ``innovation_cov`` (n_y, n_y) = C P C^T + R, ``state_cov`` P, and
    ``loglik``, the Gaussian innovations log-likelihood (the model-evidence
    number for comparing identified models and noise levels).
    """
    a = _mat(a)
    n = int(a.shape[0])
    b = _mat(b, a)
    if b.ndim == 1:
        b = b[:, None]
    if b.shape[0] != n:
        # explicit check: a silent reshape would row-major SCRAMBLE a
        # transposed B into a wrong-but-plausible model
        raise ValueError(f"b must be ({n}, n_u), got {tuple(b.shape)}")
    c = torch.atleast_2d(_mat(c, a))
    p_out = int(c.shape[0])
    if d is None:
        d_mat = a.new_zeros((p_out, b.shape[1]))
    else:
        d_mat = torch.atleast_2d(_mat(d, a))
        if d_mat.shape != (p_out, int(b.shape[1])):
            raise ValueError(
                f"d must be ({p_out}, {int(b.shape[1])}), got "
                f"{tuple(d_mat.shape)}"
            )
    q_mat, r_mat = _cov(q, n, a), _cov(r, p_out, a)
    u, y = _mat(u_seq, a), _mat(y_seq, a)
    if u.ndim == 1:
        u = u[None, :]
    if y.ndim == 1:
        y = y[None, :]
    if u.shape[0] != b.shape[1] or y.shape[0] != p_out \
            or u.shape[1] != y.shape[1]:
        raise ValueError(
            f"u_seq/y_seq must be ({b.shape[1]}, T)/({p_out}, T), got "
            f"{tuple(u.shape)} / {tuple(y.shape)}"
        )
    x0 = a.new_zeros((n,)) if x0 is None else _mat(x0, a).reshape(n)

    p = dare(a, c, q_mat, r_mat, n_iters=n_dare_iters)
    s = c @ p @ c.mT + r_mat
    k = torch.linalg.solve(s, c @ p).mT            # P C^T S^{-1}
    x_filt, innov = _kf_loop(a, c, k, x0, b @ u, d_mat @ u, y)
    # Gaussian innovations log-likelihood with the constant steady-state S
    t_len = int(u.shape[1])
    logdet = torch.linalg.slogdet(s).logabsdet
    quad = torch.sum(innov * torch.linalg.solve(s, innov))
    loglik = -0.5 * (t_len * (p_out * math.log(2 * math.pi) + logdet) + quad)
    out = {"x_filt": x_filt, "innovations": innov, "gain": k,
           "innovation_cov": s, "loglik": float(loglik), "state_cov": p}
    if _with_mats:   # internal: the RTS smoother reuses these
        return out, (a, b, c, p, k, u)
    return out


def _rts_loop(a, b, g, x_filt, u):
    """Backward Rauch-Tung-Striebel pass with the steady-state smoother
    gain G = P_f A^T P^{-1}: x_s[t] = x_f[t] + G (x_s[t+1] - x_p[t+1]),
    x_p[t+1] = A x_f[t] + B u[t]."""
    xf = x_filt.mT.contiguous()                     # (T, n)
    xp_next = (a @ x_filt + b @ u).mT.contiguous()  # row t: x_p[t+1]
    xs = torch.empty_like(xf)
    xs[-1] = xf[-1]
    for t in range(xf.shape[0] - 2, -1, -1):
        xs[t] = xf[t] + g @ (xs[t + 1] - xp_next[t])
    return xs.mT


def kalman_smooth(a, b, c, d, q, r, u_seq, y_seq, x0=None,
                  n_dare_iters: int = 200):
    """Fixed-interval RTS smoother on top of :func:`kalman_filter`
    (steady-state gains). Returns the filter's dict plus ``x_smooth``
    (n, T): each state estimated from the WHOLE record, so the smoothed
    error is never worse than the filtered one."""
    out, (a_m, b_m, c_m, p, k, u) = kalman_filter(
        a, b, c, d, q, r, u_seq, y_seq, x0=x0,
        n_dare_iters=n_dare_iters, _with_mats=True,
    )
    # filtered covariance P_f = (I - K C) P; smoother gain P_f A^T P^-1
    p_f = p - k @ (c_m @ p)
    g = torch.linalg.solve(p.mT, a_m @ p_f.mT).mT   # P_f A^T P^{-1}
    out["x_smooth"] = _rts_loop(a_m, b_m, g, out["x_filt"], u)
    return out
