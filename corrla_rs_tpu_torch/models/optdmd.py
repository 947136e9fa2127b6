"""Optimized DMD (variable projection) and BOP-DMD.

Counterpart of ``corrla_rs_tpu/models/optdmd.py`` (Askham & Kutz 2018;
Sashidhar & Kutz 2022): the continuous-time spectral model
``x(t) ~= Re(Phi diag(b) exp(alpha t))`` fitted by nonlinear least squares
over the continuous eigenvalues alpha, the linear parameters eliminated by
variable projection; BOP-DMD bags it over random time subsets.

The large-dimension work is the rank-r POD projection (the port's
``random_svd`` of the (n_x, m) snapshots, its sketch through
``ops.random_svd._draw_sketch``, and one (r, n_x) x (n_x, m) product on the
device) and the mode lift on the device in ``predict``. The variable-
projection Levenberg-Marquardt runs in complex128 numpy on the projected
(m, r) system, copied from the JAX package, which keeps it on the host too;
so do the warm starts and the members' eigenvalue alignment (scipy's
``linear_sum_assignment``). BOP-DMD's member subsets come from numpy's
generator seeded by ``ops.design._seed_from_key(key)``, the JAX package's
own rule, so an int key gives the same subsets in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from corrla_rs_tpu_torch.ops.random_svd import random_svd
from corrla_rs_tpu_torch.utils.checkpoint import register_model_class
from corrla_rs_tpu_torch.utils.device import _host_f64, as_tensor

__all__ = ["OptDmd", "BopDmd", "bop_dmd"]

# exp(alpha t) overflows f64 near 709; reject such steps instead of letting
# inf/nan poison the LM linear algebra
_EXP_CLIP = 700.0


def _exp_mat(alpha, t):
    """A(alpha)[k, j] = exp(alpha_j t_k), (m, r) complex; None when the
    exponent overflows (the caller treats it as an infeasible LM step)."""
    z = np.multiply.outer(t, alpha)            # (m, r)
    if np.max(z.real) > _EXP_CLIP:
        return None
    return np.exp(z)


def _residual(alpha, t, y):
    """Variable projection residual pieces at alpha: (rss, a, b, res) with
    b = A^+ y and res = y - A b, or (inf, None, None, None) when A
    overflows or fails."""
    a = _exp_mat(alpha, t)
    if a is None:
        return np.inf, None, None, None
    b, *_ = np.linalg.lstsq(a, y, rcond=None)
    res = y - a @ b
    rss = float(np.sum(np.abs(res) ** 2))
    if not np.isfinite(rss):
        return np.inf, None, None, None
    return rss, a, b, res


def _varpro_lm(alpha0, t, y, maxiter=60, tol=1e-9, lm0=1.0):
    """Complex Levenberg-Marquardt on the varpro objective
    ``min_alpha || y - A(alpha) A(alpha)^+ y ||_F^2`` with Kaufman's
    Jacobian, column j: ``J_j = -P_perp(A) (t * A[:, j]) b[j, :]``
    (Askham & Kutz 2018 eq. 3.3-3.5)."""
    alpha = np.asarray(alpha0, np.complex128).copy()
    rss, a, b, res = _residual(alpha, t, y)
    if not np.isfinite(rss):
        raise ValueError(
            "optdmd: initial alpha overflows exp(alpha t); rescale t or "
            "pass a finite alpha0"
        )
    lm = float(lm0)
    for _ in range(int(maxiter)):
        # qr of A for the projector P_perp v = v - Q (Q^H v)
        q, _ = np.linalg.qr(a, mode="reduced")
        da = t[:, None] * a                      # (m, r): d A[:,j]/d a_j
        da_perp = da - q @ (q.conj().T @ da)
        # J^H J[i, j] = (da_perp_i^H da_perp_j) (b_i b_j^H)
        g = da_perp.conj().T @ da_perp           # (r, r)
        bbh = b @ b.conj().T                     # (r, r)
        jhj = g * bbh.conj()
        # jhr_i = J_i^H vec(res) = -da_perp_i^H (res b_i^H)
        jhr = -np.sum(np.conj(da_perp) * (res @ b.conj().T), axis=0)
        diag = np.maximum(np.abs(np.diag(jhj)), 1e-30)
        step_ok = False
        for _ in range(30):
            try:
                d = np.linalg.solve(jhj + lm * np.diag(diag), -jhr)
            except np.linalg.LinAlgError:
                lm *= 10.0
                continue
            rss_new, a_new, b_new, res_new = _residual(alpha + d, t, y)
            if rss_new < rss:
                step_ok = True
                break
            lm *= 10.0
        if not step_ok:
            break
        improve = (rss - rss_new) / max(rss, 1e-300)
        alpha = alpha + d
        rss, a, b, res = rss_new, a_new, b_new, res_new
        lm = max(lm / 10.0, 1e-12)
        if improve < tol:
            break
    return alpha, b, rss


def _project(x, n_modes, n_iters, n_os, key):
    """Device stage: rank-r POD basis + projected snapshots, tensors
    (u (n_x, r), xp (r, m))."""
    u, _, _ = random_svd(x, n_modes, n_iters, n_os, key=key)
    return u, u.mT @ x


def _alpha_init(xp, t):
    """Exact-DMD warm start in the projected space: eig of
    X2p pinv(X1p), alpha = log(lambda) / median spacing. Host (r, m)."""
    dt = float(np.median(np.diff(t)))
    x1, x2 = xp[:, :-1], xp[:, 1:]
    a_op = x2 @ np.linalg.pinv(x1)
    lam = np.linalg.eigvals(a_op)
    lam = np.where(np.abs(lam) < 1e-12, 1e-12, lam)
    return np.log(lam.astype(np.complex128)) / dt


def _alpha_init_hankel(x, t, r):
    """Warm start when the observable is rank-deficient (n_x < r): rank-r
    exact DMD on a time-delay embedding deep enough to expose r dynamic
    modes. Host numpy; the embedding is (n_x d, m - d + 1)."""
    n_x, m = x.shape
    d = int(np.ceil(r / n_x)) + 1
    if m - d < r + 1:
        raise ValueError(
            f"n_modes={r} exponentials need m >= {r + d + 1} snapshots "
            f"of a {n_x}-channel series for the delay-embedded warm "
            f"start, got m={m}"
        )
    cols = m - d + 1
    h = np.stack([x[:, j:j + cols] for j in range(d)]).reshape(
        d * n_x, cols
    )
    h1, h2 = h[:, :-1], h[:, 1:]
    u, s, vt = np.linalg.svd(h1, full_matrices=False)
    u, s, vt = u[:, :r], s[:r], vt[:r]
    a_til = u.T @ h2 @ vt.T / s[None, :]
    lam = np.linalg.eigvals(a_til)
    lam = np.where(np.abs(lam) < 1e-12, 1e-12, lam)
    dt = float(np.median(np.diff(t)))
    return np.log(lam.astype(np.complex128)) / dt


def _unit_modes(u_np, b):
    """U B^T = Phi diag(amp): unit-norm complex modes and their positive
    amplitudes, host arrays."""
    phi = u_np @ b.T                            # (n_x, r) complex
    amp = np.linalg.norm(phi, axis=0)
    return phi / np.where(amp > 0, amp, 1.0)[None, :], amp


def _mode_parts(phi, dtype, device):
    """(re, im) tensors of host complex modes."""
    return (torch.as_tensor(np.ascontiguousarray(phi.real), dtype=dtype,
                            device=device),
            torch.as_tensor(np.ascontiguousarray(phi.imag), dtype=dtype,
                            device=device))


def _snapshots(x_data, device, min_cols):
    x = as_tensor(x_data, device=device)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2 or x.shape[1] < min_cols:
        raise ValueError(
            f"x_data must be (n_x, m >= {min_cols}), got {tuple(x.shape)}"
        )
    return x


def _times(t, m, dt):
    if t is None:
        t = np.arange(m, dtype=np.float64) * float(dt)
    t = np.asarray(t, np.float64).reshape(-1)
    if t.size != m:
        raise ValueError(f"t must have m={m} entries, got {t.size}")
    if np.any(np.diff(t) <= 0):
        raise ValueError("t must be strictly increasing")
    return t


@register_model_class
class OptDmd:
    """Optimized (variable-projection) DMD fit of
    ``x(t) ~= Re(Phi diag(amplitudes) exp(alphas t))``.

    x_data: (n_x, m) snapshot columns, or (m,) for one channel; t: (m,)
    sample times (default ``arange(m) * dt``; any strictly increasing
    spacing); n_modes: model rank r (may exceed the channel count: the warm
    start then comes from a delay-embedded exact DMD); alpha0: optional (r,)
    complex warm start; maxiter/tol: LM budget; n_iters/n_oversamples/key:
    the RSVD projection. ``device`` is where numpy input goes.

    Attributes: ``alphas`` (r,) complex host array, ``modes_re``/
    ``modes_im`` (n_x, r) unit-norm tensors, ``amplitudes`` (r,) host
    array, ``rss``. ``predict(times)`` evaluates the model at any times.
    """

    def __init__(self, x_data, n_modes: int, t=None, dt: float = 1.0,
                 alpha0=None, maxiter: int = 60, tol: float = 1e-9,
                 n_iters: int = 10, key=0, n_oversamples: int = 8,
                 device=None):
        x = _snapshots(x_data, device, 3)
        n_x, m = int(x.shape[0]), int(x.shape[1])
        r = int(n_modes)
        if not 1 <= r <= m - 1:
            raise ValueError(
                f"n_modes must be in [1, m-1] = [1, {m - 1}], "
                f"got {n_modes}"
            )
        t = _times(t, m, dt)
        if n_x >= r:
            # rank-r POD projection (the large-n_x work, on the device);
            # varpro runs on the (m, r) projected target
            u, xp = _project(x, r, int(n_iters), int(n_oversamples), key)
            y = _host_f64(xp).T
            u_np = _host_f64(u)
        else:
            # rank-deficient observables (n_x < r): fit the raw channels;
            # _alpha_init_hankel supplies the warm start
            u_np = None
            y = _host_f64(x).T
        if alpha0 is None:
            alpha0 = (_alpha_init(y.T, t) if u_np is not None
                      else _alpha_init_hankel(_host_f64(x), t, r))
        else:
            alpha0 = np.asarray(alpha0, np.complex128).reshape(-1)
            if alpha0.size != r:
                raise ValueError(
                    f"alpha0 must have r={r} entries, got {alpha0.size}"
                )
        alphas, b, rss = _varpro_lm(alpha0, t, y, maxiter=maxiter, tol=tol)
        self.n_state, self.n_modes = n_x, r
        self.alphas = alphas
        self.rss = float(rss)
        self.t_span = (float(t[0]), float(t[-1]))
        phi, self.amplitudes = _unit_modes(
            u_np if u_np is not None else np.eye(n_x), b)
        self.modes_re, self.modes_im = _mode_parts(phi, x.dtype, x.device)

    def eigs_discrete(self, dt: float = 1.0) -> np.ndarray:
        """One-step eigenvalues exp(alphas * dt) (complex host array)."""
        return np.exp(self.alphas * float(dt))

    def predict(self, times) -> torch.Tensor:
        """The fitted model at arbitrary times: (n_x, len(times)) real
        states on the modes' device (the (r, T) coefficient table is host
        complex, the (n_x, r) x (r, T) lift runs on the device)."""
        tt = np.asarray(times, np.float64).reshape(-1)
        coef = np.exp(np.multiply.outer(self.alphas, tt))  # (r, T)
        coef = coef * np.asarray(self.amplitudes)[:, None]
        c_re, c_im = _mode_parts(coef, self.modes_re.dtype,
                                 self.modes_re.device)
        return self.modes_re @ c_re - self.modes_im @ c_im


@register_model_class
class BopDmd:
    """Result container for :func:`bop_dmd`.

    ``alphas_ref`` (r,) full-data optimized-DMD eigenvalues; ``alphas_all``
    (B, r) member eigenvalues aligned to the reference; ``alphas_mean`` /
    ``alphas_std``; ``modes_re``/``modes_im`` (n_x, r) reference mode
    tensors; ``amps_all`` (B, r), ``phis_all`` (B, n_x, r) host arrays.
    ``predict(times)`` is the bagged-mean forecast, ``predict_interval``
    adds pointwise percentile bands (host arrays).
    """

    def predict(self, times) -> np.ndarray:
        mean, _, _ = self.predict_interval(times)
        return mean

    def predict_interval(self, times, lo: float = 2.5,
                         hi: float = 97.5):
        """(mean, lo_band, hi_band), each (n_x, T): statistics over the
        member spectral forecasts at the given times."""
        tt = np.asarray(times, np.float64).reshape(-1)
        nb = self.alphas_all.shape[0]
        preds = np.empty((nb, int(self.n_state), tt.size))
        for i in range(nb):
            coef = np.exp(np.multiply.outer(self.alphas_all[i], tt))
            coef = coef * self.amps_all[i][:, None]
            preds[i] = np.real((self.phis_all[i] @ coef))
        return (preds.mean(axis=0),
                np.percentile(preds, lo, axis=0),
                np.percentile(preds, hi, axis=0))


def bop_dmd(x_data, n_modes: int, t=None, dt: float = 1.0,
            n_members: int = 64, subset_frac: float = 0.8,
            maxiter: int = 40, n_iters: int = 10, key=0,
            n_oversamples: int = 8, device=None) -> BopDmd:
    """Bagging-optimized DMD: B optimized-DMD fits on random time subsets,
    warm-started from the full-data fit. The POD projection is computed
    once on the device and shared; each member is a host varpro solve on
    its (m_sub, r) subset. ``device`` is where numpy input goes."""
    from scipy.optimize import linear_sum_assignment

    from corrla_rs_tpu_torch.ops.design import _seed_from_key

    if not 0.0 < subset_frac <= 1.0:
        raise ValueError(
            f"subset_frac must be in (0, 1], got {subset_frac}"
        )
    if n_members < 2:
        raise ValueError(f"n_members must be >= 2, got {n_members}")
    x = _snapshots(x_data, device, 4)
    n_x, m = int(x.shape[0]), int(x.shape[1])
    r = int(n_modes)
    t = _times(t, m, dt)

    u, xp = _project(x, r, int(n_iters), int(n_oversamples), key)
    u_np = _host_f64(u)
    xp_np = _host_f64(xp)

    # full-data reference fit (also the members' warm start)
    alpha_ref = _alpha_init(xp_np, t)
    alpha_ref, b_ref, _ = _varpro_lm(alpha_ref, t, xp_np.T, maxiter=maxiter)
    m_sub = max(int(round(subset_frac * m)), r + 2)
    m_sub = min(m_sub, m)

    rng = np.random.default_rng(_seed_from_key(key))
    alphas_all = np.empty((int(n_members), r), np.complex128)
    amps_all = np.empty((int(n_members), r))
    phis_all = np.empty((int(n_members), n_x, r), np.complex128)
    for i in range(int(n_members)):
        idx = np.sort(rng.choice(m, size=m_sub, replace=False))
        a_i, b_i, _ = _varpro_lm(alpha_ref, t[idx], xp_np[:, idx].T,
                                 maxiter=maxiter)
        phi_i, amp_i = _unit_modes(u_np, b_i)
        # align onto the reference spectrum
        cost = np.abs(a_i[None, :] - alpha_ref[:, None])
        _, cols = linear_sum_assignment(cost)
        alphas_all[i] = a_i[cols]
        amps_all[i] = amp_i[cols]
        phis_all[i] = phi_i[:, cols]  # unit-norm; amps_all holds scale

    out = BopDmd.__new__(BopDmd)
    out.n_state, out.n_modes = n_x, r
    out.alphas_ref = alpha_ref
    phi_ref, amp_ref = _unit_modes(u_np, b_ref)
    out.modes_re, out.modes_im = _mode_parts(phi_ref, x.dtype, x.device)
    out.amplitudes = amp_ref
    out.alphas_all = alphas_all
    out.amps_all = amps_all
    out.phis_all = phis_all
    out.alphas_mean = alphas_all.mean(axis=0)
    out.alphas_std = np.sqrt(np.mean(
        np.abs(alphas_all - out.alphas_mean[None, :]) ** 2, axis=0
    ))
    return out
