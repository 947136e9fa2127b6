"""Eigensystem Realization Algorithm (ERA) and OKID.

Counterpart of ``corrla_rs_tpu/models/era.py`` (Juang & Pappa 1985;
Juang-Phan-Horta-Longman 1991): a balanced minimal state-space realization
(A, B, C) from impulse-response (Markov) parameters h_k = C A^k B, and the
observer-Kalman identification that turns an arbitrary input-output record
into those parameters.

The block-Hankel matrices are one gather each over the Markov stack, the
heavy step is the port's randomized SVD of H0, and the realization is three
small products, all on the device. OKID's regression is two products and
one solve on the device; its Markov recursion is small host numpy, as in
the JAX package. The rollouts and ``impulse_response`` are step loops of
small products on the device, with scipy.signal.dlsim's (A, B, C, 0)
semantics.
"""
from __future__ import annotations

import numpy as np
import torch

from corrla_rs_tpu_torch.ops.random_svd import random_svd
from corrla_rs_tpu_torch.utils.checkpoint import register_model_class
from corrla_rs_tpu_torch.utils.device import _host_f64, as_tensor

__all__ = ["Era", "era", "okid", "era_okid"]


def _era_kernel(markov, mo, mc, rank, n_iters, n_os, key):
    """(a, b, c, hsv) from the Markov stack (n_h, q, p).

    H0[i, j] = h_{i+j}, H1[i, j] = h_{i+j+1} (block indices, one gather
    each); randomized SVD of H0; balanced realization
    A = S^-1/2 U^T H1 V S^-1/2, B = S^1/2 V^T E_p, C = E_q^T U S^1/2.
    """
    q, p = markov.shape[1], markov.shape[2]
    idx = (torch.arange(mo, device=markov.device)[:, None]
           + torch.arange(mc, device=markov.device)[None, :])
    # (mo, mc, q, p) -> (mo q, mc p)
    h0 = markov[idx].permute(0, 2, 1, 3).reshape(mo * q, mc * p)
    h1 = markov[idx + 1].permute(0, 2, 1, 3).reshape(mo * q, mc * p)
    u, s, vt = random_svd(h0, rank, n_iters, n_os, key=key)
    s_ih = 1.0 / torch.sqrt(torch.clamp_min(s, torch.finfo(s.dtype).tiny))
    s_h = torch.sqrt(s)
    a = (s_ih[:, None] * ((u.mT @ h1) @ vt.mT)) * s_ih[None, :]
    b = s_h[:, None] * vt[:, :p]
    c = u[:q, :] * s_h[None, :]
    return a, b, c, s


def _lti_rollout(a, b, c, x0, u_seq):
    """y (n_y, n_t) of x' = A x + B u, y = C x from inputs (n_u, n_t)."""
    ys = x0.new_empty((c.shape[0], u_seq.shape[1]))
    bu = b @ u_seq
    x = x0
    for t in range(u_seq.shape[1]):
        ys[:, t] = c @ x
        x = a @ x + bu[:, t]
    return ys


def _eigvals(a: torch.Tensor) -> np.ndarray:
    return np.linalg.eigvals(_host_f64(a))


@register_model_class
class Era:
    """Balanced state-space realization from impulse-response data (see
    :func:`era`).

    ``a``/``b``/``c``: (r, r), (r, n_u), (n_y, r) realization in balanced
    coordinates; ``hsv``: Hankel singular values; ``lambdas``: complex host
    spectrum of A (the identified poles).
    """

    def truncate(self, order: int) -> "Era":
        """Balanced truncation to a smaller order without refitting: the
        realization is balanced, so the order-r reduction is the leading
        r x r block."""
        r = int(order)
        if not 1 <= r <= self.order:
            raise ValueError(
                f"order must be in [1, {self.order}], got {order}"
            )
        out = Era.__new__(Era)
        out.order = r
        out.n_outputs, out.n_inputs = self.n_outputs, self.n_inputs
        out.a = self.a[:r, :r]
        out.b = self.b[:r, :]
        out.c = self.c[:, :r]
        out.hsv = self.hsv[:r]
        out.lambdas = _eigvals(out.a)
        d = getattr(self, "d", None)
        if d is not None:
            out.d = d
        return out

    def impulse_response(self, n_steps: int) -> torch.Tensor:
        """(n_steps, n_y, n_u) Markov parameters of the realization:
        h_0 = C B, h_k = C A^k B."""
        n = int(n_steps)
        hs = self.c.new_empty((n, self.c.shape[0], self.b.shape[1]))
        ca = self.c
        for k in range(n):
            hs[k] = ca @ self.b
            ca = ca @ self.a
        return hs

    def predict(self, u_seq, x0=None) -> torch.Tensor:
        """(n_y, n_t) response to inputs u_seq (n_u, n_t) from initial
        balanced state x0 (default 0): y_t = C x_t, x_{t+1} = A x_t + B u_t
        (scipy.signal.dlsim's (A, B, C, 0) semantics), plus D u_t when the
        realization came from :func:`era_okid`."""
        u = as_tensor(u_seq, device=self.a.device, dtype=self.a.dtype)
        if u.ndim == 1:
            u = u[None, :]
        if u.shape[0] != self.n_inputs:
            raise ValueError(
                f"u_seq must be ({self.n_inputs}, n_t), got "
                f"{tuple(u.shape)}"
            )
        if x0 is None:
            x0 = self.a.new_zeros(self.order)
        else:
            x0 = as_tensor(x0, device=self.a.device,
                           dtype=self.a.dtype).reshape(-1)
            if x0.shape[0] != self.order:
                raise ValueError(
                    f"x0 must have {self.order} entries, got "
                    f"{tuple(x0.shape)}"
                )
        ys = _lti_rollout(self.a, self.b, self.c, x0, u)
        d = getattr(self, "d", None)   # feedthrough from era_okid
        return ys if d is None else ys + d @ u


def era(markov, rank: int, mo: int | None = None, mc: int | None = None,
        n_iters: int = 10, key=0, n_oversamples: int = 8,
        device=None) -> Era:
    """ERA fit from Markov parameters.

    markov: (n_h, n_y, n_u) impulse-response stack, ``markov[k]`` the
    output response at step k+1 to a unit impulse at step 0
    (h_{k+1} = C A^k B); rank: realization order r (inspect ``hsv``);
    mo / mc: block rows / columns of the Hankel matrix (default: split the
    available n_h as evenly as possible). ``device`` is where numpy input
    goes.
    """
    h = as_tensor(markov, device=device)
    if h.ndim == 2:
        h = h[:, :, None] if h.shape[1] != 1 else h[:, None, :]
    if h.ndim != 3:
        raise ValueError(
            f"markov must be (n_h, n_y, n_u), got {tuple(h.shape)}"
        )
    n_h = int(h.shape[0])
    if mo is None and mc is None:
        mo = (n_h + 1) // 2
        mc = n_h - mo            # mo + mc = n_h; indices reach h[n_h-1]
    elif mo is None:
        mc = int(mc)
        mo = n_h - mc
    else:
        mo = int(mo)
        mc = n_h - mo if mc is None else int(mc)
    if mo < 1 or mc < 1 or mo + mc > n_h:
        raise ValueError(
            f"need mo, mc >= 1 with mo + mc <= n_h = {n_h}; got "
            f"mo={mo}, mc={mc}"
        )
    r = int(rank)
    q, p = int(h.shape[1]), int(h.shape[2])
    if not 1 <= r <= min(mo * q, mc * p):
        raise ValueError(
            f"rank must be in [1, min(mo*n_y, mc*n_u)] = "
            f"[1, {min(mo * q, mc * p)}], got {rank}"
        )
    a, b, c, hsv = _era_kernel(h, mo, mc, r, int(n_iters),
                               int(n_oversamples), key)
    out = Era.__new__(Era)
    out.order = r
    out.n_outputs, out.n_inputs = q, p
    out.a, out.b, out.c = a, b, c
    out.hsv = hsv
    out.lambdas = _eigvals(a)
    return out


def _okid_lstsq(u, y, l, ridge):
    """Observer-Markov least squares: regressor rows for k = l..N-1 are
    [u_k; v_{k-1}; ...; v_{k-l}] with v_j = [u_j; y_j], one gather over the
    stacked (p+q, N) record; the normal equations are two products and one
    small solve."""
    p, n = u.shape
    uy = torch.cat([u, y], dim=0)                      # (p+q, N)
    cols = torch.arange(l, n, device=u.device)         # regression times
    lags = torch.arange(1, l + 1, device=u.device)
    idx = cols[None, :] - lags[:, None]                # (l, n-l)
    past = uy[:, idx]                                  # (p+q, l, n-l)
    past = past.permute(1, 0, 2).reshape(l * uy.shape[0], n - l)
    v = torch.cat([u[:, l:], past], dim=0)             # (p + l(p+q), n-l)
    yl = y[:, l:]
    g = v @ v.mT
    g = g + ridge * torch.trace(g) / g.shape[0] * torch.eye(
        g.shape[0], dtype=g.dtype, device=g.device)
    # M = Y V^T G^{-1}; G symmetric
    return torch.linalg.solve(g, v @ yl.mT).mT         # (q, p + l(p+q))


def okid(u_data, y_data, n_markov: int, n_obs: int | None = None,
         ridge: float = 1e-10, device=None):
    """OKID: system Markov parameters from an arbitrary input-output
    record.

    u_data: (n_u, N) inputs; y_data: (n_y, N) outputs; n_markov: how many
    system Markov parameters h_1..h_{n_markov} to return; n_obs: observer
    depth l (default n_markov); ridge: relative Tikhonov weight on the
    regressor Gram. ``device`` is where numpy input goes.

    Returns ``(markov, d)`` as host float64 arrays: markov (n_markov, n_y,
    n_u) with ``markov[k] = h_{k+1} = C A^k B`` (feed directly to
    :func:`era`) and d (n_y, n_u) the feedthrough.
    """
    u = as_tensor(u_data, device=device)
    y = as_tensor(y_data, device=u.device, dtype=u.dtype)
    if u.ndim == 1:
        u = u[None, :]
    if y.ndim == 1:
        y = y[None, :]
    if u.ndim != 2 or y.ndim != 2 or u.shape[1] != y.shape[1]:
        raise ValueError(
            f"u_data/y_data must be (n_u, N)/(n_y, N) with equal N, "
            f"got {tuple(u.shape)} / {tuple(y.shape)}"
        )
    p, n = int(u.shape[0]), int(u.shape[1])
    q = int(y.shape[0])
    l = int(n_markov) if n_obs is None else int(n_obs)
    if not 1 <= l <= n - 1:
        raise ValueError(f"n_obs must be in [1, N-1], got {l}")
    if n - l <= p + l * (p + q):
        raise ValueError(
            f"record too short: need N - n_obs > n_u + n_obs*(n_u+n_y) "
            f"regression columns, got {n - l} <= {p + l * (p + q)}"
        )
    m = _okid_lstsq(u, y, l, float(ridge)).cpu().numpy().astype(np.float64)
    d = m[:, :p]
    # observer Markov blocks: Mbar_i = [Mbar_i^(1) (q,p), Mbar_i^(2) (q,q)]
    m1 = np.empty((l, q, p))
    m2 = np.empty((l, q, q))
    for i in range(l):
        blk = m[:, p + i * (p + q): p + (i + 1) * (p + q)]
        m1[i] = blk[:, :p]
        m2[i] = blk[:, p:]
    # recursion: h_k = Mbar_k^(1) + Mbar_k^(2) D + sum_i Mbar_i^(2) h_{k-i}
    n_h = int(n_markov)
    h = np.zeros((n_h + 1, q, p))  # h[0] unused (h_0 = D kept separate)
    for k in range(1, n_h + 1):
        acc = (m1[k - 1] + m2[k - 1] @ d) if k <= l else np.zeros((q, p))
        for i in range(1, min(k, l + 1)):
            if k - i >= 1:
                acc = acc + m2[i - 1] @ h[k - i]
        h[k] = acc
    return h[1:], d


def era_okid(u_data, y_data, rank: int, n_markov: int | None = None,
             n_obs: int | None = None, ridge: float = 1e-10,
             **era_kwargs) -> Era:
    """Identify a balanced realization straight from operating data:
    :func:`okid` -> :func:`era`. The feedthrough lands on ``fit.d`` and
    ``predict`` includes it. ``device=`` among ``era_kwargs`` places both
    steps (default: where tensor data lies, else the default device)."""
    u_shape, y_shape = np.shape(u_data), np.shape(y_data)
    n = y_shape[-1]
    p = 1 if len(u_shape) == 1 else u_shape[0]
    q = 1 if len(y_shape) == 1 else y_shape[0]
    # okid feasibility: the observer depth l must leave more regression
    # columns than unknowns, N - l > p + l (p + q), so
    # l < (N - p) / (p + q + 1); keep a 2x margin for a well-posed LS
    l_max = max(1, (n - p) // (2 * (p + q + 1)))
    if n_markov is None:
        n_markov = max(2, min(n // 4, 200, l_max))
    if n_obs is None:
        n_obs = min(int(n_markov), l_max)
    dev = era_kwargs.get("device")
    if dev is None and isinstance(u_data, torch.Tensor):
        dev = u_data.device
    markov, d = okid(u_data, y_data, int(n_markov), n_obs=n_obs,
                     ridge=ridge, device=dev)
    fit = era(markov, rank, **{**era_kwargs, "device": dev})
    fit.d = torch.as_tensor(d, dtype=fit.a.dtype, device=fit.a.device)
    return fit
