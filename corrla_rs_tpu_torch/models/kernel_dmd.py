"""Kernel DMD (kernel EDMD).

Counterpart of ``corrla_rs_tpu/models/kernel_dmd.py`` (Williams, Rowley &
Kevrekidis 2015): the EDMD regression run implicitly in a reproducing-kernel
Hilbert space from the m x m snapshot Grams

    G_ij = k(x_i, x_j),   A_ij = k(y_i, x_j),   G = Q S^2 Q^T (rank r),
    K_hat = (S^+ Q^T) A (Q S^+)                      (r, r)

so the cost is set by the number of snapshots, never by the dictionary.

Both Grams are GEMMs on the device (the RBF kernel by the Gram expansion,
as the JAX package forms it: the columns have the state's dimension, where
a GEMM is the right tool); the truncation is ``torch.linalg.eigh`` on the
device or, with ``gram_method='nystrom'``, the port's ``nystrom_eigh``
(``key`` seeds its sketch through ``ops.random_svd._draw_sketch``). The
projections K_hat = P^T A P and the modes' least squares X^T = Phi Xi^T run
on the device in float64, since their operands are m x m and m x n; only
the r x r eigenproblem goes to the host (``eig_host``), as in the JAX
package, which does those products in host numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from corrla_rs_tpu_torch.ops.eig import eig_host
from corrla_rs_tpu_torch.ops.nystrom import nystrom_eigh
from corrla_rs_tpu_torch.utils.checkpoint import register_model_class
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["KernelDmd"]


def _kernel_cross(x, z, kernel: str, length_scale, degree, coef0):
    """k(x_cols, z_cols): (cx, cz) kernel matrix for column data, formed in
    place on the (cx, cz) product (the same roundings as the JAX
    package's expression, one m x m buffer)."""
    k = x.mT @ z
    if kernel == "rbf":
        k.mul_(-2.0).add_((x * x).sum(dim=0)[:, None])
        k.add_((z * z).sum(dim=0)[None, :]).clamp_min_(0.0)
        return k.div_(-2.0 * length_scale ** 2).exp_()
    k.div_(length_scale ** 2)
    if kernel == "poly":
        return k.add_(coef0).pow_(degree)
    return k                                           # linear


def _lstsq_pinv(a, b):
    """Least squares a X = b for a complex a (m, r) and a real b (m, n),
    through the SVD of a with numpy ``lstsq``'s cutoff rcond =
    eps * max(m, r): the minimum-norm solution for a rank-deficient a."""
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    cut = torch.finfo(s.dtype).eps * max(a.shape) * s[0]
    s_inv = torch.where(s > cut, 1.0 / s.clamp_min(1e-300),
                        torch.zeros_like(s))
    # U^H b for a real b as two real products: no complex copy of b
    uhb = torch.complex(u.real.mT @ b, -(u.imag.mT @ b))
    return vh.mH @ (s_inv[:, None].to(u.dtype) * uhb)


@register_model_class
class KernelDmd:
    """Koopman spectral analysis from kernel Grams (kernel EDMD).

    x_data: (n, m) snapshot columns; consecutive columns pair unless
    ``y_data`` gives the successors. rank: truncation rank r of the kernel
    Gram. kernel: 'rbf' (default), 'poly' or 'linear'; length_scale,
    degree and coef0 as in the JAX package. gram_method: 'eigh' (exact) or
    'nystrom' (one-pass randomized; ``key`` seeds the sketch). eps: relative
    eigenvalue floor of the Gram. ``device`` is where numpy input goes.

    Attributes after fit: ``lambdas`` (complex (r,), magnitude-sorted host
    array), ``modes`` (complex (n, r) host array), ``eigenfunctions(x)``,
    ``predict(x0, n_steps)``.
    """

    def __init__(self, x_data, rank: int, kernel: str = "rbf",
                 length_scale: float = 1.0, degree: int = 2,
                 coef0: float = 1.0, gram_method: str = "eigh",
                 eps: float = 1.0e-10, key=0, y_data=None, device=None):
        if kernel not in ("rbf", "poly", "linear"):
            raise ValueError(
                f"kernel must be 'rbf', 'poly' or 'linear', got {kernel!r}"
            )
        if gram_method not in ("eigh", "nystrom"):
            raise ValueError(
                f"gram_method must be 'eigh' or 'nystrom', "
                f"got {gram_method!r}"
            )
        x = as_tensor(x_data, device=device)
        if x.ndim != 2 or x.shape[1] < 2:
            raise ValueError(
                f"x_data must be (n, m >= 2), got {tuple(x.shape)}"
            )
        if y_data is None:
            y = x[:, 1:]
            x = x[:, :-1]
        else:
            y = as_tensor(y_data, device=x.device, dtype=x.dtype)
            if y.shape != x.shape:
                raise ValueError(
                    f"y_data shape {tuple(y.shape)} != x_data shape "
                    f"{tuple(x.shape)}"
                )
        m = int(x.shape[1])
        if not 1 <= rank <= m:
            raise ValueError(f"rank must be in [1, {m}], got {rank}")
        self.n_state = int(x.shape[0])
        self.kernel = kernel
        self.length_scale = float(length_scale)
        self.degree = int(degree)
        self.coef0 = float(coef0)
        self.rank = int(rank)
        self._x_train = x

        args = (kernel, self.length_scale, self.degree, self.coef0)
        g = _kernel_cross(x, x, *args)
        a = _kernel_cross(y, x, *args)
        if gram_method == "nystrom":
            evals, q = nystrom_eigh(g, self.rank, key=key)
        else:
            evals, q = torch.linalg.eigh(0.5 * (g + g.mT))
            evals = evals.flip(0)[:self.rank]
            q = q.flip(1)[:, :self.rank]
        del g
        # numerical-rank floor: directions below eps * max are noise and
        # S^+ would blow up on them
        evals, q = evals.double(), q.double()
        ev_host = evals.cpu().numpy()
        keep = ev_host > float(eps) * max(ev_host.max(), 0.0) + 1e-300
        keep_t = torch.as_tensor(keep, device=x.device)
        evals, q = evals[keep_t], q[:, keep_t]
        self.rank = int(keep.sum())
        s = torch.sqrt(evals)
        proj = q / s[None, :]                             # Q S^+
        k_hat = (proj.mT @ a.double()) @ proj
        del a
        lam, v = eig_host(k_hat)
        order = np.argsort(-np.abs(lam))
        lam, v = lam[order], v[:, order]
        self.lambdas = lam
        v_t = torch.as_tensor(v, device=x.device)
        self._qsv = (proj.to(v_t.dtype) @ v_t).cpu().numpy()  # k(., X)->phi
        phi_train = (q * s[None, :]).to(v_t.dtype) @ v_t      # (m, r) Phi
        # modes: X^T = Phi Xi^T (least squares; Phi may be rank-deficient)
        xi_t = _lstsq_pinv(phi_train, x.mT.double())
        self.modes = xi_t.mT.cpu().numpy()                # (n, r) complex

    def eigenfunctions(self, x_new) -> np.ndarray:
        """phi(x) (r, c) complex host array at state columns ``x_new``
        (``lambdas``' order)."""
        xq = as_tensor(x_new, device=self._x_train.device,
                       dtype=self._x_train.dtype)
        if xq.ndim == 1:
            xq = xq[:, None]
        if xq.shape[0] != self.n_state:
            raise ValueError(
                f"x must have {self.n_state} rows, got {xq.shape[0]}"
            )
        kq = _kernel_cross(xq, self._x_train, self.kernel,
                           self.length_scale, self.degree, self.coef0)
        return (kq.double().cpu().numpy() @ self._qsv).T   # (r, c)

    def predict(self, x_0, n_steps: int) -> np.ndarray:
        """Spectral forecast (n, n_steps): x_t = Xi (Lambda^t phi(x_0)),
        complex algebra on the host (r is small), real part returned."""
        x0 = x_0.detach().cpu().numpy() if isinstance(x_0, torch.Tensor) \
            else np.asarray(x_0)
        phi0 = self.eigenfunctions(x0.reshape(-1))[:, 0]
        t = np.arange(1, int(n_steps) + 1)
        lam_t = self.lambdas[None, :] ** t[:, None]        # (T, r)
        xs = (lam_t * phi0[None, :]) @ self.modes.T        # (T, n)
        return np.real(xs.T)
