"""Extended DMD: a Koopman operator on a dictionary of observables.

Counterpart of ``corrla_rs_tpu/models/edmd.py`` (Williams, Kevrekidis &
Rowley 2015). The state is lifted through a dictionary psi: R^n -> R^N that
always holds the state itself (and, by default, a constant), and the
Koopman approximation

    K = (Psi_y Psi_x^T)(Psi_x Psi_x^T + ridge I)^{-1}

is fitted from the three snapshot Grams and one symmetric solve on the
device. The spectrum of the N x N operator, its eigenvectors' inverse and
the eigenfunctions stay on the host (``eig_host``, numpy), as in the JAX
package; the ResDMD residuals are one batch of complex quadratic forms on
the Grams' device.

The RBF dictionary exp(-gamma ||x - c||^2) is the kernel matrix
phi = gaussian with eps = sqrt(gamma) (``ops.rbf_kernels``): on CUDA
tensors the kernel writes it straight into its rows of the lifted matrix;
on the CPU its plain version fills them. The JAX package forms the same
matrix by the Gram expansion (``_rbf_features_gram`` here, kept as the
card's timing reference). Rollouts in the lifted space are a loop of
mat-vecs on the device.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from corrla_rs_tpu_torch.ops import rbf_kernels
from corrla_rs_tpu_torch.ops.eig import eig_host
from corrla_rs_tpu_torch.utils.checkpoint import register_model_class
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["Edmd", "poly_exponents"]


def poly_exponents(n_state: int, degree: int) -> np.ndarray:
    """Exponent matrix (n_feat, n_state) of all monomials with total degree
    in [2, degree] (the constant and linear terms are excluded: Edmd always
    provides those itself)."""
    if degree < 2:
        return np.zeros((0, n_state), np.int32)
    exps = [
        e
        for e in itertools.product(range(degree + 1), repeat=n_state)
        if 2 <= sum(e) <= degree
    ]
    return np.asarray(exps, np.int32)


def _poly_features(x, exps):
    # (n_feat, n, 1) exponents against (1, n, c) states -> prod over n
    return torch.prod(x[None, :, :] ** exps[:, :, None].to(x.dtype), dim=1)


def _rbf_features_gram(x, centers, gamma):
    """exp(-gamma ||x - c||^2) by the Gram expansion, (n_c, c), as the JAX
    package computes it (``edmd.py:69-77``)."""
    d2 = ((centers * centers).sum(dim=1)[:, None]
          - 2.0 * (centers @ x)
          + (x * x).sum(dim=0)[None, :])
    return torch.exp(-gamma * d2.clamp_min(0.0))


def _rbf_features_into(out, x, centers, gamma):
    """exp(-gamma ||x - c||^2) written into ``out`` (n_c, c): one launch
    of the kernel matrix on CUDA tensors, its plain version on the CPU."""
    return rbf_kernels._pairwise_kernel_matrix_into(
        out, centers, x.mT.contiguous(), "gaussian", math.sqrt(gamma))


def _edmd_fit(psi_x, psi_y, ridge):
    """(K, G, C, L): the operator and the three snapshot Grams
    G = Psi_x Psi_x^T / c, C = Psi_y Psi_x^T / c, L = Psi_y Psi_y^T / c
    (unregularized: the ResDMD residuals need the true mass matrix)."""
    n_feat, c = psi_x.shape
    scale = 1.0 / c
    g = (psi_x @ psi_x.mT) * scale
    a = (psi_y @ psi_x.mT) * scale
    l_ = (psi_y @ psi_y.mT) * scale
    reg = ridge * (torch.trace(g) / n_feat + 1e-30)
    g_reg = g + reg * torch.eye(n_feat, dtype=g.dtype, device=g.device)
    # K = A G^{-1}; G symmetric -> K^T = G^{-1} A^T by one solve
    return torch.linalg.solve(g_reg, a.mT).mT, g, a, l_


@register_model_class
class Edmd:
    """Koopman EDMD model fitted from a trajectory (or snapshot pairs).

    x_data: (n, m) snapshot columns; consecutive columns form the m-1
    training pairs unless ``y_data`` (n, m) gives the successors. dictionary:
    'poly' (default), 'rbf', 'linear', or a callable (n, c) -> (N_user, c)
    on tensors. degree: total degree for 'poly'; centers (n_centers, n) and
    gamma for 'rbf'; include_const prepends a constant observable; ridge is
    the relative Tikhonov weight on the lifted Gram. ``device`` is where
    numpy input goes.

    Attributes after fit: ``koopman`` (N, N) real tensor; ``lambdas``
    complex (N,) host spectrum, magnitude-sorted; ``modes`` complex (n, N)
    host Koopman modes; ``eigenfunctions(x)``.
    """

    def __init__(self, x_data, dictionary="poly", degree: int = 2,
                 centers=None, gamma: float = 1.0,
                 include_const: bool = True, ridge: float = 1.0e-10,
                 y_data=None, device=None):
        if not (callable(dictionary)
                or dictionary in ("poly", "rbf", "linear")):
            raise ValueError(
                "dictionary must be 'poly', 'rbf', 'linear' or a "
                f"callable, got {dictionary!r}"
            )
        if dictionary == "rbf" and centers is None:
            raise ValueError("dictionary='rbf' requires centers")
        x = as_tensor(x_data, device=device)
        if x.ndim != 2 or x.shape[1] < 2:
            raise ValueError(
                f"x_data must be (n, m >= 2), got {tuple(x.shape)}"
            )
        self._device = x.device
        self.n_state = int(x.shape[0])
        self.include_const = bool(include_const)
        self.ridge = float(ridge)
        self.degree = int(degree)
        self.gamma = float(gamma)
        if callable(dictionary):
            self._dict_kind = "custom"
            self._psi_user = dictionary
        else:
            self._dict_kind = dictionary
        if self._dict_kind == "poly":
            self._exps = torch.as_tensor(
                poly_exponents(self.n_state, self.degree), device=x.device
            )
        elif self._dict_kind == "rbf":
            self._centers = as_tensor(centers, device=x.device,
                                      dtype=x.dtype).contiguous()
            if self._centers.ndim != 2 \
                    or self._centers.shape[1] != self.n_state:
                raise ValueError(
                    f"centers must be (n_centers, {self.n_state}), got "
                    f"{tuple(self._centers.shape)}"
                )

        if y_data is None:
            psi_x = self.lift(x[:, :-1])
            psi_y = self.lift(x[:, 1:])
        else:
            y = as_tensor(y_data, device=x.device, dtype=x.dtype)
            if y.shape != x.shape:
                raise ValueError(
                    f"y_data shape {tuple(y.shape)} != x_data shape "
                    f"{tuple(x.shape)}"
                )
            psi_x = self.lift(x)
            psi_y = self.lift(y)
        self.n_features = int(psi_x.shape[0])
        self.koopman, self._gram_g, self._gram_c, self._gram_l = _edmd_fit(
            psi_x, psi_y, self.ridge)
        del psi_x, psi_y

        lam, v = eig_host(self.koopman)
        order = np.argsort(-np.abs(lam))
        lam, v = lam[order], v[:, order]
        self.lambdas = lam
        self._v = v
        self._w = np.linalg.inv(v)          # phi(x) = W psi(x)
        off = 1 if self.include_const else 0
        self.modes = v[off:off + self.n_state, :]

    # -- lifting ---------------------------------------------------------
    def lift(self, x) -> torch.Tensor:
        """psi(x): (n, c) state columns -> (N, c) observable columns,
        ordered [const?; x; user features]."""
        x = as_tensor(x, device=self._device)
        if x.ndim == 1:
            x = x[:, None]
        if x.shape[0] != self.n_state:
            raise ValueError(
                f"x must have {self.n_state} rows, got {x.shape[0]}"
            )
        off = 1 if self.include_const else 0
        if self._dict_kind == "custom":
            user = as_tensor(self._psi_user(x), device=x.device,
                             dtype=x.dtype)
            n_user = user.shape[0]
        elif self._dict_kind == "poly":
            n_user = int(self._exps.shape[0])
        elif self._dict_kind == "rbf":
            n_user = int(self._centers.shape[0])
        else:
            n_user = 0
        head = off + self.n_state
        out = torch.empty((head + n_user, x.shape[1]), dtype=x.dtype,
                          device=x.device)
        if off:
            out[0] = 1.0
        out[off:head] = x
        if self._dict_kind == "poly" and n_user:
            out[head:] = _poly_features(x, self._exps.to(x.device))
        elif self._dict_kind == "rbf":
            _rbf_features_into(out[head:], x,
                               self._centers.to(x.device, x.dtype),
                               self.gamma)
        elif self._dict_kind == "custom":
            out[head:] = user
        return out

    # -- read-out --------------------------------------------------------
    def eigenfunctions(self, x) -> np.ndarray:
        """phi(x) (N, c) complex host array: row j is the j-th Koopman
        eigenfunction at each state column (``lambdas``' order)."""
        return self._w @ self.lift(x).cpu().numpy()

    def residuals(self) -> np.ndarray:
        """ResDMD relative residuals, one per eigenpair (Colbrook &
        Townsend): for eigenfunction phi_j with coefficient row u = W[j, :],

          res_j^2 = mean_t |phi_j(x_{t+1}) - lambda_j phi_j(x_t)|^2
                    / mean_t |phi_j(x_t)|^2

        from the stored snapshot Grams (G, C, L), no re-lifting; every
        quadratic form u M u^H at once, as diag(W M W^H), in complex128 on
        the Grams' device. Order matches ``lambdas``.
        """
        dev = self._gram_g.device
        w = torch.as_tensor(self._w.astype(np.complex128), device=dev)
        lam = torch.as_tensor(self.lambdas.astype(np.complex128), device=dev)

        def q(m):
            m = m.to(torch.float64).to(torch.complex128)
            return ((w @ m) * w.conj()).sum(dim=1)

        q_g, q_c, q_ct = q(self._gram_g), q(self._gram_c), q(self._gram_c.mT)
        den = q_g.real
        num = (q(self._gram_l) - lam.conj() * q_c - lam * q_ct
               + lam.abs() ** 2 * q_g).real
        res = torch.sqrt(num.clamp_min(0.0) / den.clamp_min(1e-300))
        return res.cpu().numpy()

    def validated_spectrum(self, eps: float = 1e-2):
        """(lambdas, residuals) restricted to eigenpairs with ResDMD
        residual <= eps: the spectral-pollution filter."""
        res = self.residuals()
        keep = res <= float(eps)
        return self.lambdas[keep], res[keep]

    def predict(self, x_0, n_steps: int, relift: bool = False
                ) -> torch.Tensor:
        """Forecast (n, n_steps) from state ``x_0``.

        relift=False (default): linear rollout in the lifted space,
        psi_{k+1} = K psi_k, read off the state rows. relift=True: re-lift
        the predicted state every step, x_{k+1} = C K psi(x_k).
        """
        x0 = as_tensor(x_0, device=self.koopman.device,
                       dtype=self.koopman.dtype).reshape(-1, 1)
        if x0.shape[0] != self.n_state:
            raise ValueError(
                f"x_0 must have {self.n_state} entries, got {x0.shape[0]}"
            )
        n_steps = int(n_steps)
        off = 1 if self.include_const else 0
        out = torch.empty((self.n_state, n_steps), dtype=self.koopman.dtype,
                          device=self.koopman.device)
        if not relift:
            psi = self.lift(x0)
            for k in range(n_steps):
                psi = self.koopman @ psi
                out[:, k] = psi[off:off + self.n_state, 0]
            return out
        xk = x0
        for k in range(n_steps):
            xk = (self.koopman @ self.lift(xk))[off:off + self.n_state, :]
            out[:, k] = xk[:, 0]
        return out
