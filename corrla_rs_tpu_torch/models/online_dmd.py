"""Online DMD / DMDc: streaming least-squares operator updates.

Counterpart of ``corrla_rs_tpu/models/online_dmd.py``: the exponentially
weighted recursive least-squares estimate of the full operator [A B] from
streaming snapshot pairs (Zhang, Rowley, Deem & Cattafesta 2019),

    minimize_{[A B]}  sum_i rho^{k-i} || y_i - A x_i - B u_i ||^2
                      (+ ridge * rho^k * ||[A B]||_F^2),

kept under appends by the Woodbury identity in O((n+q)^2 c) a batch of c
pairs. With ``forgetting=1`` the estimate equals the ridge-regularised batch
solution Y Z^T (Z Z^T + ridge I)^{-1}; with ``forgetting<1`` old data
decays exponentially.

State is ([A B] (n, n+q), P (n+q, n+q)), P the inverse weighted Gram, on
the device; a batch update is two (n+q, c) products and one (c, c) solve
there, with no read back. Eigenvalues of A come from the host eigensolver
(``ops.eig.eig_host``); the rollouts are step loops on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from corrla_rs_tpu_torch.ops.eig import eig_host
from corrla_rs_tpu_torch.utils.device import as_tensor, default_device

__all__ = ["OnlineDmd"]


def _rls_update(ab, p, z, y, rho: float):
    """One exponentially weighted RLS batch update.

    ab: (n, p_dim) operator [A B]; p: (p_dim, p_dim) inverse weighted Gram;
    z: (p_dim, c) regressors [x; u]; y: (n, c) targets. Returns (ab', p').

    Forgetting is per snapshot pair: a c-column batch decays all past data
    by rho^c and weights column i by rho^(c-1-i). With P~ = P / rho^c and
    Gamma = (I_c + Z~^T P~ Z~)^{-1},
        [A B]' = [A B] + (Y~ - [A B] Z~) Gamma Z~^T P~
        P'     = P~ - P~ Z~ Gamma Z~^T P~        (Woodbury, exact).
    """
    c = z.shape[1]
    w_sqrt = rho ** (0.5 * torch.arange(c - 1, -1, -1, dtype=z.dtype,
                                        device=z.device))
    z = z * w_sqrt[None, :]
    y = y * w_sqrt[None, :]
    p_t = p / rho ** c
    pz = p_t @ z                                           # (p_dim, c)
    core = torch.eye(c, dtype=z.dtype, device=z.device) + z.mT @ pz
    # g = Gamma Z^T P~ ; P~ is symmetric so Z^T P~ = pz^T
    g = torch.linalg.solve(core, pz.mT)                    # (c, p_dim)
    err = y - ab @ z
    ab_new = ab + err @ g
    p_new = p_t - pz @ g
    return ab_new, 0.5 * (p_new + p_new.mT)                # kill drift


def _roll(step, x0, n_steps: int):
    xs = x0.new_empty((x0.shape[0], n_steps))
    x = x0
    for k in range(n_steps):
        x = step(x, k)
        xs[:, k] = x[:, 0]
    return xs


class OnlineDmd:
    """Streaming DMD/DMDc operator estimate under snapshot-pair appends.

    Layout matches models/dmd.DMDc (columns are snapshots): ``update(x,
    y, u)`` absorbs c pairs where ``x`` (n, c) are current states, ``y``
    (n, c) the successor states, ``u`` (q, c) the applied controls
    (required iff n_ctrl > 0). 1-D inputs are single pairs.

    n_state: state dimension n; n_ctrl: control dimension q (0 = plain
    online DMD); forgetting: rho in (0, 1]; ridge: initial Tikhonov weight
    lambda (P_0 = I / lambda); dtype: state dtype (default float64: at the
    default ridge P_0 holds 1e8, beyond float32's reach once data arrive);
    device: where the state lives (default
    ``utils.device.default_device()``).
    """

    def __init__(self, n_state: int, n_ctrl: int = 0,
                 forgetting: float = 1.0, ridge: float = 1.0e-8,
                 dtype=None, device=None):
        if n_state < 1:
            raise ValueError(f"n_state must be >= 1, got {n_state}")
        if n_ctrl < 0:
            raise ValueError(f"n_ctrl must be >= 0, got {n_ctrl}")
        if not 0.0 < forgetting <= 1.0:
            raise ValueError(
                f"forgetting must be in (0, 1], got {forgetting}"
            )
        if ridge <= 0.0:
            raise ValueError(f"ridge must be > 0, got {ridge}")
        self.n_state = int(n_state)
        self.n_ctrl = int(n_ctrl)
        self.forgetting = float(forgetting)
        self.ridge = float(ridge)
        p_dim = self.n_state + self.n_ctrl
        if dtype is None:
            dtype = torch.float64
        elif not isinstance(dtype, torch.dtype):      # a numpy dtype
            dtype = torch.from_numpy(np.empty(0, dtype=dtype)).dtype
        dev = torch.device(device) if device is not None else default_device()
        self._ab = torch.zeros((self.n_state, p_dim), dtype=dtype,
                               device=dev)
        self._p = torch.eye(p_dim, dtype=dtype, device=dev) / self.ridge
        self.n_seen = 0

    # -- streaming -------------------------------------------------------
    def _coerce(self, arr, rows, name):
        a = as_tensor(arr, device=self._ab.device, dtype=self._ab.dtype)
        if a.ndim == 1:
            a = a[:, None]
        if a.ndim != 2 or a.shape[0] != rows:
            raise ValueError(
                f"{name} must be ({rows}, c), got {tuple(a.shape)}"
            )
        return a

    def update(self, x, y, u=None) -> "OnlineDmd":
        """Absorb snapshot pairs: columns x_i -> y_i (under control u_i)."""
        x = self._coerce(x, self.n_state, "x")
        y = self._coerce(y, self.n_state, "y")
        if y.shape[1] != x.shape[1]:
            raise ValueError(
                f"x has {x.shape[1]} columns, y has {y.shape[1]}"
            )
        if self.n_ctrl > 0:
            if u is None:
                raise ValueError("n_ctrl > 0 requires control columns u")
            u = self._coerce(u, self.n_ctrl, "u")
            if u.shape[1] != x.shape[1]:
                raise ValueError(
                    f"x has {x.shape[1]} columns, u has {u.shape[1]}"
                )
            z = torch.cat([x, u], dim=0)
        elif u is not None:
            raise ValueError("model has n_ctrl=0 but u was given")
        else:
            z = x
        self._ab, self._p = _rls_update(self._ab, self._p, z, y,
                                        self.forgetting)
        self.n_seen += int(x.shape[1])
        return self

    def fit_stream(self, x_data, u_data=None, batch: int = 64
                   ) -> "OnlineDmd":
        """Absorb a whole trajectory x_data (n, m) (consecutive columns
        form the m-1 pairs), u_data (q, m-1) or (q, m) (last column
        ignored), in batches of ``batch`` pairs."""
        x_data = as_tensor(x_data, device=self._ab.device,
                           dtype=self._ab.dtype)
        if x_data.ndim != 2 or x_data.shape[0] != self.n_state:
            raise ValueError(
                f"x_data must be ({self.n_state}, m), got "
                f"{tuple(x_data.shape)}"
            )
        m = x_data.shape[1] - 1
        if m < 1:
            raise ValueError("need at least 2 snapshot columns")
        if self.n_ctrl > 0:
            u_data = self._coerce(u_data, self.n_ctrl, "u_data")
            if u_data.shape[1] not in (m, m + 1):
                raise ValueError(
                    f"u_data must have {m} or {m + 1} columns, got "
                    f"{u_data.shape[1]}"
                )
        for lo in range(0, m, batch):
            hi = min(lo + batch, m)
            self.update(
                x_data[:, lo:hi], x_data[:, lo + 1:hi + 1],
                u_data[:, lo:hi] if self.n_ctrl > 0 else None,
            )
        return self

    # -- read-out --------------------------------------------------------
    @property
    def a(self) -> torch.Tensor:
        """Current state-transition estimate A (n, n)."""
        return self._ab[:, :self.n_state]

    @property
    def b(self) -> torch.Tensor:
        """Current control-input estimate B (n, q)."""
        return self._ab[:, self.n_state:]

    def eig(self):
        """(eigenvalues, eigenvectors) of the current A as complex numpy
        arrays, magnitude-sorted (host eigensolver)."""
        lam, w = eig_host(self.a)
        order = np.argsort(-np.abs(lam))
        return lam[order], w[:, order]

    def predict(self, x_0, u_seq=None, n_steps: int | None = None
                ) -> torch.Tensor:
        """Roll the current (A, B) forward: returns (n, k) successor
        states. With controls, k = u_seq.shape[1]; without, pass
        n_steps."""
        x0 = as_tensor(x_0, device=self._ab.device,
                       dtype=self._ab.dtype).reshape(-1, 1)
        if x0.shape[0] != self.n_state:
            raise ValueError(
                f"x_0 must have {self.n_state} entries, got {x0.shape[0]}"
            )
        a = self.a
        if self.n_ctrl > 0:
            u = self._coerce(u_seq, self.n_ctrl, "u_seq")
            bu = self.b @ u
            return _roll(lambda x, k: a @ x + bu[:, k:k + 1], x0,
                         u.shape[1])
        if n_steps is None:
            raise ValueError("n_ctrl=0 rollout needs n_steps")
        return _roll(lambda x, k: a @ x, x0, int(n_steps))
