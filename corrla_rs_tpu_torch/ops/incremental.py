"""Incremental (online) truncated SVD and PCA.

Counterpart of ``corrla_rs_tpu/ops/incremental.py`` (beyond the reference,
which refits from scratch when data arrives, pca_rsvd.rs:56-82). Production
streams append snapshots/samples continuously, and a refit costs a full RSVD
over all data seen so far. This module maintains a rank-r factorization
under appends in O(n r^2 + n r c) per batch of c new columns, independent of
how many columns have ever been absorbed:

- ``IncrementalSvd``: Brand (2002/2006) incremental SVD. State is
  (U (n, r), s (r,), V (m_seen, r)); ``update(C)`` absorbs new columns
  by projecting onto the current range, QR-ing the residual, and
  re-diagonalizing a small ((r+c), (r+c)) core matrix. Exact (fp-level)
  whenever the data's true rank stays <= r; otherwise the optimal
  truncation of the augmented factorization at each step (the standard
  online-truncation greedy).
- ``IncrementalPca``: Ross/Lim/Lin/Yang (2008) mean-corrected
  incremental PCA over row batches (sklearn ``partial_fit`` semantics,
  matching this library's PCA layout: samples are rows, components are
  rows of Vt). The running mean shift is absorbed as one extra rank-1
  correction column per batch.

Each update is projection products, a reduced Householder QR of the (n, c)
residual and one small dense SVD. State lives on the device of the first
batch (numpy batches go to ``utils.device.default_device()``); nothing
scales with the number of absorbed batches.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["IncrementalSvd", "IncrementalPca"]


def _brand_core(u, s, c_new):
    """The Brand step shared by both classes: for the current left factors
    ``u`` (n, r), values ``s`` and new columns ``c_new`` (n, c), returns
    ([U, Q_H] (n, r + c'), U_K, s_K, Vt_K) with K = [[diag(s), U^T C],
    [0, R_H]] = U_K diag(s_K) Vt_K and Q_H R_H the QR of the residual.
    R_H is (min(n, c), c): the residual column space cannot exceed n
    rows."""
    r = u.shape[1]
    ell = u.mT @ c_new                       # (r, c)
    q_h, r_h = torch.linalg.qr(c_new - u @ ell, mode="reduced")
    k = torch.cat([
        torch.cat([torch.diag(s), ell], dim=1),
        torch.cat([u.new_zeros((r_h.shape[0], r)), r_h], dim=1),
    ])
    u_k, s_k, vt_k = torch.linalg.svd(k, full_matrices=False)
    return torch.cat([u, q_h], dim=1), u_k, s_k, vt_k


def _brand_update_cols(u, s, c_new, rank):
    """One Brand column-append step on (U, s); V is handled by the caller
    (it only grows; the rotation applied to it is returned).

    Returns (u_new (n, rank), s_new (rank,), rot_old (r, rank), rot_new
    (c, rank)): V_new = [[V @ rot_old], [rot_new]] stacked by the caller.
    """
    r = u.shape[1]
    basis, u_k, s_k, vt_k = _brand_core(u, s, c_new)
    v_k = vt_k.mT                              # (r+c, r+c)
    return (basis @ u_k[:, :rank], s_k[:rank], v_k[:r, :rank],
            v_k[r:, :rank])


class IncrementalSvd:
    """Rank-r truncated SVD of a column-growing matrix A = [C_1, C_2, ...].

    ``update(C)`` absorbs a new (n, c) column batch; ``u``/``s``/``v``
    expose the current factorization (A ~= U diag(s) V^T with V over all
    columns seen). ``track_v=False`` drops V (row space) for memory-free
    absorption of unbounded streams (POD modes / PCA components only
    need the left factors here).
    """

    def __init__(self, rank: int, track_v: bool = True):
        self.rank = int(rank)
        self.track_v = bool(track_v)
        self.u = None
        self.s = None
        self.v = None
        self.n_cols = 0

    def update(self, c_new) -> "IncrementalSvd":
        c_new = as_tensor(c_new)
        if c_new.ndim == 1:
            c_new = c_new[:, None]
        n, c = c_new.shape
        if self.u is None:
            # bootstrap: thin SVD of the first batch
            u0, s0, vt0 = torch.linalg.svd(c_new, full_matrices=False)
            r = min(self.rank, min(n, c))
            self.u, self.s = u0[:, :r], s0[:r]
            if self.track_v:
                self.v = vt0.mT[:, :r]
            self.n_cols = c
            return self
        if n != self.u.shape[0]:
            raise ValueError(
                f"new columns have {n} rows, state has {self.u.shape[0]}"
            )
        r_cur = self.u.shape[1]
        r_next = min(self.rank, r_cur + c)
        u, s, rot_old, rot_new = _brand_update_cols(
            self.u, self.s, c_new.to(self.u.device), r_next
        )
        self.u, self.s = u, s
        if self.track_v:
            self.v = torch.cat([self.v @ rot_old, rot_new], dim=0)
        self.n_cols += c
        return self

    def reconstruct(self) -> torch.Tensor:
        """U diag(s) V^T over all absorbed columns (requires track_v)."""
        if self.v is None:
            raise ValueError("track_v=False discarded the row space")
        return (self.u * self.s[None, :]) @ self.v.mT


def _ipca_update_kernel(components, svals, mean, n_seen, x_batch, rank):
    """Mean-corrected row-batch PCA update (Ross et al. 2008 sec. 3.1,
    transposed to samples-as-rows): the change of mean enters as ONE
    virtual row sqrt(n*c/(n+c)) (mean_old - mean_batch) appended to the
    centered batch; then a Brand step on the transposed factorization.
    """
    c = x_batch.shape[0]
    mean_b = torch.mean(x_batch, dim=0)
    xc = x_batch - mean_b[None, :]
    corr = (n_seen * c / (n_seen + c)) ** 0.5 * (mean - mean_b)
    rows = torch.cat([xc, corr[None, :]], dim=0)          # (c+1, d)
    mean_new = (n_seen * mean + c * mean_b) / (n_seen + c)
    # Brand on columns of A^T: current left factors are the components^T
    basis, u_k, s_k, _vt_k = _brand_core(components.mT, svals, rows.mT)
    return (basis @ u_k[:, :rank]).mT, s_k[:rank], mean_new


class IncrementalPca:
    """Online PCA with running mean (sklearn ``IncrementalPCA``
    semantics; this library's layout: components_ rows are directions).

    ``partial_fit(X)`` absorbs an (n_batch, d) row batch;
    ``components_`` / ``singular_values_`` / ``mean_`` /
    ``explained_variance_`` match a batch PCA of all absorbed rows
    exactly when the data rank stays <= n_components, and the standard
    online-truncation greedy approximation otherwise.
    """

    def __init__(self, n_components: int):
        self.n_components = int(n_components)
        self.components_ = None
        self.singular_values_ = None
        self.mean_ = None
        self.n_samples_seen_ = 0

    def partial_fit(self, x) -> "IncrementalPca":
        x = as_tensor(x)
        if x.ndim != 2:
            raise ValueError(f"expected (n, d) batch, got {tuple(x.shape)}")
        n_b, d = x.shape
        if self.components_ is None:
            mean = torch.mean(x, dim=0)
            _u, s, vt = torch.linalg.svd(x - mean[None, :],
                                         full_matrices=False)
            r = min(self.n_components, min(n_b, d))
            self.components_ = vt[:r]
            self.singular_values_ = s[:r]
            self.mean_ = mean
            self.n_samples_seen_ = n_b
            return self
        if d != self.components_.shape[1]:
            raise ValueError(
                f"batch has {d} features, state has "
                f"{self.components_.shape[1]}"
            )
        r_next = min(self.n_components,
                     self.components_.shape[0] + n_b + 1)
        self.components_, self.singular_values_, self.mean_ = (
            _ipca_update_kernel(
                self.components_, self.singular_values_, self.mean_,
                float(self.n_samples_seen_),
                x.to(self.components_.device), r_next,
            )
        )
        self.n_samples_seen_ += n_b
        return self

    @property
    def explained_variance_(self):
        return self.singular_values_ ** 2 / max(self.n_samples_seen_ - 1, 1)

    def transform(self, x) -> torch.Tensor:
        x = as_tensor(x, device=self.components_.device)
        return (x - self.mean_[None, :]) @ self.components_.mT

    def inverse_transform(self, z) -> torch.Tensor:
        z = as_tensor(z, device=self.components_.device)
        return z @ self.components_ + self.mean_[None, :]
