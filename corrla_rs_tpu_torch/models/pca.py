"""PCA via randomized SVD.

Counterpart of ``corrla_rs_tpu/models/pca.py`` (reference pca_rsvd.rs:13-112,
``PcaRsvd`` + ``ApplyTransform``): column-center, RSVD with 20 power
iterations and min(n_dim, 10) oversamples (pca_rsvd.rs:65-66), store the
singular values and components (= V rows); ``explained_var`` = s^2 / (n-1)
(pca_rsvd.rs:91-99); the forward transform centers then projects
(pca_rsvd.rs:43-46); the inverse transform projects back and re-adds the
training means (pca_rsvd.rs:49-52). The ``mesh=`` path is not ported yet.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops.mat_utils import col_means
from corrla_rs_tpu_torch.ops.random_svd import random_svd
from corrla_rs_tpu_torch.utils.config import PcaConfig
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["PcaRsvd"]


class PcaRsvd:
    """PCA of a (n_samples, n_dim) data matrix using randomized SVD.

    ``key`` is an int seed or a ``torch.Generator``. ``device`` is where a
    numpy ``x_mat`` goes (default: ``utils.device.default_device()``).
    """

    def __init__(self, x_mat, rank: int, key=0, n_iter: int | None = None,
                 stabilize: str = "auto", config: PcaConfig | None = None,
                 device=None):
        cfg = config or PcaConfig()
        self.pca_rank = int(rank)
        self._n_iter = int(n_iter if n_iter is not None else cfg.n_iter)
        self._max_oversamples = int(cfg.max_oversamples)
        self._stabilize = stabilize if config is None else cfg.stabilize
        self._device = device
        self.fit(x_mat, rank, key=key)

    def fit(self, x_mat, rank: int, key=0):
        """(Re)fit, parity with pca_rsvd.rs:85-88."""
        x = as_tensor(x_mat, device=self._device)
        self.pca_rank = int(rank)
        self.n_samples = x.shape[0]
        means = col_means(x)
        n_oversamples = min(x.shape[1], self._max_oversamples)
        _u, s, vt = random_svd(x - means, self.pca_rank, self._n_iter,
                               n_oversamples, key=key,
                               stabilize=self._stabilize)
        self.means, self.pca_s, self.components_ = means, s, vt
        return self

    def explained_var(self) -> torch.Tensor:
        """Per-component explained variance s^2/(n-1). pca_rsvd.rs:91-99."""
        return self.pca_s**2 / (self.n_samples - 1.0)

    @property
    def components(self) -> torch.Tensor:
        """Principal directions, rows = components (r, n_dim)."""
        return self.components_

    @property
    def singular_values(self) -> torch.Tensor:
        return self.pca_s

    def _input(self, mat) -> torch.Tensor:
        return as_tensor(mat, device=self.components_.device,
                         dtype=self.components_.dtype)

    def apply_tr(self, targ_mat) -> torch.Tensor:
        """Center (by the target's own column means, parity with
        pca_rsvd.rs:43-46 which calls center_mat_col) and project."""
        t = self._input(targ_mat)
        return (t - col_means(t)) @ self.components_.mT

    def apply_inv_tr(self, red_mat) -> torch.Tensor:
        """Map reduced coords back and re-add training means. pca_rsvd.rs:49-52."""
        return self._input(red_mat) @ self.components_ + self.means
