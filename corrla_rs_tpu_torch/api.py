"""Functional public API mirroring the reference pyo3 module ``corrla_rs``.

Counterpart of ``rsvd`` and ``rpca`` in ``corrla_rs_tpu/api.py``: the same
signatures and return shapes (singular values as (r, 1) columns, as the
pyo3 layer returns them), plus a ``device`` for numpy inputs (default:
``utils.device.default_device()``; tensors stay where they are). ``seed``
is an int or a ``torch.Generator``.
"""
from __future__ import annotations

from corrla_rs_tpu_torch.models.pca import PcaRsvd
from corrla_rs_tpu_torch.ops.random_svd import random_svd
from corrla_rs_tpu_torch.utils.debug import guard_finite
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["rsvd", "rpca"]


@guard_finite
def rsvd(a_mat, n_rank: int, n_iters: int, n_oversamples: int, seed=0,
         device=None):
    """Randomized SVD. Parity with pyfn rsvd (lib_math_utils_py.rs:21-36).

    Returns (U (m, r), S (r, 1), Vt (r, n)).
    """
    a = as_tensor(a_mat, device=device)
    u, s, vt = random_svd(a, n_rank, n_iters, n_oversamples, key=seed)
    return u, s[:, None], vt


@guard_finite
def rpca(a_mat, n_rank: int, n_iters: int = None, n_oversamples: int = None,
         seed=0, device=None):
    """PCA via RSVD. Parity with pyfn rpca (lib_math_utils_py.rs:38-55).

    Like the reference binding, ``n_iters``/``n_oversamples`` are accepted
    but the PCA model uses its own defaults (pca_rsvd.rs:65-66). Returns
    (singular_values (r, 1), components (r, n_dim)).
    """
    pca = PcaRsvd(a_mat, n_rank, key=seed, device=device)
    return pca.singular_values[:, None], pca.components
