"""Vandermonde builders for RBF polynomial augmentation.

Counterpart of ``build_vandermonde`` / ``build_full_vandermonde`` in
``corrla_rs_tpu/ops/stats_corr.py`` (reference stats_corr.rs:112-209). The
other statistics of that module are not ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["build_vandermonde", "build_full_vandermonde"]


def _interactions(x: torch.Tensor, include_self: bool) -> torch.Tensor:
    """Columns x_a * x_b in upper-triangle order (stats_corr.rs:112-142):
    x1x1, x1x2, ..., x1xN, x2x2, ..., xNxN."""
    k = x.shape[1]
    pairs = [(a, b) for a in range(k) for b in range(a, k)
             if include_self or a != b]
    ia = torch.tensor([p[0] for p in pairs], dtype=torch.long, device=x.device)
    ib = torch.tensor([p[1] for p in pairs], dtype=torch.long, device=x.device)
    return x[:, ia] * x[:, ib]


def build_vandermonde(x: torch.Tensor,
                      include_self_interactions: bool) -> torch.Tensor:
    """[x | interactions(x) | 1]. stats_corr.rs:201-209."""
    ones = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
    return torch.cat(
        [x, _interactions(x, include_self_interactions), ones], dim=1
    )


def build_full_vandermonde(x: torch.Tensor, degree: int) -> torch.Tensor:
    """Vandermonde used by RBF poly augmentation. stats_corr.rs:183-198.

    degree < 2: [x | 1]; degree >= 2: quadratic with self interactions
    (the reference never goes beyond quadratic).
    """
    if degree < 2:
        ones = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
        return torch.cat([x, ones], dim=1)
    return build_vandermonde(x, True)
