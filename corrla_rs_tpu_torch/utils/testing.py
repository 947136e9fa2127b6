"""Shared test assertion helpers.

Counterpart of ``corrla_rs_tpu/utils/testing.py``: the reference's
``mat_mat_approx_eq`` / ``mat_scale_approx_eq`` (reference
mat_utils.rs:523-549), an elementwise absolute-tolerance compare. Tensors
(on any device) and anything numpy reads are accepted.
"""
from __future__ import annotations

import numpy as np
import torch


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_mat_approx_eq(a, b, tol: float = 1.0e-12):
    a = _numpy(a)
    b = _numpy(b)
    assert a.shape == b.shape, f"shape mismatch {a.shape} vs {b.shape}"
    np.testing.assert_allclose(a, b, atol=tol, rtol=0.0)


def assert_mat_scale_approx_eq(a, b, scale: float, tol: float = 1.0e-12):
    assert_mat_approx_eq(_numpy(a) * scale, b, tol)
