"""Nonsymmetric (complex) eigendecomposition.

Counterpart of ``corrla_rs_tpu/ops/eig.py``. Two entry points:

- ``eig(a)`` runs ``torch.linalg.eig`` on the tensor's own device and
  returns complex tensors there. On CUDA it goes through cuSOLVER's
  ``geev`` and synchronises the host with the device, so callers use it
  between stages, never inside a loop of launches.
- ``eig_host(a)`` runs LAPACK on the host and returns numpy complex arrays
  (``complex64`` for f32 input, ``complex128`` for f64).

The JAX package's probe ``jittable_eig_supported`` has no meaning in eager
torch, and its fully on-device Francis-QR solver (``eig_device``) is not
ported: both are listed as not ported in the coverage test.
"""
from __future__ import annotations

import numpy as np
import torch

from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["eig", "eig_host"]


def eig_host(a):
    """Host-LAPACK eig: (vals (n,), vecs (n, n)) as numpy complex arrays."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    vals, vecs = np.linalg.eig(a)
    ctype = np.complex64 if a.dtype == np.float32 else np.complex128
    return vals.astype(ctype), vecs.astype(ctype)


def eig(a, device=None):
    """Eigenvalues and right eigenvectors of a real square matrix: complex
    tensors (vals (n,), vecs (n, n)) on ``a``'s device (numpy input goes to
    ``device``, default ``utils.device.default_device()``). Synchronises
    with the device on CUDA."""
    return torch.linalg.eig(as_tensor(a, device=device))
