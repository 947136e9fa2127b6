"""Nonsymmetric (complex) eigendecomposition.

Counterpart of ``corrla_rs_tpu/ops/eig.py``. Two entry points:

- ``eig(a)`` runs ``torch.linalg.eig`` on the tensor's own device and
  returns complex tensors there. On CUDA it goes through cuSOLVER's
  ``geev`` and synchronises the host with the device, so callers use it
  between stages, never inside a loop of launches.
- ``eig_host(a)`` runs LAPACK on the host and returns numpy complex arrays
  (``complex64`` for f32 input, ``complex128`` for f64).

The fully on-device Francis-QR solver of ``ops.eig_device`` (real and
imaginary parts as real tensors, no complex dtype) is re-exported here:
``eig_device``, ``eigvals_device``, ``schur``.

``jittable_eig_supported(platform)`` answers the JAX package's question
for the port: whether ``eig`` returns complex results on that device
without the host route. torch has ``linalg.eig`` with complex outputs on
the CPU and on CUDA, so it is True for ``"cpu"`` and ``"cuda"`` and False
for any other device type.
"""
from __future__ import annotations

import numpy as np
import torch

from corrla_rs_tpu_torch.ops.eig_device import (  # noqa: F401 (re-exports)
    eig_device,
    eigvals_device,
    schur,
)
from corrla_rs_tpu_torch.utils.device import as_tensor, default_device

__all__ = [
    "eig", "eig_host", "jittable_eig_supported",
    "eig_device", "eigvals_device", "schur",
]

# device types on which torch.linalg.eig returns complex tensors itself
_EIG_DEVICE_TYPES = ("cpu", "cuda")


def jittable_eig_supported(platform: str | None = None) -> bool:
    """Whether ``eig`` returns complex results on ``platform`` (a device
    type; default: that of ``utils.device.default_device()``) without the
    host route."""
    platform = platform or default_device().type
    return platform in _EIG_DEVICE_TYPES


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
