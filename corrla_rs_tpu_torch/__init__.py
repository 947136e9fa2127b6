"""corrla_rs_tpu_torch: the PyTorch/CUDA port of corrla_rs_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module layout, public
names, signatures and return shapes. It imports ``torch`` and never ``jax``.
This first slice covers the randomized SVD core and the models built on it
plus RBF interpolation:

- ``rsvd(a, n_rank, n_iters, n_oversamples)``  -> (U, S (r, 1), Vt)
- ``rpca(a, n_rank, n_iters, n_oversamples)``  -> (S (r, 1), components)
- ``random_svd``, ``power_iter``
- classes ``PcaRsvd``, ``RbfInterp`` (= ``PyRbfInterp``), ``PodI``
  (= ``PyPodI``)

The two RBF steps run through hand-written CUDA kernels for sm_90a
(``csrc/rbf_kernels.cu``), built with ``nvcc`` on first use. Numpy inputs go
to ``utils.device.default_device()`` (``cuda``) unless a ``device`` is given;
TF32 is off. ``utils.convert`` carries fitted JAX state across.
"""

from corrla_rs_tpu_torch.api import rpca, rsvd
from corrla_rs_tpu_torch.models.pca import PcaRsvd
from corrla_rs_tpu_torch.models.pod import PodI
from corrla_rs_tpu_torch.ops.interp import RbfInterp
from corrla_rs_tpu_torch.ops.random_svd import power_iter, random_svd
from corrla_rs_tpu_torch.utils.debug import (
    NonFiniteError,
    debug_enabled,
    set_debug,
)

# Aliases matching the exact pyo3 class names (lib_math_utils_py.rs:179-283)
PyRbfInterp = RbfInterp
PyPodI = PodI

__version__ = "0.1.0"

__all__ = [
    "rsvd",
    "rpca",
    "random_svd",
    "power_iter",
    "PcaRsvd",
    "RbfInterp",
    "PodI",
    "PyRbfInterp",
    "PyPodI",
    "set_debug",
    "debug_enabled",
    "NonFiniteError",
]
