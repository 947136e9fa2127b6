"""corrla_rs_tpu_torch: the PyTorch/CUDA port of corrla_rs_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module layout, public
names, signatures and return shapes. It imports ``torch`` and never ``jax``.
It covers the reference's whole pyo3 surface:

- ``rsvd(a, n_rank, n_iters, n_oversamples)``  -> (U, S (r, 1), Vt)
- ``rpca(a, n_rank, n_iters, n_oversamples)``  -> (S (r, 1), components)
- ``active_ss(x, y, order, n_nbr, n_comps)``   -> (comps, vals, sensi)
- ``cs_dirichlet_sample(bounds, n_samples, max_zshots, chunk_size, c_scale,
  alphas)``
- ``cs_mcmc_dirichlet_sample(bounds, n_samples, n_seed_samples, max_zshots,
  chunk_size, c_scale, alphas, gamma, var_epsilon)`` -> (samples, accept_ratio)
- classes ``PcaRsvd``, ``RbfInterp`` (= ``PyRbfInterp``), ``PodI``
  (= ``PyPodI``), ``DMDc`` (``PyDMDc``), ``DMD``, the active-subspace
  classes and ``DeMcSampler``; ``random_svd``, ``power_iter``, ``eig``,
  ``eig_host``, ``dmdc_fit_ensemble``, ``rollout_ensemble``,
  ``constr_dirichlet_sample``

The two RBF steps, and the kNN distances of ``active_ss``, run through
hand-written CUDA kernels for sm_90a (``csrc/``), built with ``nvcc`` on
first use. Numpy inputs go to ``utils.device.default_device()`` (``cuda``)
unless a ``device`` is given; TF32 is off. ``utils.convert`` carries fitted
JAX state across.
"""

from corrla_rs_tpu_torch.api import (
    active_ss,
    cs_dirichlet_sample,
    cs_mcmc_dirichlet_sample,
    rpca,
    rsvd,
)
from corrla_rs_tpu_torch.models.active_subspaces import (
    ActiveSsRsvd,
    AdGradientEstimator,
    FittedActiveSsRsvd,
    PolyGradientEstimator,
)
from corrla_rs_tpu_torch.models.dmd import (
    DMD,
    DMDc,
    dmdc_fit_ensemble,
    rollout_ensemble,
)
from corrla_rs_tpu_torch.models.pca import PcaRsvd
from corrla_rs_tpu_torch.models.pod import PodI
from corrla_rs_tpu_torch.ops.eig import eig, eig_host
from corrla_rs_tpu_torch.ops.interp import RbfInterp
from corrla_rs_tpu_torch.ops.random_svd import power_iter, random_svd
from corrla_rs_tpu_torch.ops.samplers import (
    DeMcSampler,
    constr_dirichlet_sample,
)
from corrla_rs_tpu_torch.utils.debug import (
    NonFiniteError,
    debug_enabled,
    set_debug,
)

# Aliases matching the exact pyo3 class names (lib_math_utils_py.rs:179-283)
PyRbfInterp = RbfInterp
PyPodI = PodI


class PyDMDc(DMDc):
    """Binding-parity wrapper: the pyo3 PyDMDc's ``predict`` rolls the
    dynamics over a whole control sequence (it calls predict_multiple,
    lib_math_utils_py.rs:273-282). ``DMDc.predict`` keeps the single-step
    semantics (dmd_rom.rs:185-194)."""

    def predict(self, x_0, u_seq, method: str = "dense"):
        return self.predict_multiple(x_0, u_seq, method=method)


__version__ = "0.1.0"

__all__ = [
    "rsvd",
    "rpca",
    "active_ss",
    "cs_dirichlet_sample",
    "cs_mcmc_dirichlet_sample",
    "random_svd",
    "power_iter",
    "PcaRsvd",
    "PodI",
    "DMD",
    "DMDc",
    "RbfInterp",
    "ActiveSsRsvd",
    "FittedActiveSsRsvd",
    "PolyGradientEstimator",
    "AdGradientEstimator",
    "DeMcSampler",
    "constr_dirichlet_sample",
    "eig",
    "eig_host",
    "dmdc_fit_ensemble",
    "rollout_ensemble",
    "set_debug",
    "debug_enabled",
    "NonFiniteError",
    "PyRbfInterp",
    "PyPodI",
    "PyDMDc",
]
