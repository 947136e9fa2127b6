"""corrla_rs_tpu_torch: the PyTorch/CUDA port of ``corrla_rs_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, with the same module layout, public
names, signatures and return shapes. It imports ``torch`` and never ``jax``.
It covers the reference's whole pyo3 surface, and of what the JAX package
adds to it the rest of the randomized SVD core (``block_krylov_svd``,
``single_pass_svd``), the DREAM sampler with the MCMC diagnostics, the
MLE / univariate-RV layer, the factorizations on the RSVD core (Nystrom,
rank selection, trace and log-det estimators, sketched least squares, CG,
ID/CUR, HOSVD, incremental SVD/PCA, robust PCA, tensor train, CP, NMF,
matrix completion), the inference layer (stretch, HMC, NUTS and tempered
SMC samplers; Kalman, ensemble, particle and unscented filters; Laplace,
bridge-sampling and PSIS evidence estimators), Gaussian processes and
Bayesian optimisation with the space-filling designs, Grassmann
interpolation, the ROM models on the DMD core (Hankel, multi-resolution,
physics-informed and online DMD, ERA/OKID, DEIM, gappy POD, sparsity-
promoting DMD, EDMD, kernel DMD, SPOD, operator inference, SINDy,
optimized, BOP and bagged DMD), the checkpoints, and the
sensitivity and UQ estimators (quadrature, polynomial chaos, Sobol',
Morris, Shapley, multilevel and multi-fidelity Monte Carlo):

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
  ``eig_host``, ``eig_device``/``eigvals_device``/``schur`` (a Francis QR
  on the tensor's device), ``dmdc_fit_ensemble``, ``rollout_ensemble``,
  ``constr_dirichlet_sample``

The two RBF steps, the kNN distances of ``active_ss`` and the GPs'
distances (``ops.interp.pairwise_dists``, differentiable) run through
hand-written CUDA kernels for sm_90a (``csrc/``), built with ``nvcc`` on
first use; they are also ``torch.library`` operators, so methods that reach
them export with ``utils.export``. Numpy inputs go to
``utils.device.default_device()`` (``cuda``)
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
from corrla_rs_tpu_torch.models.bop_dmd import BaggedDmd, bagged_dmd
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
from corrla_rs_tpu_torch.models.edmd import Edmd
from corrla_rs_tpu_torch.models.era import Era, era, era_okid, okid
from corrla_rs_tpu_torch.models.hankel_dmd import HankelDmd, hankel_embed
from corrla_rs_tpu_torch.models.kernel_dmd import KernelDmd
from corrla_rs_tpu_torch.models.mrdmd import MrDmd, mrdmd
from corrla_rs_tpu_torch.models.online_dmd import OnlineDmd
from corrla_rs_tpu_torch.models.opinf import OpInf, kron2_compressed
from corrla_rs_tpu_torch.models.optdmd import BopDmd, OptDmd, bop_dmd
from corrla_rs_tpu_torch.models.pca import PcaRsvd
from corrla_rs_tpu_torch.models.pidmd import PiDmd
from corrla_rs_tpu_torch.models.pod import PodI
from corrla_rs_tpu_torch.models.sindy import Sindy
from corrla_rs_tpu_torch.models.spod import Spod, spod
from corrla_rs_tpu_torch.ops.bayes_opt import BayesOpt, bayes_opt_minimize
from corrla_rs_tpu_torch.ops.bridge import bridge_sampling_evidence
from corrla_rs_tpu_torch.ops.cca import Cca, cca
from corrla_rs_tpu_torch.ops.cg import (
    cg_solve,
    jacobi_preconditioner,
    nystrom_preconditioner,
)
from corrla_rs_tpu_torch.ops.cma import CmaResult, cma_es
from corrla_rs_tpu_torch.ops.completion import matrix_complete
from corrla_rs_tpu_torch.ops.copula import BivariateCopula, GaussianCopula
from corrla_rs_tpu_torch.ops.cp import cp_als, cp_reconstruct
from corrla_rs_tpu_torch.ops.deim import deim_points, deim_reconstruct
from corrla_rs_tpu_torch.ops.design import (
    halton_sample,
    latin_hypercube,
    sobol_sample,
)
from corrla_rs_tpu_torch.ops.diagnostics import (
    effective_sample_size,
    gelman_rubin,
    rank_normalized_rhat,
)
from corrla_rs_tpu_torch.ops.dream import DreamSampler, dream_run
from corrla_rs_tpu_torch.ops.eig import eig, eig_host
from corrla_rs_tpu_torch.ops.eig_device import eig_device, eigvals_device, schur
from corrla_rs_tpu_torch.ops.enkf import (
    enkf_analysis,
    enkf_filter,
    esmda,
    etkf_analysis,
)
from corrla_rs_tpu_torch.ops.ensemble_mcmc import EnsembleSampler, stretch_run
from corrla_rs_tpu_torch.ops.gappy import (
    gappy_pod_fill,
    gappy_reconstruct,
    oversample_points,
)
from corrla_rs_tpu_torch.ops.gmm import (
    GmmFit,
    gmm_fit,
    gmm_logpdf,
    gmm_sample,
    gmm_select,
)
from corrla_rs_tpu_torch.ops.gp import GpRegressor, SparseGpRegressor
from corrla_rs_tpu_torch.ops.grassmann import (
    GrassmannInterp,
    grassmann_distance,
    grassmann_exp,
    grassmann_log,
    subspace_angles,
)
from corrla_rs_tpu_torch.ops.hmc import hmc_run
from corrla_rs_tpu_torch.ops.hosvd import (
    hooi,
    hosvd,
    mode_multiply,
    tucker_reconstruct,
)
from corrla_rs_tpu_torch.ops.id_cur import column_id, cur, row_id
from corrla_rs_tpu_torch.ops.incremental import IncrementalPca, IncrementalSvd
from corrla_rs_tpu_torch.ops.interp import RbfInterp
from corrla_rs_tpu_torch.ops.kalman import (
    dare,
    dlqr,
    kalman_filter,
    kalman_smooth,
)
from corrla_rs_tpu_torch.ops.laplace import laplace_approx, laplace_sample
from corrla_rs_tpu_torch.ops.mlmc import mlmc_estimate
from corrla_rs_tpu_torch.ops.morris import (
    morris_screening,
    morris_trajectories,
)
from corrla_rs_tpu_torch.ops.multifidelity import (
    control_variate_estimate,
    mfmc_design,
    mfmc_estimate,
)
from corrla_rs_tpu_torch.ops.nmf import nmf
from corrla_rs_tpu_torch.ops.nuts import nuts_run
from corrla_rs_tpu_torch.ops.nystrom import nystrom_approx, nystrom_eigh
from corrla_rs_tpu_torch.ops.particle import particle_filter, ukf_filter
from corrla_rs_tpu_torch.ops.pce import PolynomialChaos
from corrla_rs_tpu_torch.ops.pls import PlsRegressor, pls_fit
from corrla_rs_tpu_torch.ops.psis import importance_resample, psis
from corrla_rs_tpu_torch.ops.quadrature import (
    clenshaw_curtis,
    gauss_hermite,
    gauss_legendre,
    integrate,
    smolyak_quadrature,
    tensor_quadrature,
)
from corrla_rs_tpu_torch.ops.random_svd import (
    block_krylov_svd,
    power_iter,
    random_svd,
    single_pass_svd,
)
from corrla_rs_tpu_torch.ops.rank_select import (
    adaptive_random_svd,
    range_error_estimate,
    select_rank,
    svht_threshold,
)
from corrla_rs_tpu_torch.ops.robust_pca import robust_pca
from corrla_rs_tpu_torch.ops.rvine import RVineCopula
from corrla_rs_tpu_torch.ops.samplers import (
    DeMcSampler,
    constr_dirichlet_sample,
)
from corrla_rs_tpu_torch.ops.shapley import (
    shapley_effects,
    shapley_effects_linear,
    shapley_effects_quadrature,
)
from corrla_rs_tpu_torch.ops.sketch_solve import sketched_lstsq
from corrla_rs_tpu_torch.ops.slq import (
    lanczos_fn_apply,
    lanczos_tridiag,
    slq_logdet,
    slq_spectral_sum,
)
from corrla_rs_tpu_torch.ops.smc import smc_sample
from corrla_rs_tpu_torch.ops.sobol import saltelli_plan, sobol_indices
from corrla_rs_tpu_torch.ops.spdmd import spdmd
from corrla_rs_tpu_torch.ops.streaming import (
    RowBlockSource,
    streamed_cov,
    streamed_dmdc,
    streamed_hosvd,
    streamed_pca,
    streamed_pearson_corr,
    streamed_pod,
    streamed_random_svd,
    streamed_single_pass_svd,
)
from corrla_rs_tpu_torch.ops.trace_est import hutchinson_trace, hutchpp_trace
from corrla_rs_tpu_torch.ops.tt import (
    tt_dot,
    tt_norm,
    tt_reconstruct,
    tt_round,
    tt_svd,
)
from corrla_rs_tpu_torch.ops.vine import CVineCopula
from corrla_rs_tpu_torch.ops.univariate_rv import (
    BetaRv,
    ExponentialRv,
    KdeRv,
    NormalRv,
    build_kde,
)
from corrla_rs_tpu_torch.utils.checkpoint import load_model, save_model
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
    "eig_device",
    "eigvals_device",
    "schur",
    "dmdc_fit_ensemble",
    "rollout_ensemble",
    "set_debug",
    "debug_enabled",
    "NonFiniteError",
    "PyRbfInterp",
    "PyPodI",
    "PyDMDc",
    "block_krylov_svd",
    "single_pass_svd",
    "DreamSampler",
    "dream_run",
    "gelman_rubin",
    "effective_sample_size",
    "rank_normalized_rhat",
    "NormalRv",
    "BetaRv",
    "ExponentialRv",
    "KdeRv",
    "build_kde",
    "nystrom_eigh",
    "nystrom_approx",
    "svht_threshold",
    "select_rank",
    "range_error_estimate",
    "adaptive_random_svd",
    "hutchinson_trace",
    "hutchpp_trace",
    "sketched_lstsq",
    "cg_solve",
    "jacobi_preconditioner",
    "nystrom_preconditioner",
    "slq_spectral_sum",
    "slq_logdet",
    "lanczos_tridiag",
    "lanczos_fn_apply",
    "column_id",
    "row_id",
    "cur",
    "hosvd",
    "hooi",
    "tucker_reconstruct",
    "mode_multiply",
    "IncrementalSvd",
    "IncrementalPca",
    "robust_pca",
    "tt_svd",
    "tt_reconstruct",
    "tt_round",
    "tt_dot",
    "tt_norm",
    "cp_als",
    "cp_reconstruct",
    "nmf",
    "matrix_complete",
    "EnsembleSampler",
    "stretch_run",
    "hmc_run",
    "nuts_run",
    "smc_sample",
    "dare",
    "dlqr",
    "kalman_filter",
    "kalman_smooth",
    "enkf_analysis",
    "etkf_analysis",
    "enkf_filter",
    "esmda",
    "particle_filter",
    "ukf_filter",
    "laplace_approx",
    "laplace_sample",
    "bridge_sampling_evidence",
    "psis",
    "importance_resample",
    "GpRegressor",
    "SparseGpRegressor",
    "latin_hypercube",
    "sobol_sample",
    "halton_sample",
    "BayesOpt",
    "bayes_opt_minimize",
    "GrassmannInterp",
    "grassmann_log",
    "grassmann_exp",
    "subspace_angles",
    "grassmann_distance",
    "HankelDmd",
    "hankel_embed",
    "MrDmd",
    "mrdmd",
    "PiDmd",
    "Era",
    "era",
    "okid",
    "era_okid",
    "OnlineDmd",
    "deim_points",
    "deim_reconstruct",
    "gappy_reconstruct",
    "gappy_pod_fill",
    "oversample_points",
    "spdmd",
    "save_model",
    "load_model",
    "Edmd",
    "KernelDmd",
    "Spod",
    "spod",
    "OpInf",
    "kron2_compressed",
    "Sindy",
    "OptDmd",
    "BopDmd",
    "bop_dmd",
    "BaggedDmd",
    "bagged_dmd",
    "gauss_legendre",
    "gauss_hermite",
    "clenshaw_curtis",
    "tensor_quadrature",
    "smolyak_quadrature",
    "integrate",
    "PolynomialChaos",
    "saltelli_plan",
    "sobol_indices",
    "morris_trajectories",
    "morris_screening",
    "shapley_effects",
    "shapley_effects_linear",
    "shapley_effects_quadrature",
    "mlmc_estimate",
    "mfmc_design",
    "mfmc_estimate",
    "control_variate_estimate",
    "RowBlockSource",
    "streamed_random_svd",
    "streamed_single_pass_svd",
    "streamed_pca",
    "streamed_pod",
    "streamed_dmdc",
    "streamed_cov",
    "streamed_pearson_corr",
    "streamed_hosvd",
    "GmmFit",
    "gmm_fit",
    "gmm_logpdf",
    "gmm_sample",
    "gmm_select",
    "cma_es",
    "Cca",
    "cca",
    "PlsRegressor",
    "pls_fit",
    "GaussianCopula",
    "BivariateCopula",
    "CVineCopula",
    "RVineCopula",
]
