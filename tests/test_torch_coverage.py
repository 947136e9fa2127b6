"""The port's progress meter: every public name of corrla_rs_tpu has a
counterpart in corrla_rs_tpu_torch or sits in NOT_PORTED with the ROADMAP
queue item (or the ROADMAP "Leave out" entry) that covers it.

Public names are ``corrla_rs_tpu.__all__`` plus each module's ``__all__``.
A counterpart is the same name in the port's module of the same path (or
in the port's top level, for a top-level name), or the entry of
COUNTERPARTS. A NOT_PORTED key is a module path, which covers all of its
names, or ``module.name``; a top-level name is covered by the key of the
module that defines it. No key may name something the port has.
"""
import importlib
import inspect
import os
import pkgutil
import re

import pytest
import torch

import corrla_rs_tpu as crt
import corrla_rs_tpu_torch as port

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX name -> the port's name of the same function
COUNTERPARTS = {
    "ops.pallas_kernels.pairwise_kernel_matrix":
        "ops.rbf_kernels.pairwise_kernel_matrix",
    "ops.pallas_kernels.rbf_matvec_streaming": "ops.rbf_kernels.rbf_matvec",
}

_LEAVE_OUT = "ROADMAP Leave out"
NOT_PORTED = {
    # queue 1 item 7: eager torch has no traced calls to probe for, and the
    # Francis-QR solver waits for a measured need on the card
    "ops.eig.jittable_eig_supported":
        "queue 1 item 7 (no meaning in eager torch)",
    "ops.eig.eig_device": "queue 1 item 7 (only on a measured H100 need)",
    "ops.eig.eigvals_device": "queue 1 item 7 (only on a measured H100 need)",
    "ops.eig.schur": "queue 1 item 7 (only on a measured H100 need)",
    "ops.eig_device": "queue 1 item 7 (only on a measured H100 need)",
    # queue 1 item 11: the facade's own checkpoints
    "utils.checkpoint": "queue 1 item 11",
    # queue 1 item 12: the port's bench and its tracing
    "utils.tracing": "queue 1 item 12",
    # queue 1 item 13: samplers beyond the reference
    **{f"ops.{m}": "queue 1 item 13" for m in (
        "ensemble_mcmc", "hmc", "nuts", "smc", "particle", "enkf", "kalman",
        "laplace", "bridge", "psis")},
    # queue 1 item 14: factorizations on the RSVD core
    **{f"ops.{m}": "queue 1 item 14" for m in (
        "tt", "cp", "nmf", "completion")},
    # queue 1 item 15: ROM models
    **{f"models.{m}": "queue 1 item 15" for m in (
        "edmd", "kernel_dmd", "hankel_dmd", "mrdmd", "optdmd", "bop_dmd",
        "online_dmd", "pidmd", "spod", "era", "opinf", "sindy")},
    **{f"ops.{m}": "queue 1 item 15" for m in (
        "deim", "gappy", "grassmann", "spdmd")},
    # queue 1 item 16: UQ / statistics
    **{f"ops.{m}": "queue 1 item 16" for m in (
        "gp", "bayes_opt", "pce", "quadrature", "sobol", "morris", "design",
        "shapley", "mlmc", "multifidelity", "copula", "vine", "rvine", "gmm",
        "cma", "cca", "pls")},
    # queue 1 items 17-19
    "ops.streaming": "queue 1 item 17",
    "parallel.mesh": "queue 1 item 18",
    "parallel.sharded_rsvd": "queue 1 item 18",
    "parallel.sharded_hosvd": "queue 1 item 18",
    "parallel.sharded_samplers": "queue 1 item 18",
    "utils.export": "queue 1 item 19",
    # what only the TPU needed
    "utils.cache": _LEAVE_OUT,
    "utils.smallpath": _LEAVE_OUT,
    "utils.debug.checkified": _LEAVE_OUT,
}


def _jax_modules():
    for info in pkgutil.walk_packages(crt.__path__, "corrla_rs_tpu."):
        yield info.name[len("corrla_rs_tpu."):], importlib.import_module(
            info.name)


def _port_module(rel):
    try:
        return importlib.import_module(f"corrla_rs_tpu_torch.{rel}")
    except ModuleNotFoundError:
        return None


def _ported(rel, name):
    target = COUNTERPARTS.get(f"{rel}.{name}")
    if target is not None:
        rel, name = target.rsplit(".", 1)
    mod = _port_module(rel)
    return mod is not None and hasattr(mod, name)


def _listed(rel, name):
    return f"{rel}.{name}" in NOT_PORTED or rel in NOT_PORTED


def _public_names():
    """(module path, name) of every public JAX name; "" is the top level."""
    names = [("", n) for n in crt.__all__]
    for rel, mod in _jax_modules():
        names += [(rel, n) for n in getattr(mod, "__all__", ())]
    return names


def test_every_public_name_is_ported_or_listed():
    missing = []
    for rel, name in _public_names():
        if rel == "":
            if hasattr(port, name):
                continue
            obj = getattr(crt, name)
            defining = obj.__module__[len("corrla_rs_tpu."):]
            ok = _listed(defining, name)
        else:
            ok = _ported(rel, name) or _listed(rel, name)
        if not ok:
            missing.append(f"{rel or '<top>'}: {name}")
    assert not missing, missing


def test_not_ported_names_nothing_the_port_has():
    jax_modules = dict(_jax_modules())
    for key in NOT_PORTED:
        if key in jax_modules:
            assert _port_module(key) is None, f"{key} is listed but ported"
            continue
        rel, _, name = key.rpartition(".")
        assert name in getattr(jax_modules[rel], "__all__", ()), key
        assert not _ported(rel, name), f"{key} is listed but ported"


def test_not_ported_items_exist_in_the_roadmap():
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        roadmap = f.read()
    queue1 = roadmap.split("### Queue 1")[1].split("### Queue 2")[0]
    items = {int(m) for m in re.findall(r"^(\d+)\. \*\*", queue1, re.M)}
    assert "**Leave out" in roadmap
    for key, where in NOT_PORTED.items():
        if where == _LEAVE_OUT:
            continue
        m = re.match(r"queue 1 item (\d+)", where)
        assert m and int(m.group(1)) in items, (key, where)


def test_this_slice_is_ported():
    # the reference's whole pyo3 surface and the slice's modules
    for name in ("active_ss", "cs_dirichlet_sample", "cs_mcmc_dirichlet_sample",
                 "DMDc", "PyDMDc", "DMD", "dmdc_fit_ensemble",
                 "rollout_ensemble", "ActiveSsRsvd", "FittedActiveSsRsvd",
                 "PolyGradientEstimator", "AdGradientEstimator",
                 "DeMcSampler", "constr_dirichlet_sample", "eig", "eig_host",
                 *SLICE_NAMES):
        assert hasattr(port, name) and name in port.__all__, name
    for rel in ("ops.knn", "ops.samplers", "ops.stats_corr", "ops.mat_utils",
                "models.dmd", "models.active_subspaces", *SLICE_MODULES):
        assert not any(k == rel or k.startswith(rel + ".")
                       for k in NOT_PORTED), rel
        assert _port_module(rel) is not None, rel


# the slice of the single-pass and Krylov SVDs, DREAM, the MLE layer and
# the first factorizations on the RSVD core
SLICE_MODULES = (
    "ops.random_svd", "utils.log", "ops.optimize", "ops.univariate_rv",
    "ops.dream", "ops.diagnostics", "ops.nystrom", "ops.rank_select",
    "ops.trace_est", "ops.sketch_solve", "ops.cg", "ops.slq", "ops.id_cur",
    "ops.hosvd", "ops.incremental", "ops.robust_pca",
)
SLICE_NAMES = (
    "block_krylov_svd", "single_pass_svd", "DreamSampler", "dream_run",
    "gelman_rubin", "effective_sample_size", "rank_normalized_rhat",
    "NormalRv", "BetaRv", "ExponentialRv", "KdeRv", "build_kde",
    "nystrom_eigh", "nystrom_approx", "svht_threshold", "select_rank",
    "range_error_estimate", "adaptive_random_svd", "hutchinson_trace",
    "hutchpp_trace", "sketched_lstsq", "cg_solve", "jacobi_preconditioner",
    "nystrom_preconditioner", "slq_spectral_sum", "slq_logdet",
    "lanczos_tridiag", "lanczos_fn_apply", "column_id", "row_id", "cur",
    "hosvd", "hooi", "tucker_reconstruct", "mode_multiply", "IncrementalSvd",
    "IncrementalPca", "robust_pca",
)
# a matmul precision is XLA's to choose; here TF32 is off once, for all
JAX_ONLY_PARAMS = {"precision", "power_precision"}
# each package's logger lives under its own name
OWN_DEFAULTS = {("utils.log", "get_logger", "name"): "corrla_rs_tpu_torch"}


def _callables(rel):
    """(name, JAX callable, port callable) of a module's public functions,
    and of its public classes' constructors and public methods."""
    jmod = importlib.import_module(f"corrla_rs_tpu.{rel}")
    pmod = _port_module(rel)
    for name in jmod.__all__:
        jobj, pobj = getattr(jmod, name), getattr(pmod, name)
        if not inspect.isclass(jobj):
            yield name, jobj, pobj
            continue
        if "__init__" in vars(jobj):
            yield f"{name}.__init__", jobj.__init__, pobj.__init__
        for meth, jfn in vars(jobj).items():
            if inspect.isfunction(jfn) and not meth.startswith("_"):
                yield f"{name}.{meth}", jfn, getattr(pobj, meth)


def _params(fn):
    """[(name, default)] of a function's parameters; a jitted function is
    read through its wrapped one."""
    fn = getattr(fn, "__wrapped__", fn)
    return [(p.name, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_slice_signatures_equal_the_jax_package(rel):
    # parameter names, order and defaults (``unroll`` and ``mesh`` kept for
    # the signature's sake), the matmul precisions apart
    n_checked = 0
    for name, jfn, pfn in _callables(rel):
        want = [(p, OWN_DEFAULTS.get((rel, name, p), default))
                for p, default in _params(jfn) if p not in JAX_ONLY_PARAMS]
        assert _params(pfn) == want, f"{rel}.{name}"
        n_checked += 1
    assert n_checked >= 1
    jmod = importlib.import_module(f"corrla_rs_tpu.{rel}")
    assert set(jmod.__all__) <= set(_port_module(rel).__all__), rel
