"""The port's progress meter: every public name of corrla_rs_tpu has a
counterpart in corrla_rs_tpu_torch or sits in NOT_PORTED with the ROADMAP
queue item (or the ROADMAP "Leave out" entry) that covers it.

Public names are ``corrla_rs_tpu.__all__`` plus each module's ``__all__``;
a module without ``__all__`` contributes the public functions and classes
it defines itself (no leading underscore). A counterpart is the same name
in the port's module of the same path (or in the port's top level, for a
top-level name), or the entry of COUNTERPARTS. A NOT_PORTED key is a module path, which covers all of its
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
    # a JAX key becomes a torch.Generator
    "utils.prng.as_key": "utils.prng.as_generator",
    "utils.prng.split_key": "utils.prng.split_seed",
}

_LEAVE_OUT = "ROADMAP Leave out"
NOT_PORTED = {
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
        names += [(rel, n) for n in _public(mod)]
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
        assert name in _public(jax_modules[rel]), key
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


# the slices of Gaussian processes and Bayesian optimisation, Grassmann
# interpolation, the ROM models on the DMD core and the checkpoints; then
# the Koopman/DMD-family ROM models and the sensitivity/UQ estimators;
# then out-of-core streaming, the rest of the statistics layer and the
# test helpers; then the multi-device layer and the export; then the
# Francis-QR eigensolver and the tracing helpers
SLICE_MODULES = (
    "ops.gp", "ops.design", "ops.bayes_opt", "ops.grassmann", "ops.deim",
    "ops.gappy", "ops.spdmd", "models.hankel_dmd", "models.mrdmd",
    "models.pidmd", "models.era", "models.online_dmd", "utils.checkpoint",
    "models.edmd", "models.kernel_dmd", "models.spod", "models.opinf",
    "models.sindy", "models.optdmd", "models.bop_dmd", "ops.quadrature",
    "ops.pce", "ops.sobol", "ops.morris", "ops.shapley", "ops.mlmc",
    "ops.multifidelity", "ops.streaming", "ops.gmm", "ops.cma", "ops.cca",
    "ops.pls", "ops.copula", "ops.vine", "ops.rvine", "utils.testing",
    "parallel.mesh", "parallel.sharded_rsvd", "parallel.sharded_hosvd",
    "parallel.sharded_samplers", "utils.export", "ops.eig_device",
    "utils.tracing",
)
SLICE_NAMES = (
    "GpRegressor", "SparseGpRegressor", "latin_hypercube", "sobol_sample",
    "halton_sample", "BayesOpt", "bayes_opt_minimize", "GrassmannInterp",
    "grassmann_log", "grassmann_exp", "subspace_angles",
    "grassmann_distance", "HankelDmd", "hankel_embed", "MrDmd", "mrdmd",
    "PiDmd", "Era", "era", "okid", "era_okid", "OnlineDmd", "deim_points",
    "deim_reconstruct", "gappy_reconstruct", "gappy_pod_fill",
    "oversample_points", "spdmd", "save_model", "load_model",
    "Edmd", "KernelDmd", "Spod", "spod", "OpInf", "kron2_compressed",
    "Sindy", "OptDmd", "BopDmd", "bop_dmd", "BaggedDmd", "bagged_dmd",
    "gauss_legendre", "gauss_hermite", "clenshaw_curtis",
    "tensor_quadrature", "smolyak_quadrature", "integrate",
    "PolynomialChaos", "saltelli_plan", "sobol_indices",
    "morris_trajectories", "morris_screening", "shapley_effects",
    "shapley_effects_linear", "shapley_effects_quadrature",
    "mlmc_estimate", "mfmc_design", "mfmc_estimate",
    "control_variate_estimate",
    "RowBlockSource", "streamed_random_svd", "streamed_single_pass_svd",
    "streamed_pca", "streamed_pod", "streamed_dmdc", "streamed_cov",
    "streamed_pearson_corr", "streamed_hosvd", "GmmFit", "gmm_fit",
    "gmm_logpdf", "gmm_sample", "gmm_select", "cma_es", "Cca", "cca",
    "PlsRegressor", "pls_fit", "GaussianCopula", "BivariateCopula",
    "CVineCopula", "RVineCopula", "eig_device", "eigvals_device", "schur",
)
# a matmul precision is XLA's to choose; here TF32 is off once, for all
JAX_ONLY_PARAMS = {"precision", "power_precision"}
# each package's logger lives under its own name
OWN_DEFAULTS = {("utils.log", "get_logger", "name"): "corrla_rs_tpu_torch"}
# (module, callable) whose parameters differ from the JAX package's by
# design, with the reason (ROADMAP "Differences by design")
OWN_SIGNATURES = {
    ("parallel.sharded_rsvd", "sharded_power_iter_qr"):
        "the body of a sharded call takes its mesh: JAX finds it inside "
        "shard_map, torch has no ambient mesh",
}
# ported modules that share no public callable with the JAX module, with
# the reason: the signature walk has nothing to compare there
NO_SHARED_CALLABLES = {
    "utils.prng": "a JAX key becomes a torch.Generator: as_generator, "
                  "split_seed and fold_seed stand where as_key and split_key "
                  "do",
}
# every port entry point may end in one extra parameter of these
# (make_mesh and make_mesh_2d take the mesh's device type)
PORT_ONLY_TRAILING = ("device", "device_type")


def _public(mod):
    """A module's public names: ``__all__``, or, without one, the public
    functions and classes the module itself defines."""
    names = getattr(mod, "__all__", None)
    if names is not None:
        return list(names)
    return [n for n, obj in vars(mod).items()
            if not n.startswith("_")
            and (inspect.isfunction(obj) or inspect.isclass(obj))
            and getattr(obj, "__module__", None) == mod.__name__]


def _pairs(jobj, pobj, name):
    """(name, JAX callable, port callable) of a function, or of a class's
    constructor and public methods."""
    if not inspect.isclass(jobj):
        yield name, jobj, pobj
        return
    if "__init__" in vars(jobj):
        yield f"{name}.__init__", jobj.__init__, pobj.__init__
    for meth, jfn in vars(jobj).items():
        if inspect.isfunction(jfn) and not meth.startswith("_"):
            yield f"{name}.{meth}", jfn, getattr(pobj, meth)


def _callables(rel):
    """The callables to compare of module ``rel`` ("" is the top level):
    every public name that both packages have."""
    if rel == "":
        jmod, pmod = crt, port
    else:
        jmod = importlib.import_module(f"corrla_rs_tpu.{rel}")
        pmod = _port_module(rel)
    for name in _public(jmod):
        jobj, pobj = getattr(jmod, name), getattr(pmod, name, None)
        if pobj is None or not callable(jobj):
            continue      # unported names are the coverage test's business
        yield from _pairs(jobj, pobj, name)


def _params(fn):
    """[(name, default)] of a function's parameters; a jitted function is
    read through its wrapped one."""
    fn = getattr(fn, "__wrapped__", fn)
    return [(p.name, p.default)
            for p in inspect.signature(fn).parameters.values()]


def _same_default(a, b):
    if a is b:
        return True
    try:
        return bool(a == b)
    except Exception:
        return False


PORTED_MODULES = [""] + sorted(
    rel for rel, mod in _jax_modules()
    if not hasattr(mod, "__path__") and _port_module(rel) is not None)


@pytest.mark.parametrize("rel", PORTED_MODULES)
def test_slice_signatures_equal_the_jax_package(rel):
    # parameter names, order and defaults (``unroll`` and ``mesh`` kept for
    # the signature's sake) of every ported module and of the top level;
    # the matmul precisions apart, and one trailing ``device=`` allowed
    n_checked = 0
    for name, jfn, pfn in _callables(rel):
        if (rel, name) in OWN_SIGNATURES:
            continue
        n_checked += 1
        got = _params(pfn)
        # a matmul precision is dropped; a parameter of that name the port
        # has too (Sindy.equations' print precision) is compared
        kept = {p for p, _ in got}
        want = [(p, OWN_DEFAULTS.get((rel, name, p), default))
                for p, default in _params(jfn)
                if p not in JAX_ONLY_PARAMS or p in kept]
        if len(got) == len(want) + 1 and got[-1][0] in PORT_ONLY_TRAILING:
            got = got[:-1]
        assert [p for p, _ in got] == [p for p, _ in want], f"{rel}.{name}"
        for (p, dg), (_, dw) in zip(got, want):
            assert _same_default(dg, dw), f"{rel}.{name}({p}=)"
    # a ported module whose callables all went unmatched must not pass empty
    assert (n_checked == 0) == (rel in NO_SHARED_CALLABLES), (rel, n_checked)
    if rel:
        jmod = importlib.import_module(f"corrla_rs_tpu.{rel}")
        if hasattr(jmod, "__all__"):
            assert set(jmod.__all__) - {
                n for n in jmod.__all__ if _listed(rel, n)} <= set(
                    _port_module(rel).__all__), rel


def test_own_signatures_name_real_callables():
    for rel, name in OWN_SIGNATURES:
        assert name in {n for n, _, _ in _callables(rel)}, (rel, name)
