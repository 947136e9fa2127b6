"""Carry fitted state from the JAX package into the port.

A fitted ``PcaRsvd``, ``RbfInterp``, ``PodI``, ``DMDc`` (or ``PyDMDc``),
``DMD``, ``FittedActiveSsRsvd``, ``GpRegressor``, ``SparseGpRegressor``,
``HankelDmd``, ``MrDmd``, ``PiDmd``, ``Era``, ``OnlineDmd``, ``Edmd``,
``KernelDmd``, ``Spod``, ``OpInf``, ``Sindy``, ``OptDmd``, ``BopDmd``,
``BaggedDmd``, ``PolynomialChaos``, ``Cca``, ``PlsRegressor``,
``GaussianCopula``, ``BivariateCopula``, ``CVineCopula`` or ``RVineCopula``
of ``corrla_rs_tpu``, and the running
state of an ``IncrementalSvd`` or
``IncrementalPca``, is a flat bag of arrays, lists of arrays and scalars,
and so is its port counterpart, attribute for attribute. A sampler's
``DreamState`` or ``EnsembleState`` (``state._asdict()``) crosses too, so a
JAX run can be resumed in the port: its JAX key does not cross, the port's
stream starts from the int ``key`` of the dict (default 0). So do a
``LaplaceResult`` (``result._asdict()``), a tensor train (``"tt_cores"``:
``{"cores": [...]}``, a list of tensors back) and a CP model
(``"cp_factors"``: ``{"weights": w, "factors": [...]}``, ``(weights,
factors)`` back). Two ways across, neither of which imports JAX:

- ``from_jax_state(class_name, state, device)`` takes the attributes
  (``vars(model)``, arrays as numpy or anything numpy can read);
- ``load_jax_checkpoint(path, device)`` reads the ``.npz`` that the JAX
  package's ``utils.checkpoint.save_model`` writes (``__class__``,
  ``__scalars__`` as JSON, ``arr_<name>`` arrays, ``lst_<name>_<i>`` lists
  of arrays); the port's ``utils.checkpoint.load_model`` reads it the same
  way.

Both return the port's object, which predicts what the JAX object predicts.
Real arrays go to ``device`` (default: ``utils.device.default_device()``)
with their dtype; complex arrays (DMD's ``lambdas`` and ``amplitudes``), and
the real ones a class keeps on the host (``_HOST_ARRAYS``: SPOD's
frequencies, the bagged fits' member statistics, a PCE's standardisation,
multi-indices and recurrences, CCA's canonical correlations), stay host
numpy arrays, as the port keeps
them. A mesh (``_mesh``, a JAX mesh or a ``DeviceMesh``) becomes None, and
a port model fitted with ``mesh=`` crosses too: its DTensor attributes are
gathered whole (``parallel.mesh._full``; every rank of the mesh calls), so the
result is a single-device model.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from corrla_rs_tpu_torch import PyDMDc
from corrla_rs_tpu_torch.models.active_subspaces import FittedActiveSsRsvd
from corrla_rs_tpu_torch.models.bop_dmd import BaggedDmd
from corrla_rs_tpu_torch.models.dmd import DMD, DMDc
from corrla_rs_tpu_torch.models.edmd import Edmd
from corrla_rs_tpu_torch.models.era import Era
from corrla_rs_tpu_torch.models.hankel_dmd import HankelDmd
from corrla_rs_tpu_torch.models.kernel_dmd import KernelDmd
from corrla_rs_tpu_torch.models.mrdmd import MrDmd
from corrla_rs_tpu_torch.models.online_dmd import OnlineDmd
from corrla_rs_tpu_torch.models.opinf import OpInf
from corrla_rs_tpu_torch.models.optdmd import BopDmd, OptDmd
from corrla_rs_tpu_torch.models.pca import PcaRsvd
from corrla_rs_tpu_torch.models.pidmd import PiDmd
from corrla_rs_tpu_torch.models.pod import PodI
from corrla_rs_tpu_torch.models.sindy import Sindy
from corrla_rs_tpu_torch.models.spod import Spod
from corrla_rs_tpu_torch.ops.cca import Cca
from corrla_rs_tpu_torch.ops.copula import BivariateCopula, GaussianCopula
from corrla_rs_tpu_torch.ops.dream import DreamState
from corrla_rs_tpu_torch.ops.ensemble_mcmc import EnsembleState
from corrla_rs_tpu_torch.ops.gmm import GmmFit
from corrla_rs_tpu_torch.ops.gp import GpRegressor, SparseGpRegressor
from corrla_rs_tpu_torch.ops.incremental import IncrementalPca, IncrementalSvd
from corrla_rs_tpu_torch.ops.interp import RbfInterp
from corrla_rs_tpu_torch.ops.laplace import LaplaceResult
from corrla_rs_tpu_torch.ops.pce import PolynomialChaos
from corrla_rs_tpu_torch.ops.pls import PlsRegressor
from corrla_rs_tpu_torch.ops.rvine import RVineCopula
from corrla_rs_tpu_torch.ops.vine import CVineCopula
from corrla_rs_tpu_torch.utils.device import _is_dtensor, default_device

__all__ = ["from_jax_state", "load_jax_checkpoint"]

_CLASSES = {"PcaRsvd": PcaRsvd, "RbfInterp": RbfInterp, "PodI": PodI,
            "DMDc": DMDc, "PyDMDc": PyDMDc, "DMD": DMD,
            "FittedActiveSsRsvd": FittedActiveSsRsvd,
            "IncrementalSvd": IncrementalSvd,
            "IncrementalPca": IncrementalPca, "GpRegressor": GpRegressor,
            "SparseGpRegressor": SparseGpRegressor, "HankelDmd": HankelDmd,
            "MrDmd": MrDmd, "PiDmd": PiDmd, "Era": Era,
            "OnlineDmd": OnlineDmd, "Edmd": Edmd, "KernelDmd": KernelDmd,
            "Spod": Spod, "OpInf": OpInf, "Sindy": Sindy, "OptDmd": OptDmd,
            "BopDmd": BopDmd, "BaggedDmd": BaggedDmd,
            "PolynomialChaos": PolynomialChaos, "Cca": Cca,
            "PlsRegressor": PlsRegressor, "GaussianCopula": GaussianCopula,
            "BivariateCopula": BivariateCopula, "CVineCopula": CVineCopula,
            "RVineCopula": RVineCopula}
_DMDC_STATE = ("n_x", "n_u", "_A", "_B", "_u_hat", "lambdas", "modes_re",
               "modes_im", "_w_re", "_w_im")
_DMD_STATE = ("n_x", "n_t", "_A", "_u_r", "lambdas", "amplitudes",
              "modes_re", "modes_im", "_w_re", "_w_im")
# fitted arrays each class needs to predict
_REQUIRED = {
    "PcaRsvd": ("means", "pca_s", "components_", "n_samples"),
    "RbfInterp": ("kernel", "eps", "rbf_dim", "poly_degree", "x_known",
                  "coeffs"),
    "PodI": ("modes", "t_abscissa", "_rbf_coeffs", "mode_weights"),
    "DMDc": _DMDC_STATE,
    "PyDMDc": _DMDC_STATE,
    "DMD": _DMD_STATE,
    "FittedActiveSsRsvd": ("components_", "singular_vals_", "n_comps"),
    "IncrementalSvd": ("rank", "track_v", "u", "s", "v", "n_cols"),
    "IncrementalPca": ("n_components", "components_", "singular_values_",
                       "mean_", "n_samples_seen_"),
    "GpRegressor": ("kernel", "length_scale", "signal_var", "noise_var",
                    "x_train", "_y_mean", "_yc", "_chol", "_alpha"),
    "SparseGpRegressor": ("kernel", "length_scale", "signal_var",
                          "noise_var", "x_ind", "_y_mean", "_y_scale",
                          "_l_mm", "_l_b", "_c"),
    "HankelDmd": _DMD_STATE + ("n_delays", "n_state", "_h_last"),
    "MrDmd": ("n_x", "n_t", "levels", "t0s", "t1s", "modes_re", "modes_im",
              "lam_re", "lam_im", "amp_re", "amp_im"),
    "PiDmd": ("family", "n_state", "n_modes", "lambdas"),
    "Era": ("order", "n_outputs", "n_inputs", "a", "b", "c", "hsv",
            "lambdas"),
    "OnlineDmd": ("n_state", "n_ctrl", "forgetting", "ridge", "_ab", "_p",
                  "n_seen"),
    "Edmd": ("n_state", "include_const", "_dict_kind", "koopman", "lambdas",
             "_w", "modes"),
    "KernelDmd": ("n_state", "kernel", "length_scale", "degree", "coef0",
                  "_x_train", "lambdas", "_qsv", "modes"),
    "Spod": ("n_blocks", "freqs", "energies", "modes_re", "modes_im"),
    "OpInf": ("n_modes", "n_control", "basis_", "c_", "a_", "h_", "b_"),
    "Sindy": ("discrete", "trig_freqs", "n_control", "coefficients_",
              "_exponents"),
    "OptDmd": ("alphas", "amplitudes", "modes_re", "modes_im"),
    "BopDmd": ("n_state", "alphas_all", "amps_all", "phis_all"),
    "BaggedDmd": ("n_state", "n_members", "lambdas_all", "modes_all_re",
                  "modes_all_im"),
    "PolynomialChaos": ("order", "dist", "_alpha", "coeffs"),
    "Cca": ("n_components", "corrs", "x_weights", "y_weights", "x_mean",
            "y_mean"),
    "PlsRegressor": ("n_components", "coef", "x_mean", "y_mean",
                     "x_weights"),
    "GaussianCopula": ("corr", "_marginals", "n", "d"),
    "BivariateCopula": ("fitted_family", "theta", "_marginals", "n"),
    "CVineCopula": ("var_order", "pairs", "_marginals", "n", "d"),
    "RVineCopula": ("levels_spec", "_marginals", "n", "d"),
}
# real arrays that a class keeps as host numpy arrays (the rest go to the
# device)
_HOST_ARRAYS = {
    "Spod": ("freqs",),
    "OptDmd": ("amplitudes",),
    "BopDmd": ("amplitudes", "amps_all", "alphas_std"),
    "BaggedDmd": ("modes_all_re", "modes_all_im", "lambdas_std",
                  "modes_std"),
    "PolynomialChaos": ("bounds", "_mean", "_std", "_alpha", "_rec_a",
                        "_rec_sb"),
    "Cca": ("corrs",),
}
_DREAM_FLOAT = ("heads", "head_lnp", "p_cr", "jump_dist", "n_id")
_DREAM_COUNT = ("n_accept", "t")
_ENSEMBLE_FLOAT = ("walkers", "lnp")
_ENSEMBLE_COUNT = ("n_accept", "n_reject")
_LAPLACE_ARRAYS = ("x_map", "cov", "chol_cov", "x_map_all")
_LAPLACE_SCALARS = (("log_evidence", float), ("ln_post_map", float),
                    ("converged", bool))
_GMM_ARRAYS = ("weights", "means", "covs", "log_likelihood",
               "responsibilities")
# states that are no class of fitted attributes, each made by its own function
_OTHER_STATES = ("DreamState", "EnsembleState", "LaplaceResult", "tt_cores",
                 "cp_factors", "GmmFit")
_MESH = "_mesh"   # a jax.sharding.Mesh or a DeviceMesh, or None


def _is_array(val) -> bool:
    return hasattr(val, "__array__") and hasattr(val, "shape")


def from_jax_state(class_name: str, state: dict, device=None):
    """Port object of ``class_name`` holding the JAX object's ``state``."""
    dev = torch.device(device) if device is not None else default_device()
    if class_name in _OTHER_STATES:
        return _MAKERS[class_name](state, dev)
    cls = _CLASSES.get(class_name)
    if cls is None:
        raise ValueError(f"no port of {class_name!r}; known: "
                         f"{sorted(_CLASSES) + list(_OTHER_STATES)}")
    missing = [k for k in _REQUIRED[class_name] if k not in state]
    if missing:
        raise ValueError(f"{class_name} state lacks {missing}")
    return _restore(cls, state, dev)


def _restore(cls, state: dict, device=None):
    """An object of ``cls`` holding ``state``, without ``__init__``: real
    arrays (and lists of them) become tensors on ``device`` (default
    ``utils.device.default_device()``), complex arrays and the class's
    ``_HOST_ARRAYS`` stay host numpy."""
    dev = torch.device(device) if device is not None else default_device()
    host = _HOST_ARRAYS.get(cls.__name__, ())

    def carry(val):
        if _is_dtensor(val):
            from corrla_rs_tpu_torch.parallel.mesh import _full

            val = _full(val)
        if isinstance(val, torch.Tensor):
            val = val.detach().cpu()
        val = np.array(val)
        return val if np.iscomplexobj(val) else torch.as_tensor(val,
                                                                device=dev)

    obj = cls.__new__(cls)
    for name, val in state.items():
        if name == _MESH:
            val = None
        if name in host and val is not None:
            val = np.array(val)
        elif _is_array(val):
            val = carry(val)
        elif isinstance(val, list) and val and all(map(_is_array, val)):
            val = [carry(v) for v in val]
        setattr(obj, name, val)
    obj._device = dev
    return obj


def _require(name: str, state: dict, keys) -> None:
    missing = [k for k in keys if k not in state]
    if missing:
        raise ValueError(f"{name} state lacks {missing}")


def _tensor(val, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(val), device=dev)


def _sampler_state(cls, floats, counts):
    """Maker of a sampler's state tuple: float arrays, int64 counters and
    a fresh generator from the dict's int ``key`` (a JAX key does not
    cross)."""
    def build(state: dict, dev):
        _require(cls.__name__, state, floats + counts)
        seed = state.get("key", 0)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed) if isinstance(seed, (int, np.integer))
                        else 0)
        fields = {k: _tensor(state[k], dev) for k in floats}
        fields.update({k: torch.as_tensor(int(np.array(state[k])),
                                          dtype=torch.int64, device=dev)
                       for k in counts})
        return cls(key=gen, **fields)
    return build


def _laplace_result(state: dict, dev) -> LaplaceResult:
    _require("LaplaceResult", state,
             _LAPLACE_ARRAYS + tuple(k for k, _ in _LAPLACE_SCALARS))
    fields = {k: _tensor(state[k], dev) for k in _LAPLACE_ARRAYS}
    fields.update({k: kind(np.array(state[k]))
                   for k, kind in _LAPLACE_SCALARS})
    return LaplaceResult(**fields)


def _tt_cores(state: dict, dev) -> list:
    _require("tt_cores", state, ("cores",))
    return [_tensor(g, dev) for g in state["cores"]]


def _cp_factors(state: dict, dev):
    _require("cp_factors", state, ("weights", "factors"))
    return (_tensor(state["weights"], dev),
            [_tensor(f, dev) for f in state["factors"]])


def _gmm_fit(state: dict, dev) -> GmmFit:
    _require("GmmFit", state, _GMM_ARRAYS + ("n_iter",))
    fields = {k: _tensor(state[k], dev) for k in _GMM_ARRAYS}
    return GmmFit(n_iter=torch.as_tensor(int(np.array(state["n_iter"])),
                                         device=dev),
                  cov_type=str(state.get("cov_type", "full")), **fields)


_MAKERS = {
    "DreamState": _sampler_state(DreamState, _DREAM_FLOAT, _DREAM_COUNT),
    "EnsembleState": _sampler_state(EnsembleState, _ENSEMBLE_FLOAT,
                                    _ENSEMBLE_COUNT),
    "LaplaceResult": _laplace_result,
    "tt_cores": _tt_cores,
    "cp_factors": _cp_factors,
    "GmmFit": _gmm_fit,
}


def _read_checkpoint(path):
    """(class name, attributes) of a ``save_model`` ``.npz``, arrays as
    numpy and lists of arrays as lists."""
    with np.load(path, allow_pickle=False) as data:
        class_name = str(data["__class__"])
        state, lengths = {}, {}
        for name, val in json.loads(str(data["__scalars__"])).items():
            if name.startswith("__len_"):
                lengths[name[len("__len_"):]] = int(val)
                continue
            if isinstance(val, dict) and "__dict__" in val:
                val = val["__dict__"]
            elif isinstance(val, dict) and "__json__" in val:
                val = val["__json__"]
            state[name] = val
        for key in data.files:
            if key.startswith("arr_"):
                state[key[len("arr_"):]] = data[key]
        for name, n in lengths.items():
            state[name] = [data[f"lst_{name}_{i}"] for i in range(n)]
    return class_name, state


def load_jax_checkpoint(path, device=None):
    """Port object from an ``.npz`` written by the JAX ``save_model``."""
    return from_jax_state(*_read_checkpoint(path), device)
