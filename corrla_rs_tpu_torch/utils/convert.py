"""Carry fitted state from the JAX package into the port.

A fitted ``PcaRsvd``, ``RbfInterp``, ``PodI``, ``DMDc`` (or ``PyDMDc``),
``DMD`` or ``FittedActiveSsRsvd`` of ``corrla_rs_tpu``, and the running state
of an ``IncrementalSvd`` or ``IncrementalPca``, is a flat bag of arrays and
scalars, and so is its port counterpart, attribute for attribute. A sampler's
``DreamState`` (``state._asdict()``) crosses too, so a JAX run can be resumed
in the port: its JAX key does not cross, the port's stream starts from the
int ``key`` of the dict (default 0). Two ways across, neither of which imports JAX:

- ``from_jax_state(class_name, state, device)`` takes the attributes
  (``vars(model)``, arrays as numpy or anything numpy can read);
- ``load_jax_checkpoint(path, device)`` reads the ``.npz`` that the JAX
  package's ``utils.checkpoint.save_model`` writes (``__class__``,
  ``__scalars__`` as JSON, ``arr_<name>`` arrays).

Both return the port's object, which predicts what the JAX object predicts.
Real arrays go to ``device`` (default: ``utils.device.default_device()``)
with their dtype; complex arrays (DMD's ``lambdas`` and ``amplitudes``)
stay host numpy arrays, as the port keeps them; the JAX-only ``_mesh``
attribute is dropped.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from corrla_rs_tpu_torch import PyDMDc
from corrla_rs_tpu_torch.models.active_subspaces import FittedActiveSsRsvd
from corrla_rs_tpu_torch.models.dmd import DMD, DMDc
from corrla_rs_tpu_torch.models.pca import PcaRsvd
from corrla_rs_tpu_torch.models.pod import PodI
from corrla_rs_tpu_torch.ops.dream import DreamState
from corrla_rs_tpu_torch.ops.incremental import IncrementalPca, IncrementalSvd
from corrla_rs_tpu_torch.ops.interp import RbfInterp
from corrla_rs_tpu_torch.utils.device import default_device

__all__ = ["from_jax_state", "load_jax_checkpoint"]

_CLASSES = {"PcaRsvd": PcaRsvd, "RbfInterp": RbfInterp, "PodI": PodI,
            "DMDc": DMDc, "PyDMDc": PyDMDc, "DMD": DMD,
            "FittedActiveSsRsvd": FittedActiveSsRsvd,
            "IncrementalSvd": IncrementalSvd,
            "IncrementalPca": IncrementalPca}
_DMDC_STATE = ("n_x", "n_u", "_A", "_B", "_u_hat", "lambdas", "modes_re",
               "modes_im", "_w_re", "_w_im")
# fitted arrays each class needs to predict
_REQUIRED = {
    "PcaRsvd": ("means", "pca_s", "components_", "n_samples"),
    "RbfInterp": ("kernel", "eps", "rbf_dim", "poly_degree", "x_known",
                  "coeffs"),
    "PodI": ("modes", "t_abscissa", "_rbf_coeffs", "mode_weights"),
    "DMDc": _DMDC_STATE,
    "PyDMDc": _DMDC_STATE,
    "DMD": ("n_x", "n_t", "_A", "_u_r", "lambdas", "amplitudes", "modes_re",
            "modes_im", "_w_re", "_w_im"),
    "FittedActiveSsRsvd": ("components_", "singular_vals_", "n_comps"),
    "IncrementalSvd": ("rank", "track_v", "u", "s", "v", "n_cols"),
    "IncrementalPca": ("n_components", "components_", "singular_values_",
                       "mean_", "n_samples_seen_"),
}
_DREAM_FLOAT = ("heads", "head_lnp", "p_cr", "jump_dist", "n_id")
_DREAM_COUNT = ("n_accept", "t")
_JAX_ONLY = "_mesh"   # a jax.sharding.Mesh, or None


def _is_array(val) -> bool:
    return hasattr(val, "__array__") and hasattr(val, "shape")


def from_jax_state(class_name: str, state: dict, device=None):
    """Port object of ``class_name`` holding the JAX object's ``state``."""
    dev = torch.device(device) if device is not None else default_device()
    if class_name == "DreamState":
        return _dream_state(state, dev)
    cls = _CLASSES.get(class_name)
    if cls is None:
        raise ValueError(f"no port of {class_name!r}; known: "
                         f"{sorted(_CLASSES) + ['DreamState']}")
    missing = [k for k in _REQUIRED[class_name] if k not in state]
    if missing:
        raise ValueError(f"{class_name} state lacks {missing}")
    obj = cls.__new__(cls)
    for name, val in state.items():
        if name == _JAX_ONLY:
            continue
        if _is_array(val):
            val = np.array(val)
            if not np.iscomplexobj(val):
                val = torch.as_tensor(val, device=dev)
        setattr(obj, name, val)
    obj._device = dev
    return obj


def _dream_state(state: dict, dev) -> DreamState:
    missing = [k for k in _DREAM_FLOAT + _DREAM_COUNT if k not in state]
    if missing:
        raise ValueError(f"DreamState state lacks {missing}")
    seed = state.get("key", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) if isinstance(seed, (int, np.integer)) else 0)
    fields = {k: torch.as_tensor(np.array(state[k]), device=dev)
              for k in _DREAM_FLOAT}
    fields.update({k: torch.as_tensor(int(np.array(state[k])),
                                      dtype=torch.int64, device=dev)
                   for k in _DREAM_COUNT})
    return DreamState(key=gen, **fields)


def load_jax_checkpoint(path, device=None):
    """Port object from an ``.npz`` written by the JAX ``save_model``."""
    with np.load(path, allow_pickle=False) as data:
        class_name = str(data["__class__"])
        state = {}
        for name, val in json.loads(str(data["__scalars__"])).items():
            if isinstance(val, dict) and "__dict__" in val:
                val = val["__dict__"]
            elif isinstance(val, dict) and "__json__" in val:
                val = val["__json__"]
            state[name] = val
        for key in data.files:
            if key.startswith("arr_"):
                state[key[len("arr_"):]] = data[key]
    return from_jax_state(class_name, state, device)
