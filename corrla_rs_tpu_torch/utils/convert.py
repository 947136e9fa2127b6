"""Carry fitted state from the JAX package into the port.

A fitted ``PcaRsvd``, ``RbfInterp``, ``PodI``, ``DMDc`` (or ``PyDMDc``),
``DMD`` or ``FittedActiveSsRsvd`` of ``corrla_rs_tpu`` is a flat bag of
arrays and scalars, and so is its port counterpart, attribute for
attribute. Two ways across, neither of which imports JAX:

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
from corrla_rs_tpu_torch.ops.interp import RbfInterp
from corrla_rs_tpu_torch.utils.device import default_device

__all__ = ["from_jax_state", "load_jax_checkpoint"]

_CLASSES = {"PcaRsvd": PcaRsvd, "RbfInterp": RbfInterp, "PodI": PodI,
            "DMDc": DMDc, "PyDMDc": PyDMDc, "DMD": DMD,
            "FittedActiveSsRsvd": FittedActiveSsRsvd}
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
}
_JAX_ONLY = "_mesh"   # a jax.sharding.Mesh, or None


def _is_array(val) -> bool:
    return hasattr(val, "__array__") and hasattr(val, "shape")


def from_jax_state(class_name: str, state: dict, device=None):
    """Port object of ``class_name`` holding the JAX object's ``state``."""
    cls = _CLASSES.get(class_name)
    if cls is None:
        raise ValueError(f"no port of {class_name!r}; known: "
                         f"{sorted(_CLASSES)}")
    missing = [k for k in _REQUIRED[class_name] if k not in state]
    if missing:
        raise ValueError(f"{class_name} state lacks {missing}")
    dev = torch.device(device) if device is not None else default_device()
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
