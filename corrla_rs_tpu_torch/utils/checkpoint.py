"""Checkpoint / resume for fitted model objects.

Counterpart of ``corrla_rs_tpu/utils/checkpoint.py``, with the same ``.npz``
layout: ``__class__`` (the class name), ``__scalars__`` (JSON of the
scalar, dict and nested-primitive attributes), ``arr_<name>`` (each array
attribute) and ``lst_<name>_<i>`` with ``__len_<name>`` (lists of arrays):

    save_model("pca.npz", pca)
    pca2 = load_model("pca.npz")

Tensors are written as numpy arrays, so a file saved here loads into the
JAX package, and a file the JAX package saved for a class the port has
loads here (``utils.convert`` reads both). The registry holds every class
the JAX package registers; an unknown class is refused with a
``ValueError`` that names it. ``torch.device`` attributes are machine-specific and are saved
as None (loaded objects put numpy inputs on the default device).

A model fitted with ``mesh=`` saves whole: its ``DTensor`` attributes are
gathered whole (``parallel.mesh._full``) and its ``DeviceMesh`` (``_mesh``) is
written as None, as the JAX package writes its mesh, so the file loads as
a single-device model. Every rank of the mesh calls ``save_model`` (the
gathers are collectives) and the mesh's first rank writes the file.

A DREAM run resumes from its ``DreamState``: ``save_dream_state`` writes
its arrays and its generator's state; ``load_dream_state`` restores them.
A state the JAX package saved carries a JAX key instead (``key_data``);
the port's generator is then seeded from the key's words.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from corrla_rs_tpu_torch.utils.device import _is_dtensor, default_device

__all__ = [
    "save_model", "load_model", "register_model_class",
    "save_dream_state", "load_dream_state",
]

_REGISTRY: dict[str, type] = {}

_DREAM_ARRAYS = ("heads", "head_lnp", "p_cr", "jump_dist", "n_id",
                 "n_accept", "t")


def register_model_class(cls):
    """Register a class for checkpointing (used as a decorator or call)."""
    _REGISTRY[cls.__name__] = cls
    return cls


def _builtin_registry():
    # imported here: the model modules import this one for the decorator
    from corrla_rs_tpu_torch import PyDMDc
    from corrla_rs_tpu_torch.models.active_subspaces import (
        FittedActiveSsRsvd,
    )
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
    from corrla_rs_tpu_torch.ops.gp import GpRegressor, SparseGpRegressor
    from corrla_rs_tpu_torch.ops.incremental import (
        IncrementalPca,
        IncrementalSvd,
    )
    from corrla_rs_tpu_torch.ops.interp import RbfInterp
    from corrla_rs_tpu_torch.ops.pls import PlsRegressor
    from corrla_rs_tpu_torch.ops.rvine import RVineCopula
    from corrla_rs_tpu_torch.ops.univariate_rv import (
        BetaRv,
        ExponentialRv,
        KdeRv,
        NormalRv,
    )
    from corrla_rs_tpu_torch.ops.vine import CVineCopula

    for cls in (PcaRsvd, PodI, DMD, DMDc, PyDMDc, RbfInterp,
                FittedActiveSsRsvd, NormalRv, BetaRv, ExponentialRv, KdeRv,
                GpRegressor, SparseGpRegressor, OnlineDmd, IncrementalSvd,
                IncrementalPca, HankelDmd, MrDmd, PiDmd, Era, Edmd,
                KernelDmd, Spod, OpInf, Sindy, OptDmd, BopDmd, BaggedDmd,
                Cca, PlsRegressor, GaussianCopula, BivariateCopula,
                CVineCopula, RVineCopula):
        _REGISTRY.setdefault(cls.__name__, cls)


def _model_class(name: str) -> type:
    """The port's registered class of that name; a ``ValueError`` that
    names the class otherwise."""
    _builtin_registry()
    cls = _REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"unknown model class {name!r}; register it first")
    return cls


def _is_array(val) -> bool:
    return isinstance(val, (torch.Tensor, np.ndarray))


def _numpy(val) -> np.ndarray:
    if _is_dtensor(val):
        from corrla_rs_tpu_torch.parallel.mesh import _full

        val = _full(val)
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().numpy()
    return np.asarray(val)


def _is_mesh(val) -> bool:
    mod = sys.modules.get("torch.distributed.device_mesh")
    return mod is not None and isinstance(val, mod.DeviceMesh)


def _writer(model) -> bool:
    """Whether this process writes the file: always, unless the model holds
    a mesh or DTensors, whose first rank alone writes."""
    for val in vars(model).values():
        mesh = val if _is_mesh(val) else (
            val.device_mesh if _is_dtensor(val) else None)
        if mesh is not None:
            import torch.distributed as dist

            return dist.get_rank() == int(mesh.mesh.min())
    return True


def _coerce(v):
    """json default= hook: numpy scalar types -> python scalars."""
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    raise TypeError(f"not JSON-coercible: {type(v)}")


def save_model(path: str, model) -> None:
    """Serialise a fitted model's attributes to an .npz file.

    Round-trip coercions (the JSON fallback for nested primitive
    structures): tuples come back as lists, and int-keyed dicts come back
    str-keyed.
    """
    arrays = {}
    scalars = {}
    for name, val in vars(model).items():
        if isinstance(val, torch.device) or _is_mesh(val):
            scalars[name] = None
        elif _is_array(val):
            arrays[f"arr_{name}"] = _numpy(val)
        elif isinstance(val, (int, float, bool, str)) or val is None:
            scalars[name] = val
        elif isinstance(val, dict) and all(
            isinstance(v, (int, float, bool, str)) for v in val.values()
        ):
            scalars[name] = {"__dict__": val}
        elif isinstance(val, list) and val and all(
                _is_array(v) for v in val):
            for i, v in enumerate(val):
                arrays[f"lst_{name}_{i}"] = _numpy(v)
            scalars[f"__len_{name}"] = len(val)
        else:
            try:
                scalars[name] = {
                    "__json__": json.loads(json.dumps(val, default=_coerce))
                }
            except TypeError:
                raise TypeError(
                    f"cannot checkpoint attribute {name!r} of type "
                    f"{type(val)}"
                ) from None
    if not _writer(model):
        return
    np.savez(
        path,
        __class__=np.asarray(type(model).__name__),
        __scalars__=np.asarray(json.dumps(scalars)),
        **arrays,
    )


def load_model(path: str, device=None):
    """Reconstruct a model saved by ``save_model`` here or in the JAX
    package (no ``__init__`` rerun). Real arrays go to ``device`` (default
    ``utils.device.default_device()``) as tensors; complex ones stay host
    numpy arrays, as the port keeps them."""
    from corrla_rs_tpu_torch.utils.convert import _read_checkpoint, _restore

    class_name, state = _read_checkpoint(path)
    return _restore(_model_class(class_name), state, device)


def save_dream_state(path: str, state) -> None:
    """Persist a ``DreamState`` (ops.dream), the resume unit of a DREAM
    run: heads, log-probs, the generator's state, the adapted crossover
    probabilities, the jump statistics and the generation counter."""
    fields = {f: _numpy(getattr(state, f)) for f in _DREAM_ARRAYS}
    fields["key_state"] = state.key.get_state().numpy()
    fields["key_device"] = np.asarray(state.key.device.type)
    np.savez(path, **fields)


def load_dream_state(path: str, device=None):
    """Reload a ``DreamState`` saved by ``save_dream_state`` here (its
    generator resumes where it stopped; the state must load onto the
    device type it was saved from) or in the JAX package (a fresh
    generator seeded from the JAX key's words). Arrays go to ``device``
    (default ``utils.device.default_device()``)."""
    from corrla_rs_tpu_torch.ops.dream import DreamState

    dev = torch.device(device) if device is not None else default_device()
    with np.load(path, allow_pickle=False) as data:
        fields = {f: torch.as_tensor(data[f], device=dev)
                  for f in _DREAM_ARRAYS}
        for f in ("n_accept", "t"):          # int32 in a JAX file
            fields[f] = fields[f].long()
        gen = torch.Generator(device=dev)
        if "key_state" in data.files:
            saved = str(data["key_device"])
            if saved != dev.type:
                raise ValueError(f"a generator saved on {saved} cannot "
                                 f"resume on {dev.type}")
            gen.set_state(torch.from_numpy(data["key_state"].copy()))
        else:
            words = data["key_data"].astype(np.uint32).tobytes()
            gen.manual_seed(int.from_bytes(words, "little") % (2**63))
    return DreamState(key=gen, **fields)
