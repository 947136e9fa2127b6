"""Default device and matmul precision of the port.

The default device is ``cuda``: numpy data that enters the library without
an explicit ``device=`` goes to the GPU, and there is no silent fallback to
the CPU (on a machine without a GPU the transfer raises). Tests select the
CPU explicitly with ``set_default_device("cpu")``. Tensors that are already
tensors stay on the device they are on.

Importing this module turns TF32 off for float32 matrix products and
convolutions (``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``). This is the counterpart of
``mat_utils.PRECISION = lax.Precision.HIGHEST`` in the JAX package: TF32
keeps about three decimal digits, and the randomized SVD needs full f32
products to reach sigma relative errors near 1e-6.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

__all__ = [
    "default_device", "set_default_device", "as_tensor", "describe_device",
]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_DEFAULT_DEVICE = torch.device("cuda")


def default_device() -> torch.device:
    """Device that numpy inputs go to when no ``device=`` is given."""
    return _DEFAULT_DEVICE


def set_default_device(device) -> None:
    """Set the device that numpy inputs go to (``"cuda"`` or ``"cpu"``)."""
    global _DEFAULT_DEVICE
    _DEFAULT_DEVICE = torch.device(device)


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """Tensor view of ``x``.

    A tensor stays on its own device unless ``device`` is given; anything
    else (numpy arrays, lists, scalars) goes to ``device`` or the default
    device. The dtype is kept unless ``dtype`` is given.
    """
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=dtype or x.dtype)
    arr = np.asarray(x)
    # a read-only view (e.g. of a JAX array) or one with a negative stride
    # (a reversed slice), which torch cannot wrap, is copied
    if not arr.flags.writeable or any(s < 0 for s in arr.strides):
        arr = arr.copy()
    return torch.as_tensor(arr, device=device or _DEFAULT_DEVICE, dtype=dtype)


def _is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor``, without
    importing that module (none can exist before it is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _host_f64(x) -> np.ndarray:
    """``x`` (a tensor on any device, or anything numpy reads) as a float64
    (complex128 if complex) numpy array on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    return x if np.iscomplexobj(x) else x.astype(np.float64, copy=False)


def describe_device(device=None) -> dict:
    """Name and precision settings of ``device`` (default: the default)."""
    dev = torch.device(device or _DEFAULT_DEVICE)
    info = {
        "device": str(dev),
        "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }
    if dev.type == "cuda":
        info["name"] = torch.cuda.get_device_name(dev)
        info["count"] = torch.cuda.device_count()
    return info
