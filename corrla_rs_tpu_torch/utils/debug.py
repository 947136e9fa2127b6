"""Debug / NaN-check mode.

Counterpart of ``corrla_rs_tpu/utils/debug.py`` without ``checkified``
(a JAX-only tool). When debug mode is on (``set_debug(True)`` or
``CORRLA_DEBUG=1`` in the environment), every public API entry point
checks its array inputs and outputs for NaN/inf and raises
``NonFiniteError`` naming the function and the offending value. The checks
synchronise with the device, so leave debug mode off in production loops.
"""
from __future__ import annotations

import functools
import os
from typing import Callable

import numpy as np
import torch

__all__ = ["NonFiniteError", "set_debug", "debug_enabled", "guard_finite"]

_DEBUG = bool(int(os.environ.get("CORRLA_DEBUG", "0") or 0))


class NonFiniteError(FloatingPointError):
    """Raised in debug mode when an entry point sees NaN/inf arrays."""


def set_debug(enable: bool = True) -> None:
    """Enable/disable NaN-check debug mode (see module docstring)."""
    global _DEBUG
    _DEBUG = bool(enable)


def debug_enabled() -> bool:
    return _DEBUG


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _leaves(item)
    else:
        yield tree


def _check_tree(tree, fn_name: str, kind: str) -> None:
    for i, leaf in enumerate(_leaves(tree)):
        if isinstance(leaf, torch.Tensor):
            if not (leaf.is_floating_point() or leaf.is_complex()):
                continue
            bad = int((~torch.isfinite(leaf)).sum())
        elif isinstance(leaf, np.ndarray) and leaf.dtype.kind in "fc":
            bad = int((~np.isfinite(leaf)).sum())
        else:
            continue
        if bad:
            raise NonFiniteError(
                f"corrla_rs_tpu_torch debug: {fn_name} {kind} #{i} contains "
                f"{bad} non-finite value(s) (shape {tuple(leaf.shape)}, "
                f"dtype {leaf.dtype}). Set set_debug(False) to disable this "
                "check."
            )


def guard_finite(fn: Callable) -> Callable:
    """Decorator: in debug mode, check array args and outputs of an entry
    point for NaN/inf. No-op when debug mode is off."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _DEBUG:
            return fn(*args, **kwargs)
        _check_tree(list(args), fn.__name__, "input")
        out = fn(*args, **kwargs)
        _check_tree(out, fn.__name__, "output")
        return out

    return wrapper
