"""Serialized model programs for serving, on ``torch.export``.

Counterpart of ``corrla_rs_tpu/utils/export.py``. A deployment ships a
program, not a Python library: ``torch.export`` traces a function into an
``ExportedProgram`` of ATen operations, ``torch.export.save`` writes it,
and a fresh process that imports only ``torch`` loads and calls it.

- ``export_fn(fn, example_args, path)``: wrap ``fn`` in an ``nn.Module``,
  export it at the example arguments (shapes and dtypes are fixed to them:
  one program per signature) and save it. Returns the ``ExportedProgram``.
- ``load_exported(path)``: load a saved program; returns a callable
  ``nn.Module`` (``torch.export.load(path).module()``).
- ``export_model_call(model, method, example_args, path)``: a fitted
  model's method, whose tensors become constants inside the program, so
  the file is self-contained (a PCA transform or a DMDc rollout ships as
  one ``.pt2``).

A program runs on the device it was traced on: export on the device you
serve on. A method that reaches one of the port's CUDA kernels on a CUDA
tensor (``PodI.predict``, ``RbfInterp.predict``, the GPs' distances)
cannot be exported yet: the kernels launch through ctypes on a real data
pointer, which tracing does not have, and the wrapper raises
``NotImplementedError`` instead of tracing its plain version (ROADMAP
queue 1 item 19). On the CPU those methods run the plain versions, which
trace and export.
"""
from __future__ import annotations

import torch

__all__ = ["export_fn", "load_exported", "export_model_call"]


class _Call(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_fn(fn, example_args, path: str):
    """Export ``fn`` at the example arguments' shapes and dtypes to ``path``
    (``torch.export.save``). Returns the ``ExportedProgram``."""
    program = torch.export.export(_Call(fn), tuple(example_args))
    # a constant that is a strided view (an SVD's Vt rows, a slice) does not
    # load back from a saved CUDA program: store each one dense
    for name, value in program.constants.items():
        if isinstance(value, torch.Tensor) and not value.is_contiguous():
            program.constants[name] = value.contiguous()
    torch.export.save(program, path)
    return program


def load_exported(path: str):
    """Load a program written by ``export_fn``; returns a callable."""
    return torch.export.load(path).module()


def export_model_call(model, method: str, example_args, path: str):
    """Export ``model.<method>(*example_args)`` as a self-contained program:
    the fitted tensors become constants inside it, so the serving side
    needs only torch (not this package, not the model object)."""
    bound = getattr(model, method)

    def call(*args):
        return bound(*args)

    return export_fn(call, example_args, path)
