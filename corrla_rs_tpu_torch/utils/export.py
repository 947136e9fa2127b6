"""Serialized model programs for serving, on ``torch.export``.

Counterpart of ``corrla_rs_tpu/utils/export.py``. A deployment ships a
program, not a Python library: ``torch.export`` traces a function into an
``ExportedProgram`` of ATen operations, ``torch.export.save`` writes it,
and a fresh process that imports only ``torch`` loads and calls it.

- ``export_fn(fn, example_args, path)``: wrap ``fn`` in an ``nn.Module``,
  export it at the example arguments (shapes and dtypes are fixed to them:
  one program per signature) and save it. Returns the ``ExportedProgram``.
- ``load_exported(path)``: load a saved program; returns a callable
  ``nn.Module`` (``torch.export.load(path).module()``), with the port's
  custom operators registered first.
- ``export_model_call(model, method, example_args, path)``: a fitted
  model's method, whose tensors become constants inside the program, so
  the file is self-contained (a PCA transform or a DMDc rollout ships as
  one ``.pt2``).

A program runs on the device it was traced on: export on the device you
serve on. A method that reaches one of the port's CUDA kernels on a CUDA
tensor (``PodI.predict``, ``RbfInterp.predict``, the GPs' distances,
``GrassmannInterp``) exports with the kernel as a node of the custom
operators ``corrla::pairwise_kernel_matrix``, ``corrla::rbf_matvec``,
``corrla::modes_product`` (and ``corrla::pairwise_kernel_matrix_into``),
registered by
``corrla_rs_tpu_torch.ops.rbf_kernels``; served, each node launches the
kernel. Such a program loads only in a process where those operators are
registered: the serving side imports torch and that module (which builds
or loads the kernel library on first use), never JAX. ``load_exported``
does so itself. A program without kernel nodes (a PCA transform, a DMDc
rollout) still loads with torch alone. On the CPU the methods run the
plain versions, which trace into ATen operations.
"""
from __future__ import annotations

import torch

# registers the corrla:: custom operators that programs of kernel-reaching
# methods hold
from corrla_rs_tpu_torch.ops import rbf_kernels  # noqa: F401

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
    """Load a program written by ``export_fn``; returns a callable. The
    port's custom operators are registered (this module imports
    ``ops.rbf_kernels``), so programs that hold kernel nodes load too."""
    return torch.export.load(path).module()


def export_model_call(model, method: str, example_args, path: str):
    """Export ``model.<method>(*example_args)`` as a self-contained program:
    the fitted tensors become constants inside it, so the serving side
    needs no model object, and only torch (plus ``ops.rbf_kernels`` where
    the method reaches a CUDA kernel)."""
    bound = getattr(model, method)

    def call(*args):
        return bound(*args)

    return export_fn(call, example_args, path)
