"""Profiling and timing helpers on ``torch.profiler``.

Counterpart of ``corrla_rs_tpu/utils/tracing.py``:

- ``trace(log_dir)``: context manager around ``torch.profiler.profile``
  with the CPU activities, and the CUDA ones when the default device is a
  CUDA device and one is there; on exit it writes a Chrome-format trace
  (``*.pt.trace.json``) into ``log_dir`` that TensorBoard and Perfetto read.
  It yields the profiler, whose ``key_averages()`` sums the events.
- ``annotate(name)``: names a region inside a trace
  (``torch.profiler.record_function``) while a ``torch.profiler`` profile
  runs; otherwise it returns a shared ``contextlib.nullcontext()`` and
  records nothing, which costs under a microsecond of host time.
- ``timed(fn)``: best wall-clock time over a few calls after one warm-up,
  each call ended by ``device_sync``: CUDA launches return before the
  device has finished.
- ``device_sync(tree)``: synchronises every CUDA device that a tensor of
  ``tree`` lies on and returns a checksum of the tensors.

The package opens seven spans of its own, each through ``annotate`` and so
only while a profile runs:

- ``corrla.rsvd`` around the body of ``ops.random_svd.random_svd``, which
  is also the body of the member pass ``random_svd._random_svd_members``
  (the DMDc ensemble's batched fit: one span a pass over all members);
- inside it ``corrla.rsvd.products`` around each product that reads A (A
  Omega, each A^T Y and A Z of the power iteration, and B = Q^T A: 2 + 2
  ``n_iter`` a call), ``corrla.rsvd.orth`` around each orthonormalization
  of the power iteration and its final Householder QR, and
  ``corrla.rsvd.svd`` around the SVD of B and U = Q U_B. The first two come
  from the range finder, so ``ops.random_svd.power_iter`` (and through it
  ``ops.id_cur``) opens them as well, outside any ``corrla.rsvd``;
- ``corrla.solve.pinv`` around the body of ``ops.mat_utils.pinv``, and
  ``corrla.solve.saddle`` around the LU solve of the saddle system in
  ``ops.interp.rbf_fit``;
- ``corrla.pod.modes`` around the modes product of ``PodI.predict``
  (``ops.rbf_kernels.modes_product``, on the local rows with ``mesh=``).

``api.rsvd`` and ``PodI.fit`` open ``corrla.rsvd`` once with its inner
spans, ``PodI.fit`` then ``corrla.solve.pinv`` and ``corrla.solve.saddle``
once each, ``RbfInterp.fit`` the last once, and ``PodI.predict``
``corrla.pod.modes`` once a call. The other helpers are tools for callers
and for the scripts that measure the package.

Beside the spans, host-side counters that run with or without a profile:
``ops.rbf_kernels.pairwise_kernel_matrix.launches``,
``ops.rbf_kernels.rbf_matvec.launches`` and
``ops.rbf_kernels.modes_product.launches`` count the kernels' launches;
``rbf_matvec.launches_by`` counts the matvec's by (dtype, kernel), and
``modes_product.launches_by`` the modes product's CUDA calls by (route,
dtype, k), the route ``"kernel"`` or ``"matmul"`` (k > 32), which says how
often the kernel takes the product; and
``ops.random_svd._cholesky_qr2.rounds`` the CholeskyQR rounds (three a thin
QR inside ``corrla.rsvd.orth``: 24 a fit of ``api.rsvd`` at 8 iterations,
30 a ``PodI.fit`` at 10). It counts the rounds of the dense path, of the
member pass (one a round over all members) and of the row-sharded path
(``parallel.sharded_rsvd``); the m-space round of ``ops.streaming`` is not
counted.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.utils._pytree import tree_leaves

from corrla_rs_tpu_torch.utils.device import default_device

__all__ = ["trace", "annotate", "timed", "device_sync"]


def device_sync(tree) -> float:
    """Wait until every tensor of ``tree`` (any nesting of lists, tuples and
    dicts) is computed, synchronising each CUDA device met once; returns
    the sum of ``real(leaf.ravel()[0])`` over the non-empty tensors."""
    total = 0.0
    synced = set()
    for leaf in tree_leaves(tree):
        if not isinstance(leaf, torch.Tensor) or not leaf.numel():
            continue
        if leaf.device.type == "cuda" and leaf.device not in synced:
            torch.cuda.synchronize(leaf.device)
            synced.add(leaf.device)
        total += float(torch.real(leaf.reshape(-1)[0]))
    return total


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region into ``log_dir`` (view with TensorBoard or
    Perfetto); yields the ``torch.profiler.profile`` object."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if default_device().type == "cuda" and torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """Named sub-region annotation for traces: a
    ``torch.profiler.record_function`` while a profile runs, else a shared
    null context (an idle ``record_function`` costs about twenty times
    more)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def timed(fn, *args, n_runs: int = 3, **kwargs):
    """(best_wall_seconds, last_result) with one warm-up call and a device
    sync after every call."""
    result = fn(*args, **kwargs)
    device_sync(result)
    best = float("inf")
    for _ in range(n_runs):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        device_sync(result)
        best = min(best, time.perf_counter() - t0)
    return best, result
