"""Multi-device truncated HOSVD: a snapshot tensor sharded along its long axis.

Counterpart of ``corrla_rs_tpu/parallel/sharded_hosvd.py``. The tensor
(I_0, I_1, ..., I_{d-1}) is split along axis 0 (the long snapshot/space
axis) over the mesh axis, every rank of the mesh making the same call, and

- the mode-0 factor comes from ``sharded_random_svd`` of the mode-0
  unfolding, which is row-sharded as it is (axis-0 rows stay local under
  ``reshape(I_0, -1)``);
- every short-mode factor comes from the leading eigenvectors of that
  mode's Gram matrix X_(k) X_(k)^T: one local Gram a rank, an all-reduce,
  then a replicated (I_k, I_k) ``eigh`` (the subspace of the unfolding-SVD
  factor the single-device path computes, exact rather than randomized);
- the core is the all-reduce of each rank's contribution
  U_0[local]^T (slab x_1 U_1^T x_2 ...).

Communication: d-1 Gram all-reduces of (I_k, I_k) and one (r_0, prod r)
core all-reduce, small next to the sharded mode-0 RSVD.
"""
from __future__ import annotations

import math

import torch

from corrla_rs_tpu_torch.ops.hosvd import _check_ranks, mode_multiply
from corrla_rs_tpu_torch.parallel.mesh import (
    _axis,
    _dtensor,
    _local,
    _psum,
    _size,
    make_mesh,
)
from corrla_rs_tpu_torch.parallel.sharded_rsvd import _sharded_svd

__all__ = ["sharded_hosvd"]


def sharded_hosvd(tensor, ranks, n_iter: int = 8, n_oversamples: int = 8,
                  key=0, mesh=None, axis_name: str | None = None):
    """Truncated HOSVD of an axis-0-sharded tensor over a device mesh.

    ``tensor`` is a DTensor sharded along axis 0 on the mesh axis, or the
    full tensor on every rank. Returns ``(core, factors)`` like
    ``ops.hosvd.hosvd``; ``factors[0]`` (I_0, r_0) is a DTensor sharded
    along its rows, the core and the other factors are replicated. Axis 0
    must divide the mesh axis size. The short-mode factors are exact
    eigenvectors where the single-device path uses the randomized SVD, so
    single factor columns may differ by sign or by a rotation within equal
    singular values; the reconstruction is the same.
    """
    mesh = mesh if mesh is not None else make_mesh()
    axis_name = _axis(mesh, axis_name)
    shape = tuple(tensor.shape)
    ranks = _check_ranks(ranks, tensor)
    n_dev = _size(mesh, axis_name)
    if shape[0] % n_dev != 0:
        raise ValueError(
            f"axis-0 length ({shape[0]}) must divide the mesh axis "
            f"size ({n_dev})"
        )
    n_rest = math.prod(shape[1:])
    if ranks[0] > n_rest:
        raise ValueError(
            f"ranks[0]={ranks[0]} exceeds prod(other dims)={n_rest}; the "
            "mode-0 unfolding cannot have higher rank: lower ranks[0] "
            "(the sharded SVD would silently clamp the sketch and the "
            "core reshape would fail late otherwise)"
        )
    if shape[0] < n_rest:
        raise ValueError(
            f"sharded_hosvd shards axis 0 and needs it to be the long "
            f"axis: I_0 = {shape[0]} < prod(other dims) = "
            f"{n_rest}; transpose the long mode to axis 0 (or use the "
            "single-device ops.hosvd.hosvd)"
        )
    t_l, _ = _local(tensor, mesh, axis_name)
    # mode-0 factor: row-sharded randomized SVD of the tall unfolding
    u0_l, _, _, _ = _sharded_svd(t_l.reshape(t_l.shape[0], n_rest), None,
                                 n_rest, ranks[0], n_iter, n_oversamples,
                                 key, "always", mesh, axis_name)
    # short-mode factors from all-reduced Grams (replicated eigh)
    factors = []
    for k in range(1, len(shape)):
        unf = torch.movedim(t_l, k, 0).reshape(shape[k], -1)
        g = _psum(unf @ unf.mT, mesh, axis_name)
        _w, v = torch.linalg.eigh(g)
        factors.append(v.flip(-1)[:, :ranks[k]])
    # core: project the local slab on every short mode, fold the local U_0
    # rows in, and sum over the ranks
    proj = t_l
    for k in range(1, len(shape)):
        proj = mode_multiply(proj, factors[k - 1].mT, k)
    core = _psum(u0_l.mT @ proj.reshape(proj.shape[0], -1), mesh, axis_name)
    u0 = _dtensor(u0_l, mesh, axis_name, 0, (shape[0], u0_l.shape[1]))
    return core.reshape(ranks), [u0] + factors
