"""Batched k-nearest-neighbour search on the distance-tile kernel.

Counterpart of ``corrla_rs_tpu/ops/knn.py``, which replaces the reference's
KdTree (active_subspaces.rs:24,71-77,90-112) with dense distances plus
top-k. The distance tile of a query chunk against a support chunk is
``ops.rbf_kernels.pairwise_kernel_matrix(xq, xs, "linear")``: for CUDA
tensors the hand-written kernel (csrc/rbf_kernels.cu, phi(r) = r), for CPU
tensors its plain version. ``torch.topk(largest=False, sorted=True)``
selects the neighbours. Memory is bounded on both axes:

- ``query_chunk``: queries are processed in chunks of this many rows;
- ``support_chunk``: the support set streams through in chunks with a
  running top-k merge (the incumbent k best concatenated with the chunk's
  candidates, re-selected), so the (n_q, n_s) tile is never formed whole.

Chunks are slices: the last one of each axis is short, and no padded row
exists that could win. The incumbents start at the dtype's largest value,
which every real distance beats. Ties: ``torch.topk`` leaves the order of
equal distances unspecified, where ``lax.top_k`` puts the lower index
first, so two equidistant support points may come back in either order.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops.rbf_kernels import pairwise_kernel_matrix

__all__ = ["knn"]


def _dists(xq: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    return pairwise_kernel_matrix(xq.contiguous(), xs.contiguous(), "linear")


def _knn_dense(xq, x_support, k):
    return torch.topk(_dists(xq, x_support), k, dim=1, largest=False,
                      sorted=True)


def _knn_streamed(xq, x_support, k, support_chunk):
    n_q, n_s = xq.shape[0], x_support.shape[0]
    best_d = torch.full((n_q, k), torch.finfo(x_support.dtype).max,
                        dtype=x_support.dtype, device=x_support.device)
    best_i = torch.zeros((n_q, k), dtype=torch.long, device=x_support.device)
    for off in range(0, n_s, support_chunk):
        d = _dists(xq, x_support[off:off + support_chunk])
        col = torch.arange(off, off + d.shape[1], device=d.device)
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, col.expand(n_q, -1)], dim=1)
        best_d, sel = torch.topk(cat_d, k, dim=1, largest=False, sorted=True)
        best_i = torch.gather(cat_i, 1, sel)
    return best_d, best_i


def knn(x_query: torch.Tensor, x_support: torch.Tensor, k: int,
        query_chunk: int | None = None, support_chunk: int | None = None):
    """k nearest support points of each query point.

    x_query (n_q, d), x_support (n_s, d), of one dtype and device. Returns
    (dists (n_q, k), idx (n_q, k) int64) sorted ascending by distance, the
    KdTree query order of active_subspaces.rs:90-112.
    """
    n_q, n_s = x_query.shape[0], x_support.shape[0]
    if k > n_s:
        raise ValueError(f"k={k} exceeds the support size {n_s}")
    if support_chunk is None or support_chunk >= n_s:
        def one(xq):
            return _knn_dense(xq, x_support, k)
    else:
        def one(xq):
            return _knn_streamed(xq, x_support, k, int(support_chunk))
    if query_chunk is None or query_chunk >= n_q:
        return tuple(one(x_query))
    parts = [one(x_query[i:i + query_chunk])
             for i in range(0, n_q, int(query_chunk))]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))
