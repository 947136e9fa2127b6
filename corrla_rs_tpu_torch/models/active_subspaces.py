"""Active-subspace identification and Constantine-Diaz sensitivity.

Counterpart of ``corrla_rs_tpu/models/active_subspaces.py`` (Constantine et
al., arxiv 1304.2070; Constantine & Diaz, arxiv 1510.04361; parity with
reference active_subspaces.rs:23-277):

- the reference's KdTree neighbour search becomes ``ops.knn.knn``, whose
  distances come from the CUDA kernel-matrix kernel on the GPU, or the C++
  host kd-tree with ``backend="native"`` (the port's ``native.py``);
- the reference's serial per-sample gradient loop becomes one batched
  local least-squares fit over all N neighbourhoods: the (N, n_nbrs, p)
  Vandermondes and their eps-additive pseudoinverses go through one
  batched ``torch.linalg.svd``;
- ``fit`` takes ``torch.linalg.eigh`` of C = G G^T / N (symmetric PSD),
  sorted descending by value; ``fit_svd`` takes the RSVD of G / sqrt(N)
  with the reference defaults (8 iterations, 10 oversamples).

``mesh=`` (a 1-D ``DeviceMesh``) on ``fit``, ``fit_bootstrap`` and
``fit_svd`` shards the N query rows, every rank of the mesh making the same
call: each rank runs the kNN of its queries against the whole support and
their local fits, and the gradient outer-product sum is all-reduced before
the replicated ``eigh`` (``fit_bootstrap`` all-gathers the k x N gradients
to resample them; ``fit_svd`` is the sharded RSVD of G^T / sqrt(N)).
"""
from __future__ import annotations

import numpy as np
import torch

from corrla_rs_tpu_torch.ops.knn import knn
from corrla_rs_tpu_torch.ops.mat_utils import sort_evd
from corrla_rs_tpu_torch.ops.random_svd import random_svd
from corrla_rs_tpu_torch.ops.stats_corr import (
    jac_from_lin,
    jac_from_quad,
    quad_fit,
)
from corrla_rs_tpu_torch.utils.config import ActiveSsConfig
from corrla_rs_tpu_torch.utils.device import as_tensor
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = [
    "local_poly_grads", "batched_grad_est", "PolyGradientEstimator",
    "AdGradientEstimator", "FittedActiveSsRsvd", "ActiveSsRsvd",
]

# Reference defaults for fit_svd (active_subspaces.rs:243).
ASS_N_ITER = ActiveSsConfig().n_iter
ASS_N_OVERSAMPLES = ActiveSsConfig().n_oversamples


def local_poly_grads(x_nbr: torch.Tensor, y_nbr: torch.Tensor,
                     x_query: torch.Tensor, est_order: int) -> torch.Tensor:
    """Local polynomial gradient fits over gathered neighbourhoods.

    x_nbr (n_q, n_nbrs, k), y_nbr (n_q, n_nbrs, 1), x_query (n_q, k);
    returns (n_q, k). Order 1 fits a hyperplane, order 2 a full quadratic
    whose exact gradient is taken at the query point.
    """
    if est_order == 1:
        return jac_from_lin(x_nbr, y_nbr)[:, 0, :]
    if est_order == 2:
        coeffs = quad_fit(x_nbr, y_nbr)
        return jac_from_quad(x_query[:, None, :], coeffs)[:, 0, :]
    raise NotImplementedError(f"Not implemented est order: {est_order}")


def batched_grad_est(x_support, y_support, x_query, est_order: int,
                     n_nbrs: int, query_chunk: int | None = None,
                     support_chunk: int | None = None) -> torch.Tensor:
    """Gradient estimates [dy/dx_1 .. dy/dx_k] at each query row: one kNN
    and one batched local fit, the batched ``grad_at`` of
    active_subspaces.rs:52-62,115-140. Returns (n_query, k)."""
    _d, idx = knn(x_query, x_support, n_nbrs, query_chunk=query_chunk,
                  support_chunk=support_chunk)
    return local_poly_grads(x_support[idx], y_support[idx], x_query,
                            est_order)


class PolyGradientEstimator:
    """Local-polynomial gradient estimator over a point cloud.

    Mirrors PolyGradientEstimator (active_subspaces.rs:23-141). est_order
    1 = local hyperplane, 2 = local quadratic. ``backend``: 'device' (the
    kNN on the distance-tile kernel) or 'native' (the C++ host kd-tree,
    then the batched local fits on the device). ``device`` is where numpy
    inputs go (default ``utils.device.default_device()``).
    """

    def __init__(self, x_mat, y, est_order: int, n_nbrs: int,
                 query_chunk: int | None = None,
                 support_chunk: int | None = None, backend: str = "device",
                 device=None):
        self.query_chunk = query_chunk
        self.support_chunk = support_chunk
        self.x_mat = as_tensor(x_mat, device=device)
        self.y = as_tensor(y, device=self.x_mat.device)
        if self.y.ndim == 1:
            self.y = self.y[:, None]
        self.k = self.x_mat.shape[1]
        self.est_order = int(est_order)
        self.n_nbrs = int(n_nbrs)
        n = self.x_mat.shape[0]
        # sample-count guards, parity with active_subspaces.rs:118-119,129-130
        if self.est_order == 1:
            need = self.k + 1
        else:
            need = self.k * (self.k + 3) // 2
        if n <= need or self.n_nbrs <= need:
            raise ValueError(f"order {self.est_order} in {self.k}-D needs "
                             f"more than {need} samples and neighbours, got "
                             f"{n} and {self.n_nbrs}")
        self.backend = backend
        if backend == "native":
            from corrla_rs_tpu_torch.native import KdTreeHost

            self._tree = KdTreeHost(self.x_mat.cpu().numpy())
        elif backend != "device":
            raise ValueError(f"unknown backend {backend!r}")

    def _query(self, x0) -> torch.Tensor:
        return as_tensor(x0, device=self.x_mat.device, dtype=self.x_mat.dtype)

    def grad_at(self, x0) -> torch.Tensor:
        """Gradient row (1, k) at a single point. active_subspaces.rs:52-62."""
        return self.grad_batch(self._query(x0).reshape(1, -1))

    def grad_batch(self, x_query) -> torch.Tensor:
        """Gradients at many points at once: (n_query, k)."""
        xq = self._query(x_query)
        if self.backend == "native":
            _d, idx = self._tree.query(xq.cpu().numpy(), self.n_nbrs)
            idx = torch.as_tensor(idx, device=self.x_mat.device)
            return local_poly_grads(self.x_mat[idx], self.y[idx], xq,
                                    self.est_order)
        return batched_grad_est(self.x_mat, self.y, xq, self.est_order,
                                self.n_nbrs, self.query_chunk,
                                self.support_chunk)


class AdGradientEstimator:
    """Exact gradients of a torch callable f: (k,) -> scalar, through
    ``torch.func.grad`` (one sample) and ``torch.func.vmap`` of it (a
    batch): a drop-in ``grad_est`` for ActiveSsRsvd with no estimation
    error. ``f`` must use operations that ``torch.func`` can batch."""

    def __init__(self, fn):
        self.fn = fn
        self._grad1 = torch.func.grad(fn)
        self._gradn = torch.func.vmap(self._grad1)

    def grad_at(self, x0) -> torch.Tensor:
        return self._grad1(torch.as_tensor(x0)).reshape(1, -1)

    def grad_batch(self, x_query) -> torch.Tensor:
        return self._gradn(torch.as_tensor(x_query))


class FittedActiveSsRsvd:
    """Fitted active subspace. Mirrors FittedActiveSsRsvd
    (active_subspaces.rs:45-198)."""

    def __init__(self, components, singular_vals, n_comps: int):
        self.components_ = components          # (k, r_full) columns
        self.singular_vals_ = singular_vals    # (r_full, r_full) diag
        self.n_comps = int(n_comps)

    @property
    def components(self) -> torch.Tensor:
        """First n_comps component columns. active_subspaces.rs:190-192."""
        return self.components_[:, : self.n_comps]

    @property
    def singular_vals(self) -> torch.Tensor:
        """First n_comps columns of the diag matrix. active_subspaces.rs:195-197."""
        return self.singular_vals_[:, : self.n_comps]

    def var_diag_evd_sensi(self) -> torch.Tensor:
        """Constantine-Diaz eq. 22 sensitivity, parity formula.

        Reproduces the reference exactly (active_subspaces.rs:160-170):
        diag(W^T Lambda W), with the transpose on the *first* factor; the
        textbook activity score diag(W Lambda W^T) is ``activity_scores``.
        """
        w = self.components_
        return torch.diagonal((w.mT @ self.singular_vals_) @ w)

    def activity_scores(self) -> torch.Tensor:
        """diag(W Lambda W^T), the textbook Constantine-Diaz metric."""
        w = self.components_
        return torch.diagonal((w @ self.singular_vals_) @ w.mT)

    def _input(self, x) -> torch.Tensor:
        return as_tensor(x, device=self.components_.device,
                         dtype=self.components_.dtype)

    def transform(self, x_mat) -> torch.Tensor:
        """Project (n, k) data onto the active subspace. active_subspaces.rs:173-179."""
        return self._input(x_mat) @ self.components

    def inv_transform(self, x_red) -> torch.Tensor:
        """Map reduced (n, r) data back to (n, k). active_subspaces.rs:182-187."""
        x_red = self._input(x_red)
        if x_red.ndim != 2 or x_red.shape[1] != self.n_comps:
            raise ValueError(f"expected (n, {self.n_comps}) reduced data, "
                             f"got {tuple(x_red.shape)}")
        return x_red @ self.components.mT


def _bootstrap_indices(key, n_boot: int, n: int, device) -> torch.Tensor:
    """(n_boot, n) resampling indices in [0, n): the one place the
    bootstrap draws. The parity tests replace it with the JAX package's
    draw."""
    gen = as_generator(key, device)
    return torch.randint(0, n, (n_boot, n), generator=gen, device=device)


def _sorted_eigh(c: torch.Tensor):
    """(eigenvalues as a diag matrix, eigenvectors) of symmetric c, in
    descending value order; leading dims batch."""
    eigs, vecs = torch.linalg.eigh(c)
    order = torch.argsort(-eigs, dim=-1, stable=True)
    vals = torch.gather(eigs, -1, order)
    vecs = torch.gather(vecs, -1, order[..., None, :].expand_as(vecs))
    return torch.diag_embed(vals), vecs


class ActiveSsRsvd:
    """Active-subspace estimator. Mirrors ActiveSsRsvd
    (active_subspaces.rs:201-277). ``grad_est`` has ``grad_batch``."""

    def __init__(self, grad_est, n_comps: int):
        self.grad_est = grad_est
        self.n_comps = int(n_comps)

    def _samples(self, x_mat) -> torch.Tensor:
        dev = getattr(self.grad_est, "x_mat", None)
        return as_tensor(x_mat, device=None if dev is None else dev.device)

    def create_grad_mat(self, x_mat) -> torch.Tensor:
        """(k, N) gradient matrix, one column per sample, in one batch (the
        reference loops serially, active_subspaces.rs:215-229)."""
        return self.grad_est.grad_batch(self._samples(x_mat)).mT

    def _shard_queries(self, x_mat, mesh):
        """(this rank's query rows, N): the query/sample axis sharded over
        the mesh (the support stays whole on every rank)."""
        from corrla_rs_tpu_torch.parallel.mesh import _axis, _local, _size

        axis = _axis(mesh, None)
        n_dev = _size(mesh, axis)
        n = x_mat.shape[0]
        if n % n_dev != 0:
            raise ValueError(
                f"active-subspace mesh= requires the sample count ({n}) to "
                f"divide the mesh size ({n_dev})"
            )
        dev = getattr(self.grad_est, "x_mat", None)
        x_l, _ = _local(x_mat, mesh, axis,
                        device=None if dev is None else dev.device)
        return x_l, n

    def _gram(self, x_mat, mesh):
        """(C = G G^T / N, this rank's columns of G)."""
        if mesh is None:
            x = self._samples(x_mat)
            g = self.create_grad_mat(x)
            return (g @ g.mT) / x.shape[0], g
        from corrla_rs_tpu_torch.parallel.mesh import _axis, _psum

        x_l, n = self._shard_queries(x_mat, mesh)
        g_l = self.create_grad_mat(x_l)
        return _psum(g_l @ g_l.mT, mesh, _axis(mesh, None)) / n, g_l

    def fit(self, x_mat, mesh=None) -> FittedActiveSsRsvd:
        """EVD path: eigh of C = G G^T / N, sorted descending by value.
        Parity with active_subspaces.rs:252-277."""
        c, _g = self._gram(x_mat, mesh)
        eigs, eigvs = torch.linalg.eigh(c)
        sorted_vals, sorted_vecs = sort_evd(eigs, eigvs)
        return FittedActiveSsRsvd(sorted_vecs, sorted_vals, self.n_comps)

    def fit_bootstrap(self, x_mat, n_boot: int = 100, key=0, mesh=None):
        """Bootstrap bands for the active-subspace eigenvalues and the
        subspace estimate (Constantine, "Active Subspace Methods", 2015,
        ch. 3). Resamples the N gradient columns with replacement
        ``n_boot`` times; all replicates' eigh run as one batched call.

        Returns a dict: ``eigs`` (k,) point estimate, ``eig_lo``/``eig_hi``
        2.5 / 97.5 percentile bands (k,), ``subspace_dist`` (n_boot,)
        spectral-norm distances ||W W^T - W_b W_b^T||_2 of the leading
        n_comps subspaces.
        """
        c, g = self._gram(x_mat, mesh)
        if mesh is not None:
            from corrla_rs_tpu_torch.parallel.mesh import _all_gather, _axis

            # the resamples draw from all N columns
            g = _all_gather(g.mT, mesh, _axis(mesh, None)).mT
        n = g.shape[1]                                # g: (k, N)
        vals0, w0 = _sorted_eigh(c)
        w0 = w0[:, : self.n_comps]
        idx = _bootstrap_indices(key, int(n_boot), n, g.device)
        gb = g[:, idx].movedim(1, 0)                  # (n_boot, k, N)
        vals_b, w_b = _sorted_eigh((gb @ gb.mT) / n)
        w_b = w_b[..., : self.n_comps]
        proj = w0 @ w0.mT - w_b @ w_b.mT
        dists = torch.linalg.matrix_norm(proj, ord=2)
        eigs_b = torch.diagonal(vals_b, dim1=-2, dim2=-1)
        q = torch.tensor([0.025, 0.975], dtype=eigs_b.dtype,
                         device=eigs_b.device)
        lo, hi = torch.quantile(eigs_b, q, dim=0)
        return {"eigs": torch.diagonal(vals0), "eig_lo": lo, "eig_hi": hi,
                "subspace_dist": dists}

    def fit_svd(self, x_mat, n_iter: int | None = None,
                n_oversamples: int | None = None, key=0,
                mesh=None) -> FittedActiveSsRsvd:
        """RSVD path: RSVD of G / sqrt(N). Parity with
        active_subspaces.rs:233-250. ``key`` is an int seed or a
        ``torch.Generator``."""
        n_iter = n_iter if n_iter is not None else ASS_N_ITER
        n_oversamples = (n_oversamples if n_oversamples is not None
                         else ASS_N_OVERSAMPLES)
        if mesh is not None:
            from corrla_rs_tpu_torch.parallel.mesh import _axis
            from corrla_rs_tpu_torch.parallel.sharded_rsvd import _sharded_svd

            x_l, n = self._shard_queries(x_mat, mesh)
            k = x_l.shape[1]
            g_l = self.create_grad_mat(x_l) / np.sqrt(n)
            # G (k, N) is fat: the SVD of G^T, sharded along its rows
            _u, _ut, s, vt = _sharded_svd(
                g_l.mT, None, k, min(k, self.n_comps), n_iter, n_oversamples,
                key, "auto", mesh, _axis(mesh, None))
            return FittedActiveSsRsvd(vt.mT, torch.diag(s), self.n_comps)
        x = self._samples(x_mat)
        g = self.create_grad_mat(x) / np.sqrt(x.shape[0])
        u, s, _vt = random_svd(g, min(x.shape[1], self.n_comps), n_iter,
                               n_oversamples, key=key)
        return FittedActiveSsRsvd(u, torch.diag(s), self.n_comps)
