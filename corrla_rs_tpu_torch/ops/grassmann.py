"""Grassmann-manifold interpolation of POD/ROM bases.

Counterpart of ``corrla_rs_tpu/ops/grassmann.py`` (Amsallem & Farhat 2008).
Bases at nearby parameters live on the Grassmann manifold G(n, r) and are
interpolated through the logarithms of their subspaces in the tangent space
at a reference anchor: ``grassmann_log`` maps each anchor there, the
tangent matrices (n, r) are interpolated entry-wise over the parameters by
an ``RbfInterp`` with n * r outputs, and ``grassmann_exp`` maps the
interpolant back to an orthonormal basis.

Both maps are batched: leading dimensions of their second operand are a
batch, so the anchors' logs and the queries' exps are one batched tensor
operation each (SVDs and QRs through ``torch.linalg``). The interpolant
runs both CUDA kernels on the card: the kernel matrix in its fit (p x p
for p anchors) and the matvec in its predict, at n * r columns (2,000,000
for 200,000 x 10 bases), which the matvec walks in column chunks across
``gridDim.x``. The interpolant solves in the bases' dtype (the JAX package
reads the parameters as float64, which under x64 promotes the whole
interpolant).
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops.interp import RbfInterp
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["grassmann_log", "grassmann_exp", "subspace_angles",
           "grassmann_distance", "GrassmannInterp"]


def grassmann_log(y0: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Tangent vector at span(y0) pointing to span(y) (the log map).

    y0 (n, r) and y (..., n, r) orthonormal. Returns gamma (..., n, r) with
    ``grassmann_exp(y0, gamma)`` spanning span(y):
    L = (Y - Y0 Y0^T Y) (Y0^T Y)^{-1}, thin SVD L = U S V^T,
    gamma = U atan(S) V^T.
    """
    y0 = as_tensor(y0)
    y = as_tensor(y, device=y0.device, dtype=y0.dtype)
    m = y0.mT @ y                                  # (..., r, r)
    # L = (Y - Y0 M) M^{-1}: solve on the right via the transpose system
    resid = y - y0 @ m
    l_mat = torch.linalg.solve(m.mT, resid.mT).mT
    u, s, vt = torch.linalg.svd(l_mat, full_matrices=False)
    return (u * torch.arctan(s)[..., None, :]) @ vt


def grassmann_exp(y0: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Exponential map: walk from span(y0) along tangent ``gamma``
    (..., n, r). Returns orthonormal (..., n, r) bases of the targets:
    gamma = U S V^T -> Y = Y0 V cos(S) V^T + U sin(S) V^T, orthonormalised
    by one QR whose signs are fixed by diag(R)."""
    y0 = as_tensor(y0)
    gamma = as_tensor(gamma, device=y0.device, dtype=y0.dtype)
    u, s, vt = torch.linalg.svd(gamma, full_matrices=False)
    y = (y0 @ ((vt.mT * torch.cos(s)[..., None, :]) @ vt)
         + (u * torch.sin(s)[..., None, :]) @ vt)
    q, r = torch.linalg.qr(y)
    return q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[..., None, :]


def subspace_angles(y1: torch.Tensor, y2: torch.Tensor) -> torch.Tensor:
    """Principal angles (r,) between span(y1) and span(y2), ascending."""
    y1 = as_tensor(y1)
    y2 = as_tensor(y2, device=y1.device, dtype=y1.dtype)
    s = torch.linalg.svdvals(y1.mT @ y2)
    return torch.arccos(torch.clamp(s, -1.0, 1.0)).flip(-1)


def grassmann_distance(y1: torch.Tensor, y2: torch.Tensor) -> torch.Tensor:
    """Geodesic distance: l2 norm of the principal-angle vector."""
    return torch.linalg.vector_norm(subspace_angles(y1, y2), dim=-1)


class GrassmannInterp:
    """Interpolate reduced bases over parameters on the Grassmann manifold.

    bases: (p, n, r) stack of orthonormal anchor bases; params: (p, d)
    parameter coordinates of the anchors; ref: index of the reference
    anchor whose tangent space hosts the interpolation; kernel,
    kernel_param, poly_degree: the ``RbfInterp`` options (the default
    linear kernel with poly_degree=1 is exact at the anchors). ``device``
    is where numpy bases go (default ``utils.device.default_device()``).

    ``__call__(theta)`` returns the orthonormal (n, r) basis at a parameter
    point theta (d,), or (q, n, r) at q points (q, d).
    """

    def __init__(self, bases, params, ref: int = 0, kernel="linear",
                 kernel_param: float = 1.0, poly_degree: int = 1,
                 device=None):
        bases = as_tensor(bases, device=device)
        params = torch.atleast_2d(as_tensor(params, device=bases.device,
                                            dtype=bases.dtype))
        if params.shape[0] != bases.shape[0]:
            raise ValueError(
                f"{bases.shape[0]} bases but {params.shape[0]} parameter "
                "rows")
        p, n, r = bases.shape
        self.ref = int(ref)
        self.y0 = bases[self.ref]
        # all anchor logs in one batch (the ref's own log is 0)
        gammas = grassmann_log(self.y0, bases)
        self._interp = RbfInterp(kernel, kernel_param, params.shape[1],
                                 poly_degree)
        self._interp.fit(params, gammas.reshape(p, n * r))
        self._shape = (n, r)

    def __call__(self, theta) -> torch.Tensor:
        theta = torch.atleast_2d(as_tensor(theta, device=self.y0.device,
                                           dtype=self.y0.dtype))
        flat = self._interp.predict(theta)            # (q, n * r)
        n, r = self._shape
        out = grassmann_exp(self.y0, flat.reshape(-1, n, r))
        return out[0] if out.shape[0] == 1 else out
