"""DEIM: Discrete Empirical Interpolation Method.

Counterpart of ``corrla_rs_tpu/ops/deim.py`` (Chaturantabut & Sorensen
2010): given r modes U (n, r), greedily select r interpolation rows such
that any field in span(U) is reconstructed exactly from its values there.

The greedy loop runs on the device and reads nothing back inside a step:
step j solves a padded r x r system (rows beyond j masked to identity, as
the JAX ``fori_loop`` body does), takes the residual's argmax and writes it
into the point vector on the device. Reconstruction is two small products.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["deim_points", "deim_reconstruct"]


def deim_points(modes, device=None):
    """Greedy DEIM row selection for a mode matrix ``modes`` (n, r).

    Returns ``(points (r,) int64, proj (r, r))``: the selected row indices
    in greedy order and ``proj = inv(modes[points, :])``, the
    reconstruction operator's core (see ``deim_reconstruct``).
    """
    modes = as_tensor(modes, device=device)
    n, r = modes.shape
    dev = modes.device
    points = torch.zeros(r, dtype=torch.int64, device=dev)
    points[0] = torch.argmax(torch.abs(modes[:, 0]))
    rows = torch.arange(r, device=dev)
    eye = torch.eye(r, dtype=modes.dtype, device=dev)
    for j in range(1, r):
        # solve modes[points[:j], :j] c = modes[points[:j], j] on a padded
        # r x r system: rows >= j become identity rows and their rhs
        # entries zero, so the padded solution is [c; 0]
        sel = modes[points]                       # (r, r) rows by points
        live = rows < j
        m = (torch.where(live[:, None] & live[None, :], sel, 0.0)
             + torch.where(~live[:, None], eye, 0.0))
        rhs = torch.where(live, sel[:, j], 0.0)
        c = torch.linalg.solve(m, rhs)
        resid = modes[:, j] - modes @ torch.where(live, c, 0.0)
        points[j] = torch.argmax(torch.abs(resid))
    proj = torch.linalg.inv(modes[points])
    return points, proj


def deim_reconstruct(modes, proj, samples):
    """Reconstruct full fields from their values at the DEIM points.

    modes (n, r), proj (r, r) from ``deim_points``, samples (r,) or (r, m):
    the field values at the selected points. Returns (n,) or (n, m):
    ``modes @ inv(modes[points, :]) @ samples``, exact for any field in
    span(modes).
    """
    modes = as_tensor(modes)
    proj = as_tensor(proj, device=modes.device, dtype=modes.dtype)
    samples = as_tensor(samples, device=modes.device, dtype=modes.dtype)
    return modes @ (proj @ samples)
