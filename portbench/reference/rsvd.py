"""Plain reference of ``rsvd`` (randomized SVD), and the comparisons that
judge the program's fits.

The reference is Halko, Martinsson and Tropp's subspace iteration as the
upstream ``numpy_rsvd`` writes it (``examples/benchmark_rsvd.py:16-53``): a
Gaussian sketch Omega (n_cols, k), k = ``n_rank`` + ``n_oversamples``, Y =
A Omega, ``n_iters`` times Y <- A (A^T Q), a final QR, B = Q^T A, the SVD
of B and U = Q U_B, every product through ``Arith.mm``. Departures: Omega
is its own, from a fixed seed, and not the program's draw; Q is the
Householder QR of Y after every product pair (the upstream orthonormalizes
only at the end: Y then holds A's directions in the ratios sigma^(2
n_iters + 1), so at 8 iterations rounding in float32 leaves none of a
singular value under about 0.4 of the largest; the program takes
CholeskyQR2 there, which spans the same subspace in exact arithmetic).

A is tall (``n_rows`` >= ``n_cols``). The comparisons need no fit of the
reference: the input carries its known singular values, and the other two
numbers are residuals of the program's own factors, each in float64, a
block of rows at a time.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.linalg import Arith

__all__ = ["fit", "predict", "judge_fit", "judge_predict", "NUMBERS"]

NUMBERS = ("sv_gap", "svd_resid", "orth_gap")
# the reference's own sketch
_OMEGA_SEED = 0x0DE6A
# rows of A a block of the comparison (about 0.65 GB in float64 at 10,000
# columns)
_BLOCK_ROWS = 8192


def fit(cfg: dict, inp: dict, arith: Arith) -> dict:
    """U (n_rows, r), s (r,) and Vt (r, n_cols) of the configuration's
    randomized SVD of ``inp["a"]`` in ``arith``."""
    a = inp["a"].to(arith.dtype)
    n, m = a.shape
    r = int(cfg["n_rank"])
    k = min(r + int(cfg["n_oversamples"]), n, m)
    gen = torch.Generator(device=a.device)
    gen.manual_seed(_OMEGA_SEED)
    omega = torch.randn((m, k), generator=gen, device=a.device,
                        dtype=arith.dtype)
    y = arith.mm(a, omega)
    for _ in range(int(cfg["n_iters"])):
        q = torch.linalg.qr(y).Q
        y = arith.mm(a, arith.mm(a.mT, q))
    q = torch.linalg.qr(y).Q
    u_b, s, vt = torch.linalg.svd(arith.mm(q.mT, a), full_matrices=False)
    return {"u": arith.mm(q, u_b)[:, :r], "s": s[:r], "vt": vt[:r]}


def predict(cfg: dict, state: dict, queries, arith: Arith):
    raise ValueError("rsvd is fit-only: it has no predict")


def judge_fit(cfg: dict, inp: dict, prog: dict, ref,
              gen: torch.Generator) -> dict:
    """Numbers of one fit of the program (``prog``: its U, s and Vt), each
    computed in float64; ``inf`` each where a factor has the wrong shape:

    - ``sv_gap``: max over i <= r of |s_i - sigma_i| / sigma_i, against the
      input's known sigma: the power iteration's error, which grows as
      iterations are left out;
    - ``svd_resid``: max over i of ||A^T u_i - s_i v_i|| / sigma_1, zero in
      exact arithmetic whatever the sketch (A^T Q = B^T), so it reads the
      arithmetic of the products alone;
    - ``orth_gap``: the larger of max |U^T U - I| and max |V^T V - I|.

    ``ref`` (the reference's own fit) and ``gen`` are not needed."""
    a, sigma = inp["a"], inp["sigma"].to(torch.float64)
    n, m = a.shape
    r = int(cfg["n_rank"])
    u, s, vt = prog["u"], prog["s"], prog["vt"]
    if (tuple(u.shape) != (n, r) or tuple(s.shape) != (r,)
            or tuple(vt.shape) != (r, m) or sigma.shape[0] < r):
        return {name: math.inf for name in NUMBERS}
    f64 = torch.float64
    s, vt = s.to(f64), vt.to(f64)
    want = sigma[:r]
    sv_gap = ((s - want).abs() / want).max()
    atu = torch.zeros((m, r), dtype=f64, device=a.device)
    utu = torch.zeros((r, r), dtype=f64, device=a.device)
    for i in range(0, n, _BLOCK_ROWS):
        ub = u[i:i + _BLOCK_ROWS].to(f64)
        atu += a[i:i + _BLOCK_ROWS].to(f64).mT @ ub
        utu += ub.mT @ ub
    resid = torch.linalg.vector_norm(atu - vt.mT * s, dim=0).max() / sigma[0]
    eye = torch.eye(r, dtype=f64, device=a.device)
    orth = torch.maximum((utu - eye).abs().max(),
                         (vt @ vt.mT - eye).abs().max())
    return {"sv_gap": sv_gap.item(), "svd_resid": resid.item(),
            "orth_gap": orth.item()}


def judge_predict(cfg: dict, inp: dict, prog: dict, ref, queries,
                  out) -> dict:
    raise ValueError("rsvd is fit-only: it has no predict")
