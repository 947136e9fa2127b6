"""Plain reference of ``PodI``, POD with mode-weight interpolation, and the
comparisons that judge the program's fits and predictions against it.

Snapshots x (n_snap, n_points), rows the snapshots, and a parameter t
(n_snap, 1) (upstream ``pod_rom.rs:37-118``): the modes span the leading
``n_modes`` right singular vectors of x; the weights of each snapshot are
x pinv(modes)^T; one linear-kernel RBF interpolant of degree 1 over t carries
the weights; a prediction at t is modes w(t), a (n_points, n_query) field.

The reference takes the singular vectors exactly, from the Gram matrix
x x^T and its eigenvectors (the upstream takes them from a randomized SVD,
whose error the comparison then includes), orthonormalizes x^T U by
Householder QR, and writes pinv(M) = (M^T M)^-1 M^T for the full-rank M.
A prediction is P x~(t): the projection on the modes of the RBF interpolant
of the snapshots, whatever basis of the modes a fit returns, so the
comparison reads it and never the modes themselves.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import rbf_interp as rbf
from portbench.reference.linalg import F64, Arith, support_gap

__all__ = ["fit", "predict", "judge_fit", "judge_predict", "probe"]

# the interpolant over t of PodI (pod_rom.rs:78-95)
_KERNEL, _EPS, _DEGREE = "linear", 1.0, 1
# parameter values at which a fitted model is compared
_PROBE_POINTS = 512
# query columns of a block of the comparison
_BLOCK_QUERIES = 256


def fit(cfg: dict, inp: dict, arith: Arith) -> dict:
    """Modes (n_points, r), the parameter t and the interpolant's
    coefficients of the configuration's POD of ``inp`` in ``arith``."""
    x = inp["x"].to(arith.dtype)
    r = int(cfg["n_modes"])
    _, vecs = torch.linalg.eigh(arith.mm(x, x.mT))
    u = vecs[:, -r:].flip(-1)
    modes = torch.linalg.qr(arith.mm(x.mT, u)).Q
    gram = arith.mm(modes.mT, modes)
    weights = torch.linalg.solve(gram, arith.mm(modes.mT, x.mT)).mT
    del x
    t = inp["t"].to(arith.dtype)
    coeffs = rbf.fit_arrays(t, weights, _KERNEL, _EPS, _DEGREE, arith)
    return {"modes": modes, "t": t, "coeffs": coeffs}


def predict(cfg: dict, state: dict, tq: torch.Tensor,
            arith: Arith) -> torch.Tensor:
    """modes w(tq): the field (n_points, n_query)."""
    w = rbf.evaluate(state["t"], state["coeffs"], tq, _KERNEL, _EPS, _DEGREE,
                     arith)
    return arith.mm(state["modes"].to(arith.dtype), w.mT)


def probe(cfg: dict, inp: dict, gen: torch.Generator) -> torch.Tensor:
    """Parameter values at which fitted models are compared: uniform over
    the fitted range, from ``gen``."""
    t = inp["t"]
    lo, hi = t.min(), t.max()
    u = torch.rand((_PROBE_POINTS, 1), generator=gen, device=t.device,
                   dtype=t.dtype)
    return lo + (hi - lo) * u


def _field_gap(get_block, want_state: dict, cfg: dict, tq: torch.Tensor,
               n_points: int) -> float:
    """max |got - want| / max |want| over the field at ``tq``, a block of
    queries at a time; ``get_block(i, j)`` gives the got columns i:j."""
    diff = scale = 0.0
    for i in range(0, tq.shape[0], _BLOCK_QUERIES):
        j = min(i + _BLOCK_QUERIES, tq.shape[0])
        want = predict(cfg, want_state, tq[i:j], F64)
        got = get_block(i, j)
        if tuple(got.shape) != (n_points, j - i):
            return math.inf
        diff = max(diff, (got.to(torch.float64) - want).abs().max().item())
        scale = max(scale, want.abs().max().item())
    return diff / scale


def judge_fit(cfg: dict, inp: dict, prog: dict, ref,
              gen: torch.Generator) -> dict:
    """Numbers of one fit of the program (``prog``: its modes, t and
    coefficients):

    - ``pod_gap``: the largest gap between the program's fitted model,
      evaluated in float64, and the reference's (``ref()``) over the field
      at points of t drawn by ``probe`` from ``gen``, over the reference's
      largest value there;
    - ``support_gap``: the program's t against the input's, exact (a model
      of another input reads above 0)."""
    want = ref()
    points = probe(cfg, inp, gen)
    n_points = want["modes"].shape[0]

    def block(i, j):
        return predict(cfg, prog, points[i:j], F64)

    try:
        gap = _field_gap(block, want, cfg, points, n_points)
    except (RuntimeError, ValueError):
        gap = math.inf
    return {"pod_gap": gap, "support_gap": support_gap(prog["t"], inp["t"])}


def judge_predict(cfg: dict, inp: dict, prog: dict, ref, tq: torch.Tensor,
                  out: torch.Tensor) -> dict:
    """``pod_gap``: the largest gap between the program's field ``out`` at
    ``tq`` and the reference's (``ref()``), over the reference's largest
    value."""
    want = ref()
    n_points = want["modes"].shape[0]
    if out.ndim != 2 or out.shape[1] != tq.shape[0]:
        return {"pod_gap": math.inf}
    return {"pod_gap": _field_gap(lambda i, j: out[:, i:j], want, cfg, tq,
                                  n_points)}
