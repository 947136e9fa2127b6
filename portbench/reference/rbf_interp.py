"""Plain reference of ``RbfInterp``: the poly-augmented RBF interpolant, and
the comparisons that judge the program's fits and predictions against it.

The interpolant of points x (n, d) and values y (n, c) is
s(q) = sum_j phi(||q - x_j||) c_j + P(q) c_poly, with the coefficients from
the saddle system [[K, P], [P^T, 0]] [c; c_poly] = [y; 0] (the upstream
``interp_utils.rs:113-153``), K_ij = phi(||x_i - x_j||) and P(x) = [x | 1]
for polynomial degree 1. Distances are direct differences, the solve is
``linalg.lu_solve``, and every product goes through the ``Arith`` given.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.linalg import (F64, Arith, lu_solve, pairwise_dists,
                                        support_gap)

__all__ = ["kernel_name", "phi", "fit_arrays", "evaluate", "fit", "predict",
           "judge_fit", "judge_predict"]

# pairs a block of the evaluation holds: 2^25 f64 pairs are 256 MB a buffer
_BLOCK_PAIRS = 1 << 25


def kernel_name(kernel_type) -> str:
    """The pyo3 binding's codes (1 linear, 2 multiquadric, 3 cubic, else
    gaussian), or a name as it is."""
    if isinstance(kernel_type, str):
        return kernel_type
    return {1: "linear", 2: "multiquadric", 3: "cubic"}.get(int(kernel_type),
                                                            "gaussian")


def phi(r: torch.Tensor, kernel: str, eps: float) -> torch.Tensor:
    """The RBF of a distance (``interp_utils.rs:31-80``)."""
    if kernel == "linear":
        return r
    if kernel == "cubic":
        return r * r * r
    if kernel == "multiquadric":
        return torch.sqrt(1.0 + (eps * r) ** 2)
    if kernel == "gaussian":
        return torch.exp(-((eps * r) ** 2))
    raise ValueError(f"unknown RBF kernel: {kernel!r}")


def _poly(x: torch.Tensor, degree: int) -> torch.Tensor:
    if degree >= 2:
        raise ValueError("the reference covers polynomial degree 0 and 1")
    return torch.cat([x, torch.ones_like(x[:, :1])], dim=1)


def _saddle(x: torch.Tensor, kernel: str, eps: float,
            degree: int) -> torch.Tensor:
    n = x.shape[0]
    p = _poly(x, degree)
    a = x.new_zeros((n + p.shape[1], n + p.shape[1]))
    a[:n, :n] = phi(pairwise_dists(x, x), kernel, eps)
    a[:n, n:] = p
    a[n:, :n] = p.mT
    return a


def _rhs(y: torch.Tensor, rows: int) -> torch.Tensor:
    b = y.new_zeros((rows, y.shape[1]))
    b[:y.shape[0]] = y
    return b


def fit_arrays(x: torch.Tensor, y: torch.Tensor, kernel: str, eps: float,
               degree: int, arith: Arith) -> torch.Tensor:
    """Coefficients (n + p, c) of the interpolant of (x, y) in ``arith``."""
    x = x.to(arith.dtype)
    y = y.to(arith.dtype).reshape(x.shape[0], -1)
    a = _saddle(x, kernel, eps, degree)
    return lu_solve(a, _rhs(y, a.shape[0]), arith)


def evaluate(x: torch.Tensor, coeffs: torch.Tensor, q: torch.Tensor,
             kernel: str, eps: float, degree: int,
             arith: Arith) -> torch.Tensor:
    """s(q) (m, c) of the interpolant on points x with ``coeffs``, a block of
    query rows at a time."""
    x, coeffs, q = (t.to(arith.dtype) for t in (x, coeffs, q))
    n = x.shape[0]
    out = q.new_empty((q.shape[0], coeffs.shape[1]))
    rows = max(1, _BLOCK_PAIRS // max(1, n))
    for i in range(0, q.shape[0], rows):
        qb = q[i:i + rows]
        k = phi(pairwise_dists(qb, x), kernel, eps)
        out[i:i + rows] = (arith.mm(k, coeffs[:n])
                           + arith.mm(_poly(qb, degree), coeffs[n:]))
    return out


def _args(cfg: dict):
    return kernel_name(cfg["kernel_type"]), float(cfg["kernel_param"]), \
        int(cfg["poly_degree"])


def fit(cfg: dict, inp: dict, arith: Arith) -> dict:
    """The fitted state of the configuration's interpolant on ``inp``."""
    kernel, eps, degree = _args(cfg)
    x = inp["x"].to(arith.dtype)
    return {"x": x, "coeffs": fit_arrays(x, inp["y"], kernel, eps, degree,
                                         arith)}


def predict(cfg: dict, state: dict, q: torch.Tensor,
            arith: Arith) -> torch.Tensor:
    kernel, eps, degree = _args(cfg)
    return evaluate(state["x"], state["coeffs"], q, kernel, eps, degree,
                    arith)


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, inf where the shapes differ."""
    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    diff = (got.to(want.dtype) - want).abs().max()
    return (diff / want.abs().max()).item()


def _saddle_resid(cfg: dict, inp: dict, coeffs: torch.Tensor) -> float:
    """The normwise backward error of ``coeffs`` in the saddle system of
    ``inp``, worked out in float64: max |A c - b| / (||A||_inf max |c| +
    max |b|), the worst column; inf where the shapes differ."""
    kernel, eps, degree = _args(cfg)
    x = inp["x"].to(torch.float64)
    y = inp["y"].to(torch.float64).reshape(x.shape[0], -1)
    a = _saddle(x, kernel, eps, degree)
    b = _rhs(y, a.shape[0])
    c = coeffs.to(torch.float64)
    if tuple(c.shape) != tuple(b.shape):
        return math.inf
    r = (a @ c - b).abs().amax(dim=0)
    scale = a.abs().sum(dim=1).max() * c.abs().amax(dim=0) + b.abs().amax(dim=0)
    return (r / scale).max().item()


def judge_fit(cfg: dict, inp: dict, prog: dict, ref, gen) -> dict:
    """Numbers of one fit of the program (``prog``: its centres and
    coefficients):

    - ``saddle_resid``: the backward error of its coefficients in the saddle
      system that this module builds from ``inp``;
    - ``support_gap``: its centres against the input's points, exact (a
      model of another input reads above 0).

    The multiquadric's saddle is ill-conditioned, so two backward-stable
    float64 solves, the program's and ``ref()``, give interpolants that
    differ by up to 1e-2 on some point sets: a comparison with the
    reference's own solution measures the conditioning, and the backward
    error does not."""
    return {"saddle_resid": _saddle_resid(cfg, inp, prog["coeffs"]),
            "support_gap": support_gap(prog["x"], inp["x"])}


def judge_predict(cfg: dict, inp: dict, prog: dict, ref, q: torch.Tensor,
                  out: torch.Tensor) -> dict:
    """Numbers of one predict call of the program: its fit as
    ``judge_fit`` judges it, and ``pred_gap``, the largest gap between its
    predictions ``out`` at ``q`` and the interpolant of its own centres and
    coefficients evaluated here in float64, over the largest value of the
    latter. The evaluation follows the program from its fitted state, which
    ``saddle_resid`` checks apart."""
    numbers = judge_fit(cfg, inp, prog, ref, None)
    kernel, eps, degree = _args(cfg)
    try:
        want = evaluate(prog["x"], prog["coeffs"], q, kernel, eps, degree,
                        F64)
    except (RuntimeError, ValueError):
        numbers["pred_gap"] = math.inf
    else:
        numbers["pred_gap"] = _gap(out, want)
    return numbers
