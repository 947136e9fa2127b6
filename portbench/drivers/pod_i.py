"""Driver of ``corrla_rs_tpu_torch.PodI``.

Inputs: the upstream example's moving pulse (``examples/benchmark_pod.py``),
p(t, s) = a t exp(-((s - t) / sigma)^2) with a = ``amplitude`` and
``sigma``, on ``nx`` points s evenly over ``x_range`` and ``n_snap`` values
of t over ``t_range``: a 1-D Latin hypercube, one t in the middle 60% of
each cell of an even grid. Queries are t uniform over ``t_range``. All in
the configuration's ``dtype``.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch import PodI
from corrla_rs_tpu_torch.utils.config import PodConfig

__all__ = ["make_fit_inputs", "make_queries", "fit", "predict", "state",
           "rbf_matvec_shape", "QUERY_AXIS", "TEST_QUERIES_PER_CALL"]

# a predict answer is (points, queries)
QUERY_AXIS = 1
TEST_QUERIES_PER_CALL = 96


def _uniform(lo_hi, shape, gen, device, dtype) -> torch.Tensor:
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device,
                                       dtype=dtype)


def make_fit_inputs(cfg: dict, count: int, gen: torch.Generator,
                    device) -> list:
    if cfg["t_design"] != "stratified":
        raise ValueError(f"unknown t_design {cfg['t_design']!r}")
    dtype = getattr(torch, cfg["dtype"])
    n_snap, n_pts = int(cfg["n_snap"]), int(cfg["nx"])
    t_lo, t_hi = cfg["t_range"]
    cell = torch.arange(n_snap, device=device, dtype=dtype) + 0.2
    jitter = 0.6 * torch.rand((count, n_snap), generator=gen, device=device,
                              dtype=dtype)
    t = t_lo + (t_hi - t_lo) * (cell + jitter) / n_snap
    s = torch.linspace(*cfg["x_range"], n_pts, device=device, dtype=dtype)
    # in place: one (count, n_snap, n_pts) buffer
    x = s - t[..., None]
    x.div_(float(cfg["sigma"])).square_().neg_().exp_().mul_(
        float(cfg["amplitude"]) * t[..., None])
    return [{"x": x[i], "t": t[i, :, None]} for i in range(count)]


def make_queries(cfg: dict, rows: int, count: int, gen: torch.Generator,
                 device) -> list:
    return list(_uniform(cfg["t_range"], (count, rows, 1), gen, device,
                         getattr(torch, cfg["dtype"])))


def fit(cfg: dict, inp: dict, key: int) -> PodI:
    config = PodConfig(n_iter=int(cfg["n_iter"]),
                       n_oversamples=int(cfg["n_oversamples"]))
    return PodI(inp["x"], inp["t"], int(cfg["n_modes"]), key=key,
                config=config)


def predict(cfg: dict, model: PodI, tq: torch.Tensor) -> torch.Tensor:
    return model.predict(tq)


def state(cfg: dict, model: PodI) -> dict:
    return {"modes": model.modes, "t": model.t_abscissa,
            "coeffs": model._rbf_coeffs}


def rbf_matvec_shape(cfg: dict, traffic: dict):
    """(queries, support points, dimensions, columns) of a predict call's
    RBF matvec."""
    if traffic["call"] != "predict":
        return None
    return (int(traffic["queries_per_call"]), int(cfg["n_snap"]), 1,
            int(cfg["n_modes"]))
