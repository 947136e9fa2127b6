"""Driver of ``corrla_rs_tpu_torch.RbfInterp``.

Inputs, as the upstream example (``examples/benchmark_rbf_interp.py``):
``n_fit`` points standard normal in ``dim`` dimensions and the target
y = sum_k sin(x_k); queries ``query_scale`` times standard normal. All in
the configuration's ``dtype``.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch import RbfInterp

__all__ = ["make_fit_inputs", "make_queries", "fit", "predict", "state",
           "rbf_matvec_shape", "QUERY_AXIS", "TEST_QUERIES_PER_CALL"]

# a predict answer is (queries, columns)
QUERY_AXIS = 0
TEST_QUERIES_PER_CALL = 1024


def make_fit_inputs(cfg: dict, count: int, gen: torch.Generator,
                    device) -> list:
    n, d = int(cfg["n_fit"]), int(cfg["dim"])
    x = torch.randn((count, n, d), generator=gen, device=device,
                    dtype=getattr(torch, cfg["dtype"]))
    y = torch.sin(x).sum(dim=-1, keepdim=True)
    return [{"x": x[i], "y": y[i]} for i in range(count)]


def make_queries(cfg: dict, rows: int, count: int, gen: torch.Generator,
                 device) -> list:
    q = torch.randn((count, rows, int(cfg["dim"])), generator=gen,
                    device=device, dtype=getattr(torch, cfg["dtype"]))
    return list(q.mul_(float(cfg["query_scale"])))


def fit(cfg: dict, inp: dict, key: int) -> RbfInterp:
    return RbfInterp(cfg["kernel_type"], cfg["kernel_param"], cfg["dim"],
                     cfg["poly_degree"]).fit(inp["x"], inp["y"])


def predict(cfg: dict, model: RbfInterp, q: torch.Tensor) -> torch.Tensor:
    return model.predict(q)


def state(cfg: dict, model: RbfInterp) -> dict:
    return {"x": model.x_known, "coeffs": model.coeffs}


def rbf_matvec_shape(cfg: dict, traffic: dict):
    """(queries, support points, dimensions, columns) of a predict call's
    RBF matvec."""
    if traffic["call"] != "predict":
        return None
    return (int(traffic["queries_per_call"]), int(cfg["n_fit"]),
            int(cfg["dim"]), 1)
