"""Driver of ``corrla_rs_tpu_torch.rsvd``, the library's first entry point
(the pyo3 ``rsvd`` of the upstream ``lib_math_utils_py.rs:21-36``).

Inputs: A = U diag(s) V^T in the configuration's ``dtype``, with
``n_sigma`` known singular values s = logspace(``log10_sigma``) and U
(``n_rows``, ``n_sigma``), V (``n_cols``, ``n_sigma``) the Q factors of
standard-normal draws from the run's generator: ``bench_torch.py``'s
``rsvd_matrix``, copied so that the yardstick stays as it is when that
script changes. Each input carries its s (float64), which the comparison
holds the fitted singular values to. The model is fit-only: it has no
queries and no predict.
"""
from __future__ import annotations

import torch

import corrla_rs_tpu_torch

__all__ = ["make_fit_inputs", "make_queries", "fit", "predict", "state",
           "rbf_matvec_shape", "rsvd_work", "QUERY_AXIS",
           "TEST_QUERIES_PER_CALL"]

# a fit-only model: no predict answer, no query batch
QUERY_AXIS = 0
TEST_QUERIES_PER_CALL = 0


def rsvd_matrix(n: int, m: int, n_sig: int, log10_sigma, gen, device,
                dtype):
    """(A (n, m) in ``dtype``, its ``n_sig`` singular values in float64)."""
    s = torch.logspace(*log10_sigma, n_sig, dtype=torch.float64,
                       device=device)
    u = torch.linalg.qr(torch.randn(n, n_sig, generator=gen, device=device,
                                    dtype=dtype)).Q
    v = torch.linalg.qr(torch.randn(m, n_sig, generator=gen, device=device,
                                    dtype=dtype)).Q
    return (u * s.to(dtype)) @ v.mT, s


def make_fit_inputs(cfg: dict, count: int, gen: torch.Generator,
                    device) -> list:
    n, m = int(cfg["n_rows"]), int(cfg["n_cols"])
    n_sig = min(int(cfg["n_sigma"]), n, m)
    out = []
    for _ in range(count):
        a, s = rsvd_matrix(n, m, n_sig, cfg["log10_sigma"], gen, device,
                           getattr(torch, cfg["dtype"]))
        out.append({"a": a, "sigma": s})
    return out


def make_queries(cfg: dict, rows: int, count: int, gen: torch.Generator,
                 device) -> list:
    raise ValueError("rsvd is fit-only: it takes no queries")


def fit(cfg: dict, inp: dict, key: int) -> tuple:
    return corrla_rs_tpu_torch.rsvd(inp["a"], int(cfg["n_rank"]),
                                    int(cfg["n_iters"]),
                                    int(cfg["n_oversamples"]), seed=key)


def predict(cfg: dict, model: tuple, queries: torch.Tensor):
    raise ValueError("rsvd is fit-only: it has no predict")


def state(cfg: dict, model: tuple) -> dict:
    u, s, vt = model
    return {"u": u, "s": s.reshape(-1), "vt": vt}


def rbf_matvec_shape(cfg: dict, traffic: dict):
    return None


def rsvd_work(cfg: dict) -> tuple:
    """(bytes, operations) of a fit's products that read A: A Omega, A^T Y
    and A Z in each of ``n_iters`` iterations, and Q^T A, each reading A
    once and taking 2 operations a multiply-add at the sketch's width."""
    n, m = int(cfg["n_rows"]), int(cfg["n_cols"])
    k = min(int(cfg["n_rank"]) + int(cfg["n_oversamples"]), n, m)
    passes = 2 + 2 * int(cfg["n_iters"])
    itemsize = torch.finfo(getattr(torch, cfg["dtype"])).bits // 8
    return passes * n * m * itemsize, passes * 2 * n * m * k
