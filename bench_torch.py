"""Benchmark of the PyTorch/CUDA port: one JSON line for each metric of
bench.py, from the port's entry points called with bench.py's arguments.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 bench_torch.py

or at bench.py's smoke shapes on the CPU, where the numbers mean nothing
and only the lines and the exit code count:

    CORRLA_BENCH_SMOKE=1 python3 bench_torch.py

Metrics (bench.py's names and shapes):
- rsvd_100kx10k_f32_rank100_wall, the headline, printed first and again
  last: ``ops.random_svd.random_svd`` (rank 100, 8 power iterations, 10
  oversamples, key 7, stabilize="always", qr_method="cholesky") of a
  100,000 x 10,000 f32 matrix A = U diag(s) V^T with 200 known sigma,
  logspace(0, -3), made on the device from a seeded generator outside the
  timed calls; checked: max sigma relative error <= 1e-3;
- single_pass_svd_100kx10k_wall: ``single_pass_svd(A, 100, 10, key=4)`` of
  the same matrix; checked: the leading 50 sigma <= 5e-2, all 100 <= 0.25,
  |U^T U - I| <= 1e-4 (the limits of one pass at 10 oversamples);
- cs_mcmc_3000x12_wall: ``api.cs_mcmc_dirichlet_sample`` (3,000
  generations x 12 chains, seed 7) on the device; the same call with
  device="cpu" (the C++ host pipeline where it builds) is timed in the same
  run as ``cpu_route_wall`` and is the baseline; checked: rows sum to 1
  within 1e-6 and lie within the bounds, acceptance in (0, 1];
- dream_samples_per_sec_8192ch: ``ops.dream.dream_run`` of 8,192 chains x
  3 dims x 500 generations on an isotropic Gaussian, n_chains x n_steps
  over the wall; baseline the 1e6 samples/s north star; checked: the
  acceptance 0.15-0.6, pooled mean <= 0.05 sigma, covariance <= 10%,
  rank-normalized R-hat < 1.05;
- ensemble_dmdc_16x_wall: ``models.dmd.dmdc_fit_ensemble`` of 16 members x
  20 states x 40 snapshots (6 modes, 20 iterations, key 2); baseline the
  16 members fitted one after another by ``DMDc``, timed in the same run;
  checked (``ensemble_check``), for each member, what its data determine:
  the eigenvalues of the modes its output snapshots support equal the lone
  fit's to 1e-4 of its largest |lambda| (all of them where the data
  support every mode, else those of the fit projected onto the supported
  subspace, each matched to a reported eigenvalue of the other fit), and
  the one-step residual R = X' - U^ A~ U^T X - B U: ||R|| / ||X'|| <= 1e-4
  where the data support at most 6 modes (bench.py's support 2), and
  ||R - R_lone|| / ||X'|| <= 1e-4 for every member.

Each line holds bench.py's keys (metric, value, unit, vs_baseline,
baseline) and ``check`` (each measured error with its limit), ``ok``,
``runs`` (every timed wall, seconds) and ``card`` (nvidia-smi's name and
power limit, or "cpu (smoke)"). Each call is warmed up twice, then timed 5
times (cs_mcmc and DREAM 3), each call ended by ``torch.cuda.synchronize``;
``value`` is the median wall. The check runs on the last timed call's
output. At the smoke shapes the sigma and DREAM limits cannot bind: their
``check`` holds the values and says so, and ``ok`` rests on finite output of
the right shape.

Order: the headline first, its line printed at once; then single_pass on
the same matrix, which is freed after it; then cs_mcmc, DREAM and the
ensemble in bench.py's order. Each phase runs in a daemon thread under a
soft budget. The headline line is printed again as the last line.

Exit codes: 0 every phase held; 3 no CUDA device outside smoke mode (no
line printed, no CPU fallback); 4 the headline was lost (the last line is
a value-null sentinel naming it); 5 a phase breached its budget, raised or
failed its check (said on stderr; a failed check's line prints with
"ok": false). The last line on stderr gives both CUDA kernels' launch
counts in this process.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HEADLINE = "rsvd_100kx10k_f32_rank100_wall"
# soft per-phase budgets, seconds (bench.py:58-71)
HEADLINE_BUDGET_S = 420.0
PHASE_BUDGET_S = 120.0
SMOKE = bool(os.environ.get("CORRLA_BENCH_SMOKE"))
if SMOKE:
    HEADLINE_BUDGET_S = float(
        os.environ.get("CORRLA_BENCH_HEADLINE_BUDGET", "120"))
    PHASE_BUDGET_S = float(os.environ.get("CORRLA_BENCH_PHASE_BUDGET", "20"))

# bench.py's arguments
N_SIGMA = 200                  # known sigma of the SVD phases' matrix
MATRIX_SEED = 0
RSVD_KW = {"key": 7, "stabilize": "always", "qr_method": "cholesky"}
SINGLE_PASS_KEY = 4
CS_MCMC_BOUNDS = [[0.0, 0.0026], [0.1955, 0.1995], [0.80, 0.825]]
# n_samples, n_seed_samples, max_zshots, chunk_size, c_scale, alphas,
# gamma, var_epsilon
CS_MCMC_ARGS = (3000, 12, 500, 10_000, 1.0, 0.6, 0.8, 1e-12)
CS_MCMC_SEED = 7
DREAM_KEY = 1
DREAM_INIT_SEED = 0
ENSEMBLE_KW = {"n_modes": 6, "n_iters": 20, "key": 2}
# timed calls a phase, after two warm-up calls
REPS = {"headline_rsvd": 5, "single_pass": 5, "cs_mcmc": 3, "dream": 3,
        "ensemble_dmdc": 5}
DREAM_NORTH_STAR = 1e6
SVD_BASELINE = "cpu_numpy_rsvd_unrecorded"

# limits of the checks (PERF.md section 2)
SIGMA_RTOL = 1e-3
SINGLE_PASS_TOL = (5e-2, 0.25, 1e-4)   # leading half, all sigma, U^T U - I
SUM_TOL = 1e-6
DREAM_ACCEPT = (0.15, 0.6)
DREAM_MEAN_TOL, DREAM_COV_TOL, DREAM_RHAT = 0.05, 0.10, 1.05
ENSEMBLE_EIG_RTOL = 1e-4
ENSEMBLE_RESIDUAL_TOL = 1e-4
# a singular value of X' above SUPPORT_EPS * eps(fit dtype) * sigma_1 is a
# mode the data support
SUPPORT_EPS = 1e3


def sizes(smoke: bool) -> dict:
    """bench.py's shapes, full or at its smoke mode's (bench.py:56, :66-71,
    :228, :257): svd (rows, columns, rank, iterations, oversamples), dream
    (chains, dims, generations), ensemble (members, states, snapshots)."""
    if smoke:
        return {"svd": (2000, 256, 8, 2, 10), "dream": (64, 3, 20),
                "ensemble": (2, 20, 40)}
    return {"svd": (100_000, 10_000, 100, 8, 10), "dream": (8192, 3, 500),
            "ensemble": (16, 20, 40)}


class Bench:
    """What the phases share: the device, the shapes, the card line, the
    SVD phases' matrix and the phases abandoned at their budget."""

    def __init__(self, device, smoke: bool, card: str):
        self.device = torch.device(device)
        self.smoke = smoke
        self.card = card
        self.sizes = sizes(smoke)
        self.abandoned: list = []
        self._matrix = None
        self._lock = threading.Lock()

    def matrix(self):
        """(A in f32, its sigma in f64), made once for both SVD phases."""
        with self._lock:
            if self._matrix is None:
                n, m = self.sizes["svd"][:2]
                self._matrix = rsvd_matrix(n, m, min(N_SIGMA, m),
                                           self.device, MATRIX_SEED)
            return self._matrix

    def free_matrix(self) -> None:
        with self._lock:
            self._matrix = None

    def line(self, metric, walls, value, unit, vs, baseline, tests,
             **extra) -> dict:
        """bench.py's line (bench.py:87-94) with ``check``, ``ok``, ``runs``
        and ``card``. ``tests``: (name, value, limit, held, binds at the
        smoke shapes too)."""
        line = {"metric": metric, "value": round(float(value), 6),
                "unit": unit,
                "vs_baseline": round(float(vs), 2) if vs is not None else None,
                "baseline": baseline}
        check = {name: {"value": _num(v), "limit": limit}
                 for name, v, limit, _, _ in tests}
        binding = [held for _, _, _, held, always in tests
                   if always or not self.smoke]
        if len(binding) < len(tests):
            check["limits"] = "bind at full size"
        if self.abandoned:
            check["note"] = (
                f"phase(s) {', '.join(self.abandoned)} were abandoned at "
                "their budget and may still queue work on the device: this "
                "line's times are suspect")
        line.update(check=check, ok=all(binding), runs=walls,
                    card=self.card, **extra)
        return line


def timed_walls(fn, reps: int, device):
    """Two warm-up calls, then ``reps`` timed ones, each ended by a
    synchronise of ``device`` when it is a CUDA device; (walls in seconds,
    the last call's output)."""
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(2):
        fn()
        sync()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync()
        walls.append(time.perf_counter() - t0)
    return walls, out


def _num(v):
    """A JSON-safe number: a non-finite float becomes None."""
    if isinstance(v, (bool, str)) or v is None:
        return v
    v = float(v)
    return v if np.isfinite(v) else None


def _finite(*ts) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in ts)


def rsvd_matrix(n: int, m: int, n_sig: int, device, seed: int):
    """A = U diag(s) V^T, n x m f32, with n_sig known sigma logspace(0, -3)
    and U, V orthonormal from a seeded generator on ``device``; (A, s in
    f64)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    s = torch.logspace(0, -3, n_sig, dtype=torch.float64, device=device)
    u = torch.linalg.qr(torch.randn(n, n_sig, generator=gen,
                                    device=device)).Q
    v = torch.linalg.qr(torch.randn(m, n_sig, generator=gen,
                                    device=device)).Q
    return (u * s.float()) @ v.mT, s


def dream_heads(n_chains: int, ndim: int) -> np.ndarray:
    """DREAM's starting heads, bench.py:232-235's array."""
    return np.random.default_rng(DREAM_INIT_SEED).standard_normal(
        (n_chains, ndim)).astype(np.float32)


def ensemble_data(n_mem: int, nx: int, nt: int):
    """bench.py:258-267's snapshots (n_mem, nx, nt) and controls
    (n_mem, 1, nt) in f32. The grids are start + i * step in f32, as
    jnp.linspace makes them; exp and sin are taken in f64 and rounded, so
    the arrays are the same on every device (jax's f32 exp and sin differ
    from them by at most an ulp)."""
    f32 = np.float32

    def grid(stop, n):
        return np.arange(n, dtype=f32) * f32(f32(stop) / f32(n - 1))

    t = grid(1.0, nt)
    uc = np.exp(t.astype(np.float64)).astype(f32)[None, :]
    snap = np.sin((grid(3.0, nx)[:, None] + t[None, :]).astype(
        np.float64)).astype(f32) * uc
    ens = np.broadcast_to(snap, (n_mem, nx, nt)) * (
        f32(1.0) + f32(1e-3) * np.arange(n_mem, dtype=f32)[:, None, None])
    u_b = np.broadcast_to(uc, (n_mem,) + uc.shape)
    return np.ascontiguousarray(ens), np.ascontiguousarray(u_b)


def sigma_rel_err(s, s_true) -> torch.Tensor:
    k = s.shape[0]
    return (s.double() - s_true[:k]).abs() / s_true[:k]


def bench_headline_rsvd(b: Bench) -> dict:
    from corrla_rs_tpu_torch.ops.random_svd import random_svd

    n, m, rank, n_iter, n_os = b.sizes["svd"]
    a, s_true = b.matrix()
    walls, (u, s, vt) = timed_walls(
        lambda: random_svd(a, rank, n_iter, n_os, **RSVD_KW),
        REPS["headline_rsvd"], b.device)
    shaped = (u.shape == (n, rank) and s.shape == (rank,)
              and vt.shape == (rank, m) and _finite(u, s, vt))
    err = sigma_rel_err(s, s_true).max().item()
    return b.line(HEADLINE, walls, statistics.median(walls), "s", None,
                  SVD_BASELINE, [
                      ("finite_and_shapes", shaped, True, shaped, True),
                      ("sigma_max_rel_err", err, f"<= {SIGMA_RTOL}",
                       err <= SIGMA_RTOL, False)])


def bench_single_pass(b: Bench) -> dict:
    from corrla_rs_tpu_torch.ops.random_svd import single_pass_svd

    n, m, rank, _, n_os = b.sizes["svd"]
    try:
        a, s_true = b.matrix()
        walls, (u, s, vt) = timed_walls(
            lambda: single_pass_svd(a, rank, n_os, key=SINGLE_PASS_KEY),
            REPS["single_pass"], b.device)
    finally:
        a = None
        b.free_matrix()
    shaped = (u.shape == (n, rank) and s.shape == (rank,)
              and vt.shape == (rank, m) and _finite(u, s, vt))
    rel = sigma_rel_err(s, s_true)
    held = rel[:rank // 2].max().item()
    worst = rel.max().item()
    eye = torch.eye(rank, device=u.device)
    orth = (u.mT @ u - eye).abs().max().item()
    tol_held, tol_all, tol_orth = SINGLE_PASS_TOL
    return b.line("single_pass_svd_100kx10k_wall", walls,
                  statistics.median(walls), "s", None, SVD_BASELINE, [
                      ("finite_and_shapes", shaped, True, shaped, True),
                      (f"leading_{rank // 2}_sigma_max_rel_err", held,
                       f"<= {tol_held}", held <= tol_held, False),
                      (f"all_{rank}_sigma_max_rel_err", worst,
                       f"<= {tol_all}", worst <= tol_all, False),
                      ("orthonormality_err", orth, f"<= {tol_orth}",
                       orth <= tol_orth, False)])


def bench_small_mcmc(b: Bench) -> dict:
    from corrla_rs_tpu_torch.api import cs_mcmc_dirichlet_sample

    def run(device):
        return cs_mcmc_dirichlet_sample(CS_MCMC_BOUNDS, *CS_MCMC_ARGS,
                                        seed=CS_MCMC_SEED, device=device)

    def route(samples):
        return "device" if isinstance(samples, torch.Tensor) else "host C++"

    walls, (smp, ar) = timed_walls(lambda: run(b.device), REPS["cs_mcmc"],
                                   b.device)
    ran = route(smp)
    if b.device.type == "cpu":
        cpu_walls, cpu_ran = walls, ran      # the same call
    else:
        cpu_walls, (cpu_smp, _) = timed_walls(lambda: run("cpu"),
                                              REPS["cs_mcmc"], "cpu")
        cpu_ran = route(cpu_smp)
    cpu_wall = statistics.median(cpu_walls)
    wall = statistics.median(walls)
    on_card = b.device.type == "cpu" or (
        ran == "device" and smp.device.type == b.device.type)
    x = torch.as_tensor(smp).detach().to("cpu", torch.float64)
    bounds = torch.as_tensor(CS_MCMC_BOUNDS, dtype=torch.float64)
    n_gens, n_chains = CS_MCMC_ARGS[:2]
    shaped = tuple(x.shape) == (n_gens * n_chains, len(bounds)) and _finite(x)
    sum_err = (x.sum(1) - 1.0).abs().max().item()
    inside = bool(((x >= bounds[:, 0]) & (x <= bounds[:, 1])).all())
    ar = float(ar)
    kind = "cxx_host_pipeline" if cpu_ran == "host C++" else "torch"
    return b.line(
        "cs_mcmc_3000x12_wall", walls, wall, "s", cpu_wall / wall,
        f"cpu_route_{kind}_measured_{cpu_wall:.4f}s", [
            ("finite_and_shape", shaped, True, shaped, True),
            ("route", ran, f"device on {b.device.type}" if b.device.type
             == "cuda" else "either on the cpu", on_card, True),
            ("max_abs_row_sum_err", sum_err, f"<= {SUM_TOL}",
             sum_err <= SUM_TOL, True),
            ("inside_bounds", inside, True, inside, True),
            ("acceptance", ar, "in (0, 1]", 0.0 < ar <= 1.0, True)],
        route=ran, cpu_route=cpu_ran, cpu_route_wall=cpu_wall,
        cpu_route_runs=cpu_walls)


def bench_dream(b: Bench) -> dict:
    from corrla_rs_tpu_torch.ops.diagnostics import rank_normalized_rhat
    from corrla_rs_tpu_torch.ops.dream import dream_run
    from corrla_rs_tpu_torch.utils.config import DreamConfig

    n_chains, ndim, n_steps = b.sizes["dream"]
    heads0 = torch.as_tensor(dream_heads(n_chains, ndim), device=b.device)

    def lnp(x):
        return -0.5 * (x * x).sum()

    walls, (hist, state) = timed_walls(
        lambda: dream_run(heads0, lnp, n_steps, key=DREAM_KEY),
        REPS["dream"], b.device)
    rate = n_chains * n_steps / statistics.median(walls)
    shaped = (tuple(hist.shape) == (n_steps, n_chains, ndim)
              and hist.device.type == b.device.type and _finite(hist))
    accept = int(state.n_accept) / (n_steps * n_chains)
    # the target is N(0, I): sigma 1, covariance I
    tail = hist[DreamConfig().n_adapt:].double()
    pooled = tail.reshape(-1, ndim)
    mean_err = pooled.mean(0).abs().max().item()
    cov_err = (torch.cov(pooled.T) - torch.eye(ndim, dtype=torch.float64,
                                               device=pooled.device)
               ).abs().max().item()
    rhat = rank_normalized_rhat(tail).max().item()
    lo, hi = DREAM_ACCEPT
    return b.line(
        "dream_samples_per_sec_8192ch", walls, rate, "samples/s",
        rate / DREAM_NORTH_STAR, f"north_star_{DREAM_NORTH_STAR:.0e}", [
            ("finite_and_shape", shaped, True, shaped, True),
            ("acceptance", accept, f"in [{lo}, {hi}]", lo <= accept <= hi,
             False),
            ("pooled_mean_err_sigma", mean_err, f"<= {DREAM_MEAN_TOL}",
             mean_err <= DREAM_MEAN_TOL, False),
            ("covariance_err", cov_err, f"<= {DREAM_COV_TOL}",
             cov_err <= DREAM_COV_TOL, False),
            ("rank_normalized_rhat", rhat, f"< {DREAM_RHAT}",
             rhat < DREAM_RHAT, False)])


def eig_gap(got, want) -> float:
    """Largest distance from an eigenvalue of ``got`` to the nearest of
    ``want`` and back, over ``want``'s largest |lambda| (no ordering of the
    two sets needed)."""
    d = np.abs(np.asarray(got)[:, None] - np.asarray(want)[None, :])
    return float(max(d.min(1).max(), d.min(0).max()) / np.abs(want).max())


def _one_way(points, reported) -> float:
    """Largest distance from a point to the nearest reported eigenvalue."""
    if len(points) == 0:
        return 0.0
    return float(np.abs(points[:, None] - reported[None, :]).min(1).max())


def _lambdas(fit: dict) -> np.ndarray:
    return (fit["lambdas_re"].double()
            + 1j * fit["lambdas_im"].double()).cpu().numpy()


def supported_subspaces(y, eps: float) -> list:
    """For each member of y (B, n_x, m), the f64 left singular vectors of
    the singular values above ``SUPPORT_EPS * eps * sigma_1``."""
    y = y.double()
    if y.shape[-2] > y.shape[-1]:
        q, r = torch.linalg.qr(y)
        w, s, _ = torch.linalg.svd(r)
        w = q @ w
    else:
        w, s, _ = torch.linalg.svd(y, full_matrices=False)
    keep = (s > SUPPORT_EPS * eps * s[:, :1]).sum(1).tolist()
    return [wb[:, :k] for wb, k in zip(w, keep)]


def _projected(fit: dict, b: int, q) -> np.ndarray:
    """Eigenvalues of member b's operator U^ A~ U^T on the subspace q:
    those of Q^T U^ A~ U^T Q."""
    qu = q.mT @ fit["u_hat"][b].double()
    m = qu @ fit["a_til"][b].double() @ qu.mT
    return np.linalg.eigvals(m.cpu().numpy())


def ensemble_check(x_b, u_b, fit: dict, lone: dict) -> dict:
    """What member b's data determine, held between two fits of the same
    data: ``fit`` (the ensemble) and ``lone`` (its members fitted alone),
    each a dict of stacked ``lambdas_re/lambdas_im`` (B, r), ``a_til``
    (B, r, r), ``u_hat`` (B, n_x, r) and ``b_op`` (B, n_x, n_u).

    k_b, the modes the data support, counts the f64 singular values of
    X' = x[:, 1:] above 1e3 eps sigma_1 (eps of the coarser dtype of the
    two fits). Where k_b >= r, all r eigenvalues of the two fits are
    matched both ways. Where k_b < r, the trailing eigenvalues are set by
    rounding; each fit's operator is projected onto the k_b leading left
    singular vectors Q of X', and every projected eigenvalue of the lone
    fit must lie near a reported eigenvalue of the ensemble and every one
    of the ensemble near a reported one of the lone fit. Both are over the
    lone fit's largest |lambda|.

    The one-step residual R = X' - U^ A~ U^T X - B U (f64, X = x[:, :-1],
    U = u[:, :-1]) is held two ways: where k_b <= r an exact r-mode model
    of the data exists, so ||R||_F / ||X'||_F itself must be small; for
    every member the two fits' residuals must agree, ||R - R_lone||_F /
    ||X'||_F (the gap of their one-step predictions on the data), since
    where k_b > r both carry the same truncation error.

    Returns {"eig_err": largest over the members, "residual": the largest
    ||R|| / ||X'||, "exact_residual": the largest over the members with
    k_b <= r (0 if none), "vs_lone": the largest prediction gap,
    "supported": [k_b, ...]}.
    """
    r = fit["a_til"].shape[-1]
    eps = max(float(torch.finfo(fit["a_til"].dtype).eps),
              float(torch.finfo(lone["a_til"].dtype).eps))
    x = torch.as_tensor(x_b).double()
    u = torch.as_tensor(u_b, device=x.device).double()
    y = x[..., 1:]
    subspaces = supported_subspaces(y, eps)
    supported = [q.shape[1] for q in subspaces]
    lam, lam_1 = _lambdas(fit), _lambdas(lone)
    if lam.shape != lam_1.shape or lam.shape[0] != x.shape[0]:
        inf = float("inf")
        return {"eig_err": inf, "residual": inf, "exact_residual": inf,
                "vs_lone": inf, "supported": supported}
    gaps = []
    for b, q in enumerate(subspaces):
        scale = max(float(np.abs(lam_1[b]).max()), 1e-300)
        if q.shape[1] >= r:
            gaps.append(eig_gap(lam[b], lam_1[b]))
            continue
        gaps.append(max(_one_way(_projected(lone, b, q), lam[b]),
                        _one_way(_projected(fit, b, q), lam_1[b])) / scale)
    res, res_1 = one_step_residuals(fit, x, u), one_step_residuals(lone, x, u)
    norm = torch.linalg.matrix_norm(y).clamp_min(1e-300)
    rel = torch.linalg.matrix_norm(res) / norm
    exact = [float(rel[b]) for b, k in enumerate(supported) if k <= r]
    return {"eig_err": float(np.max(gaps)), "residual": float(rel.max()),
            "exact_residual": max(exact, default=0.0),
            "vs_lone": float((torch.linalg.matrix_norm(res - res_1)
                              / norm).max()),
            "supported": supported}


def one_step_residuals(fit: dict, x, u):
    """Each member's X' - U^ A~ U^T X - B U in f64, with X = x[:, :-1],
    X' = x[:, 1:] and U = u[:, :-1]."""
    u_hat = fit["u_hat"].to(x.device).double()
    a_til = fit["a_til"].to(x.device).double()
    return (x[..., 1:] - u_hat @ (a_til @ (u_hat.mT @ x[..., :-1]))
            - fit["b_op"].to(x.device).double() @ u[..., :-1])


def ensemble_held(held: dict) -> bool:
    """Whether ``ensemble_check``'s result holds at the bench's limits."""
    return (held["eig_err"] <= ENSEMBLE_EIG_RTOL
            and held["exact_residual"] <= ENSEMBLE_RESIDUAL_TOL
            and held["vs_lone"] <= ENSEMBLE_RESIDUAL_TOL)


def stacked(singles: list) -> dict:
    """Lone ``DMDc`` fits as an ensemble fit's dict of stacked tensors."""
    lam = torch.as_tensor(np.stack([m.lambdas for m in singles]))
    return {"lambdas_re": lam.real, "lambdas_im": lam.imag,
            "a_til": torch.stack([m._A for m in singles]),
            "u_hat": torch.stack([m._u_hat for m in singles]),
            "b_op": torch.stack([m.est_b_til() for m in singles])}


def lone_fits(ens, u_b) -> list:
    """Each member fitted alone by ``DMDc``, seeded by the member's child
    of the ensemble's key, as ``dmdc_fit_ensemble`` seeds it."""
    from corrla_rs_tpu_torch.models import dmd

    keys = dmd._split_seed(ENSEMBLE_KW["key"], len(ens), ens.device)
    return [dmd.DMDc(x, u, ENSEMBLE_KW["n_modes"], ENSEMBLE_KW["n_iters"],
                     key=k) for x, u, k in zip(ens, u_b, keys)]


def bench_ensemble_dmdc(b: Bench) -> dict:
    from corrla_rs_tpu_torch.models import dmd

    n_mem, nx, nt = b.sizes["ensemble"]
    ens, u_b = (torch.as_tensor(x, device=b.device)
                for x in ensemble_data(n_mem, nx, nt))
    walls, fit = timed_walls(
        lambda: dmd.dmdc_fit_ensemble(ens, u_b, **ENSEMBLE_KW),
        REPS["ensemble_dmdc"], b.device)

    seq_walls, singles = timed_walls(lambda: lone_fits(ens, u_b),
                                     REPS["ensemble_dmdc"], b.device)
    wall, seq = statistics.median(walls), statistics.median(seq_walls)
    r = ENSEMBLE_KW["n_modes"]
    shaped = (tuple(fit["lambdas_re"].shape) == (n_mem, r)
              and tuple(fit["modes_re"].shape) == (n_mem, nx, r)
              and _finite(*fit.values()))
    held = ensemble_check(ens, u_b, fit, stacked(singles))
    err, exact, gap = (held[k] for k in ("eig_err", "exact_residual",
                                          "vs_lone"))
    tol = ENSEMBLE_RESIDUAL_TOL
    return b.line(
        "ensemble_dmdc_16x_wall", walls, wall, "s", seq / wall,
        f"sequential_dmdc_fits_measured_{seq:.4f}s", [
            ("finite_and_shapes", shaped, True, shaped, True),
            ("eig_err_supported_vs_lone_fits", err,
             f"<= {ENSEMBLE_EIG_RTOL} of max|lambda|",
             err <= ENSEMBLE_EIG_RTOL, True),
            ("one_step_residual", exact,
             f"<= {tol} where the data support at most {r} modes",
             exact <= tol, True),
            ("one_step_vs_lone_fits", gap, f"<= {tol}", gap <= tol, True)],
        sequential_wall=seq, sequential_runs=seq_walls,
        supported_modes=held["supported"])


def phases(b: Bench) -> list:
    """(name, call) in the order they run; the first is the headline."""
    return [("headline_rsvd", lambda: bench_headline_rsvd(b)),
            ("single_pass", lambda: bench_single_pass(b)),
            ("cs_mcmc", lambda: bench_small_mcmc(b)),
            ("dream", lambda: bench_dream(b)),
            ("ensemble_dmdc", lambda: bench_ensemble_dmdc(b))]


def _say(text: str) -> None:
    print(f"bench_torch.py: {text}", file=sys.stderr, flush=True)


def _emit(line: dict) -> None:
    print(json.dumps(line), flush=True)


def _run_phase(name: str, fn, budget_s: float):
    """Run ``fn`` in a daemon thread under a soft wall budget
    (bench.py:99-144); (its line, None) or (None, why it has none). The
    phase returns its line and the caller prints it, so a late finisher
    can never print after the last line."""
    holder: dict = {}

    def target():
        try:
            holder["line"] = fn()
        except Exception as exc:  # noqa: BLE001 - reported by the caller
            holder["error"] = f"{type(exc).__name__}: {exc}"

    t = threading.Thread(target=target, daemon=True, name=f"bench-{name}")
    t0 = time.monotonic()
    t.start()
    t.join(budget_s)
    if t.is_alive():
        return None, (f"exceeded its {budget_s:g} s budget; its thread is "
                      "abandoned")
    if "line" not in holder:
        return None, (f"failed after {time.monotonic() - t0:.1f} s: "
                      f"{holder.get('error', 'it ended without a line')}")
    return holder["line"], None


def run(b: Bench, steps: list, headline_budget_s: float,
        phase_budget_s: float) -> int:
    """Run ``steps`` (see ``phases``), print their lines and the headline
    again last; the exit code (0, 4 or 5; see the module docstring)."""
    code = 0
    headline = None
    for i, (name, fn) in enumerate(steps):
        line, why = _run_phase(name, fn,
                               headline_budget_s if i == 0 else phase_budget_s)
        if b.device.type == "cuda":
            torch.cuda.empty_cache()
        if line is None:
            code = 5
            if why.startswith("exceeded"):
                b.abandoned.append(name)
            _say(f"phase '{name}' {why}; no line")
            continue
        if i == 0:
            headline = line
        _emit(line)
        if not line["ok"]:
            code = 5
            _say(f"phase '{name}' failed its check: "
                 f"{json.dumps(line['check'])}")
    if headline is None:
        # the last line must name the headline metric, so that a reader of
        # the last line never takes another wall for it (bench.py:406-419)
        print(json.dumps({
            "metric": HEADLINE, "value": None, "unit": "s",
            "vs_baseline": None,
            "error": "headline phase lost (breach or failure)"}), flush=True)
        _say("headline phase did not complete; printed the failure sentinel")
        return 4
    _emit(headline)
    return code


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, timeout=60)
        if proc.returncode == 0 and proc.stdout.strip():
            return proc.stdout.strip().splitlines()[0]
        why = (proc.stderr or proc.stdout).strip()[-200:]
    except (OSError, subprocess.TimeoutExpired) as exc:
        why = str(exc)
    return f"{torch.cuda.get_device_name(0)} (nvidia-smi: {why})"


def main() -> int:
    if SMOKE:
        b = Bench("cpu", True, "cpu (smoke)")
    elif not torch.cuda.is_available():
        _say("no CUDA device (torch.cuda.is_available() is False); the "
             "bench runs on an NVIDIA GPU, or at tiny shapes on the CPU with "
             "CORRLA_BENCH_SMOKE=1. No metric printed.")
        return 3
    else:
        torch.cuda.set_device(0)
        b = Bench(torch.device("cuda", 0), False, card_line())
    code = run(b, phases(b), HEADLINE_BUDGET_S, PHASE_BUDGET_S)
    from corrla_rs_tpu_torch.ops import rbf_kernels

    _say("kernel launches " + json.dumps({
        name: getattr(rbf_kernels, name).launches
        for name in ("pairwise_kernel_matrix", "rbf_matvec",
                     "modes_product")}))
    if b.abandoned:
        # an abandoned phase thread may sit in a device call: leave without
        # waiting for it
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    return code


if __name__ == "__main__":
    sys.exit(main())
