"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one Hopper GPU (sm_90a),
``nvcc`` and PyTorch built for CUDA:

    python3 chip_smoke.py [--seed N]

Phases, in order; each prints one line with its result, tolerance and wall
time, and any failure raises (exit code != 0):

1. device: name and power limit from nvidia-smi, TF32 off;
2. build: nvcc compiles corrla_rs_tpu_torch/csrc/*.cu (timed);
3. kernels: both CUDA kernels against their plain PyTorch versions (run in
   f64 on the card) for every phi, f32 and f64, at odd shapes (ragged
   ones on the kernel matrix's direct stores, aligned ones on its TMA
   stores, and blocks of a larger matrix whose guard cells must stay
   untouched) and at the main path's shapes, called as the main path calls
   them (the fits' K into the block of their saddle matrix), with kernel
   and plain times (the median of 5 windows of at least 20 ms each),
   bit-identical reruns and the kernel matrix's exact phi(0) diagonal. For
   the kernel matrix also its device time (torch.profiler) and the store
   path it took; the wrappers' host time a call; the matvec's launch plans;
4. rsvd: A = U diag(s) V^T, 100,000 x 10,000 f32 with 200 known geometric
   sigma, rank 100, 8 iterations, 10 oversamples;
   then, on the same matrix, single_pass_svd (rank 100, with 10 and with
   50 oversamples) and block_krylov_svd (2 iterations) against the same
   sigma;
5. rpca: 200,000 x 512 f32 with a known centered spectrum, rank 20;
6. PodI: 2,000 snapshots x 200,000 points f32 of a smooth one-parameter
   family, 20 modes, predicted at 512 held-out t against the family;
7. RbfInterp: 16,384 support points in 3-D, linear kernel, poly degree 1
   (K is 16k x 16k f32), fit residual, then 1,048,576 predictions through
   the matvec kernel, the first 8,192 checked against the plain f64 path;
8. dmdc: DMDc of a known linear system (200,000 states x 1,001 snapshots,
   2 controls, 8 latent states), 10 modes, rolled out 1,000 steps by the
   'modes' and 'reduced' methods; PyDMDc's dense-A rollout at 20,000
   states; dmdc_fit_ensemble and rollout_ensemble over 8 members of 20,000
   states. Each against the true trajectory;
9. active_ss: api.active_ss on 8,192 samples in 8-D of y = exp(0.3 a.x),
   order 2, 64 neighbours (the kNN distance tile goes through the kernel
   matrix), the leading direction against a;
10. samplers: cs_dirichlet_sample, 1,000,000 samples in 8-D against a numpy
    rejection reference; cs_mcmc_dirichlet_sample with 1,024 seed chains x
    2,000 generations and at the reference's 12 x 3,000, both on the
    device, and 12 x 3,000 asked for on the CPU (the C++ host route);
11. dream: dream_run with 8,192 chains x 3 dims x 500 generations, 100 of
    them adapting, on a correlated Gaussian, against its mean and
    covariance, with the acceptance and the rank-normalized R-hat;
12. factorize: nystrom_eigh of a 20,000^2 PSD matrix; column_id and cur of
    50,000 x 4,000 of rank 50; hosvd of 256^3 at ranks (20, 20, 20);
    hutchpp_trace and slq_logdet of an 8,192^2 SPD matrix; sketched_lstsq of
    200,000 x 500; cg_solve with and without nystrom_preconditioner on an
    8,192^2 system; robust_pca of 2,000 x 2,000; IncrementalSvd fed
    50,000 x 2,000 in 10 blocks. Each against the exact answer or the
    matrix it was built from, at the tolerance of the JAX package's own
    test of that module (named in FACTORIZE_TOL);
13. mle: NormalRv, BetaRv and ExponentialRv fitted to 100,000 draws each
    (within 3 standard errors of the truth), build_kde on 10,000 points
    (its cdf against the empirical one, its pdf's integral).

After phase 13 come the timing details of phases 7 and 9-10 (RbfInterp's
fit with its saddle matrix built by concatenation, as before the kernel
matrix wrote K in place, and built in place; the kNN and grads steps of
active_ss; a DEMC generation) and the kNN against its plain version. The
build phase prints ptxas's registers and spills for both kernels'
instances and fails if any spills. The kernels' launch counts
are set to 0 before phase 4 and read after phase 7, again before phase 8
and after phase 10, and again before phase 11 and after phase 13; every
kernel of a path must have launched on it (phases 11-13 reach no kernel,
and the run fails if their counts say otherwise). The last lines are the kernel table as JSON (every timed shape of each kernel,
with its bound and, where one exists, a one-call PyTorch equivalent's
time), the nvidia-smi line, and the result JSON. Nothing of JAX is
imported. Without a CUDA device it exits with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PHIS = ("linear", "multiquadric", "cubic", "gaussian")
# kernel vs plain f64 tolerances. The kernel matrix is elementwise: f32
# rounds d + 4 times per element, ~40 ulp leaves margin. The matvec sums n
# terms in order: its error is measured against sum_j |phi_ij c_j|, with
# typical f32 error sqrt(n) u ~ 8e-6 at n = 16384 and 1e-4 stated.
KMAT_RTOL = {torch.float32: 5e-6, torch.float64: 1e-12}
MATVEC_RTOL = {torch.float32: 1e-4, torch.float64: 1e-12}
# the main path's sizes (see the module docstring)
SIZES = {
    "rsvd": (100_000, 10_000, 100, 8, 10, 200),   # n, m, rank, iters, os, #sigma
    "rpca": (200_000, 512, 20, 64),               # n, m, rank, #sigma
    "podi": (2000, 200_000, 20, 512),             # snapshots, points, modes, queries
    "rbf": (16384, 1 << 20, 8192),                # support, queries, checked
    "dmdc": (200_000, 1001, 10, 10),              # states, snapshots, modes, iters
    "dmdc_dense": 20_000,                         # states of PyDMDc's dense A
    "ensemble": (8, 20_000),                      # members, states each
    # n cut from 32,768: there the batched SVD of the local fits took 44.5 s
    "active_ss": (8192, 8, 64, 2, 4096),          # n, dims, nbrs, comps, checked
    "dirichlet": (1_000_000, 8, 1 << 20),         # samples, ndim, chunk
    "demc": (1024, 2000),                         # seed chains, generations
    "demc_ref": (12, 3000),                       # the reference's scale
    "krylov_iters": 2,                            # block_krylov_svd on rsvd's matrix
    "single_pass_os": 50,                         # oversamples that hold all 100 sigma
    "dream": (8192, 3, 500, 100),                 # chains, dims, generations, adapting
    "nystrom": (20_000, 100, 8),                  # n, rank, oversamples
    "cur": (50_000, 4000, 50),                    # rows, columns, rank
    "hosvd": (256, 20),                           # side of the cube, rank a mode
    "spd": (8192, 300, 200),                      # n, decaying eigenvalues, Nystrom rank
    "lstsq": (200_000, 500),                      # rows, columns
    "robust_pca": (2000, 10, 0.05),               # side, rank, corrupted share
    "incremental": (50_000, 2000, 10, 40, 10),    # rows, columns, blocks, rank, checked
    "mle": (100_000, 10_000),                     # draws a fit, KDE points
}
# tolerance of each factorize check, and the JAX package's test it is from
FACTORIZE_TOL = {
    "nystrom": (1e-3, "test_nystrom.py::test_f32_stability_tiny_spectrum "
                      "(eigenvalues, rtol; here all 100 of them, in f64)"),
    "id_cur": (1e-4, "test_id_cur.py::test_wide_and_tall_and_f32 (relative "
                     "Frobenius error)"),
    "hosvd": (1e-4, "test_hosvd.py::test_exact_recovery_low_multilinear_rank "
                    "(1e-9 in f64; here f32, at test_id_cur's f32 1e-4)"),
    "hutchpp": (1e-2, "test_trace_est.py::"
                      "test_hutchpp_accuracy_and_variance_advantage"),
    "slq": (2e-2, "test_slq.py::test_logdet_well_conditioned"),
    "lstsq": (1e-9, "test_sketch_solve.py::"
                    "test_matches_numpy_lstsq_well_conditioned (atol, f64)"),
    "pcg": (1e-8, "test_slq.py::test_nystrom_pcg_accelerates (relative "
                  "residual; iterations under a tenth of plain CG's)"),
    "robust_pca": (1e-5, "test_robust_pca.py::test_exact_recovery (L "
                         "relative error; rank; residual < 1e-7)"),
    "incremental": (1e-3, "test_incremental.py::"
                          "test_incremental_svd_truncating_tracks_dominant"),
}
# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM bytes/s, f32 and f64
# FLOP/s outside the tensor cores
PEAK_BYTES_S, PEAK_F32_FLOPS, PEAK_F64_FLOPS = 3.35e12, 67e12, 34e12
# the bounds of cs_dirichlet_sample's phase (about 26% acceptance) and the
# reference's enrichment bounds of the DEMC runs (space_samplers.rs:430-434)
DIRICHLET_BOUNDS = [[0.01, 0.30]] * 8
DEMC_BOUNDS = [[0.0, 0.0026], [0.1955, 0.1995], [0.80, 0.825]]
# (label, (seed chains, generations), device) of the DEMC runs
DEMC_RUNS = (("device", SIZES["demc"], "cuda"),
             ("reference", SIZES["demc_ref"], "cuda"),
             ("host", SIZES["demc_ref"], "cpu"))
# kNN tie rule: a neighbour set may differ from the plain f64 one only by
# points whose f64 distance lies within this relative gap of the k-th
# nearest distance (near-ties at the boundary, which f32 cannot order)
KNN_TIE_RTOL = 1e-5
SOURCE = {
    "pairwise_kernel_matrix": "corrla_rs_tpu_torch/csrc/rbf_kernels.cu",
    "rbf_matvec": "corrla_rs_tpu_torch/csrc/rbf_matvec.cuh",
}
REPLACES = {
    "pairwise_kernel_matrix": "corrla_rs_tpu/ops/pallas_kernels.py:100",
    "rbf_matvec": "corrla_rs_tpu/ops/pallas_kernels.py:154",
}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def report(phase: str, t0: float, detail: str) -> None:
    print(f"[{phase}] ok  {detail}  ({time.perf_counter() - t0:.2f} s)",
          flush=True)


def cuda_ms(fn, window_ms: float = 20.0, windows: int = 5) -> float:
    """Time of one call of ``fn`` in ms, from CUDA events: the median over
    ``windows`` windows, each of back-to-back calls lasting at least
    ``window_ms`` (or one call, if that is longer), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = max(1, math.ceil(window_ms / max(start.elapsed_time(end), 1e-3)))
    per_call = []
    for _ in range(windows):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def host_us(fn, calls: int = 5000, rounds: int = 3) -> float:
    """Host time of one call of ``fn`` in µs: the best of ``rounds`` loops
    of ``calls`` back-to-back calls on the host clock, for a call whose
    kernel is shorter than its host work, so the launch queue never
    fills."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return best * 1e6


def wall(fn):
    """(result, host seconds) of ``fn`` ending in a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def ptxas_rows(log: str) -> list:
    """[mangled name, registers, spill bytes] per kernel from nvcc's
    -Xptxas=-v output."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = int(m.group(1)) + int(m.group(2))
            rows.append([name, None, spills])
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1][0] == name:
            rows[-1][1] = int(m.group(1))
    return rows


def ptxas_summary(rows: list) -> str:
    if not rows:
        return "no ptxas report (library was already built)"
    regs = [r[1] for r in rows if r[1] is not None]
    return (f"{len(rows)} kernels, registers {min(regs)}-{max(regs)}, "
            f"spill bytes {sum(r[2] for r in rows)}")


# rbf_matvec_kernel<T, PHI, D, CC> and kernel_matrix_kernel<T, PHI, D> in
# a mangled name
MATVEC_INSTANCE = re.compile(
    r"rbf_matvec_kernelI([fd])Li(\d+)ELi(\d+)ELi(\d+)E")
KMAT_INSTANCE = re.compile(r"kernel_matrix_kernelI([fd])Li(\d+)ELi(\d+)E")
# the kernel matrix's main-path instances: (dtype, phi, D)
KMAT_MAIN = (("f32", "linear", 1), ("f32", "linear", 3), ("f32", "linear", 8),
             ("f64", "linear", 3))


def main_path_plans(rk, sms: int) -> list:
    """(label, m, n, d, c, plan) of the matvec's two main-path calls."""
    n_snap, _, n_modes, n_pq = SIZES["podi"]
    n_sup, n_q, _ = SIZES["rbf"]
    return [(label, m, n, d, c, rk._matvec_plan(m, n, c, sms))
            for label, m, n, d, c in (
                ("PodI predict", n_pq, n_snap, 1, n_modes),
                ("RbfInterp predict", n_q, n_sup, 3, 1))]


def matvec_registers(rows: list, plans: list) -> None:
    """Print the matvec instances' registers and spills, those of the
    main path's instances (f32, linear) among them; fail on a spill."""
    inst = []
    for name, regs, spills in rows:
        m = MATVEC_INSTANCE.search(name)
        if m:
            dt, phi, d, cc = m.groups()
            inst.append((("f32" if dt == "f" else "f64", PHIS[int(phi) - 1],
                          int(d), int(cc)), regs, spills))
    if not inst:
        print("    matvec: no ptxas report (library was already built)")
        return
    for dt in ("f32", "f64"):
        rows_dt = [r for r in inst if r[0][0] == dt]
        regs = [r[1] for r in rows_dt]
        worst = max(rows_dt, key=lambda r: r[1])
        print(f"    matvec {dt}: {len(rows_dt)} instances, registers "
              f"{min(regs)}-{max(regs)} (most: phi={worst[0][1]} "
              f"D={worst[0][2]} CC={worst[0][3]}), spill bytes "
              f"{sum(r[2] for r in rows_dt)}", flush=True)
    main = {r[0]: r[1] for r in inst}
    print("    matvec main-path instances: " + ", ".join(
        f"{label} f32 linear D={d} CC={plan.cols} "
        f"{main.get(('f32', 'linear', d, plan.cols))} registers"
        for label, _, _, d, _, plan in plans), flush=True)
    spilling = [r for r in inst if r[2]]
    check(not spilling, f"matvec instances spill: {spilling}")


def kmat_registers(rows: list) -> None:
    """Print the kernel matrix's instances' registers and spills, those of
    the main path's instances among them; fail on a spill."""
    inst = {}
    for name, regs, spills in rows:
        m = KMAT_INSTANCE.search(name)
        if m:
            dt, phi, d = m.groups()
            inst[("f32" if dt == "f" else "f64", PHIS[int(phi) - 1],
                  int(d))] = (regs, spills)
    if not inst:
        print("    kernel matrix: no ptxas report (library was already "
              "built)")
        return
    regs = [r for r, _ in inst.values()]
    print(f"    kernel matrix: {len(inst)} instances, registers "
          f"{min(regs)}-{max(regs)}, spill bytes "
          f"{sum(sp for _, sp in inst.values())}; main-path instances: "
          + ", ".join(f"{dt} {phi} D={d} "
                      f"{inst.get((dt, phi, d), ('?',))[0]} registers"
                      for dt, phi, d in KMAT_MAIN), flush=True)
    spilling = [k for k, (_, sp) in inst.items() if sp]
    check(not spilling, f"kernel-matrix instances spill: {spilling}")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version

def bound(n_bytes: float, n_ops: float, itemsize: int = 4):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the HBM rate and the operations over the peak of
    their type outside the tensor cores (PEAK_BYTES_S, PEAK_F32_FLOPS,
    PEAK_F64_FLOPS)."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / (PEAK_F32_FLOPS if itemsize == 4 else PEAK_F64_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kmat_bound(na, nb, d, itemsize=4):
    """Each input read once, the (na, nb) output written once; a pair costs
    d subtractions, d multiply-adds (2 operations each) and a square root
    (linear phi)."""
    return bound(itemsize * (na * d + nb * d + na * nb), na * nb * (3 * d + 1),
                 itemsize)


def device_ms(fn, names, calls: int = 20) -> float:
    """Device time of one call of ``fn`` in ms: the time torch.profiler
    records for the CUDA kernels whose names contain one of ``names``,
    over ``calls`` calls, divided by the calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.device_time_total for ev in prof.key_averages()
                if any(n in ev.key for n in names))
    check(total > 0, f"torch.profiler recorded no device time for {names}")
    return total / 1e3 / calls


def matvec_bound(m, n, d, c, itemsize=4):
    """Inputs read once and the (m, c) output written once; a pair costs
    the distance's 3d + 1 operations and one multiply-add a column."""
    return bound(itemsize * (m * d + n * d + n * c + m * c),
                 m * n * (3 * d + 1 + 2 * c))


GUARD = -7.5   # what the cells around a kernel matrix's block hold


def kmat_case(rk, gen, dev, na, nb, d, phi, dtype, eps=0.7, timed=False,
              check_rows=None, square=False, pad=None):
    """The kernel matrix against its plain version in f64 (``square``: xb
    is xa, and the diagonal must be exactly phi(0)), and a bit-identical
    rerun; with ``timed``, its times beside the bound and the library.

    Without ``pad`` the call is ``pairwise_kernel_matrix``. With it (square
    only), the call is ``_pairwise_kernel_matrix_into`` on the top-left
    (na, na) block of an (na + pad)^2 matrix laid out as ``rbf_fit`` lays
    out its saddle matrix, and the cells around the block must keep their
    GUARD value."""
    from corrla_rs_tpu_torch.ops.interp import _padded_square

    xa = torch.randn(na, d, generator=gen, device=dev, dtype=dtype)
    xb = xa if square else torch.randn(nb, d, generator=gen, device=dev,
                                       dtype=dtype)
    rows = na if check_rows is None else min(na, check_rows)
    what = f"pairwise_kernel_matrix {phi} {dtype} {na}x{nb} d={d}"
    if pad is None:
        def call():
            return rk.pairwise_kernel_matrix(xa, xb, phi, eps)
        full = call()
        again = call()
    else:
        big = _padded_square(na + pad, dtype, dev).fill_(GUARD)
        what += (f" into the block of a {na + pad}^2 matrix with rows "
                 f"{big.stride(0)} apart")
        full = big[:na, :nb]

        def call():
            return rk._pairwise_kernel_matrix_into(full, xa, xb, phi, eps)
        call()
        twin = _padded_square(na + pad, dtype, dev).fill_(GUARD)
        again = rk._pairwise_kernel_matrix_into(twin[:na, :nb], xa, xb, phi,
                                                eps)
        check(bool((big[na:] == GUARD).all())
              and bool((big[:na, nb:] == GUARD).all()),
              f"{what}: a guard cell was written")
    check(torch.equal(full, again), f"{what}: a rerun differs")
    del again
    if square:
        phi0 = rk.rbf_kernel_eval(torch.zeros(1, dtype=dtype, device=dev),
                                  phi, eps)
        check(bool((torch.diagonal(full) == phi0).all()),
              f"{what}: the diagonal is not exactly phi(0)")
    got = full[:rows]
    want = rk.pairwise_kernel_matrix_ref(xa[:rows].double(), xb.double(), phi,
                                         eps)
    err = (got.double() - want).abs()
    rtol = KMAT_RTOL[dtype]
    ok = bool((err <= rtol * (want.abs() + want.abs().max())).all())
    check(ok and bool(torch.isfinite(got).all()),
          f"{what}: max err {err.max().item():.3e}")
    out = {"max_abs_err": err.max().item(), "store": rk._kmat_store_path(full),
           "checked_rows": rows}
    del got, want, err
    if timed:
        out["ms"] = cuda_ms(call)
        out["profile"] = lambda: device_ms(call, ("kernel_matrix_kernel",))
        out["plain_ms"] = cuda_ms(
            lambda: rk.pairwise_kernel_matrix_ref(xa, xb, phi, eps))
        out["bound_ms"], out["bound_by"] = kmat_bound(na, nb, d,
                                                      xa.element_size())
        out["share"] = out["bound_ms"] / out["ms"]
        # the one-call PyTorch equivalent (linear phi: the distances)
        out["library_ms"] = cuda_ms(lambda: torch.cdist(
            xa, xb, compute_mode="donot_use_mm_for_euclid_dist")) \
            if phi == "linear" else None
    return out


def kmat_view_case(rk, gen, dev, phi, dtype, ld, off, na=1000, nb=2000,
                   d=3, eps=0.7):
    """The kernel matrix into a block of a larger matrix: right, and the
    guard cells around the block untouched. Returns the store path."""
    xa = torch.randn(na, d, generator=gen, device=dev, dtype=dtype)
    xb = torch.randn(nb, d, generator=gen, device=dev, dtype=dtype)
    big = torch.full((na + 2, ld), GUARD, dtype=dtype, device=dev)
    view = big[1:na + 1, off:off + nb]
    rk._pairwise_kernel_matrix_into(view, xa, xb, phi, eps)
    want = rk.pairwise_kernel_matrix_ref(xa.double(), xb.double(), phi, eps)
    err = (view.double() - want).abs()
    guard = torch.ones_like(big, dtype=torch.bool)
    guard[1:na + 1, off:off + nb] = False
    check(bool((err <= KMAT_RTOL[dtype] * (want.abs() + want.abs().max()))
               .all()) and bool((big[guard] == GUARD).all()),
          f"pairwise_kernel_matrix into a ({na + 2}, {ld}) matrix at column "
          f"{off}, {phi} {dtype}: max err {err.max().item():.3e} or a guard "
          "cell written")
    return rk._kmat_store_path(view)


def matvec_case(rk, gen, dev, m, n, d, c, phi, dtype, eps=0.7, check_rows=None,
                timed=False, uniform=False):
    draw = torch.rand if uniform else torch.randn
    q = draw(m, d, generator=gen, device=dev, dtype=dtype)
    x = draw(n, d, generator=gen, device=dev, dtype=dtype)
    coef = torch.randn(n, c, generator=gen, device=dev, dtype=dtype)
    rows = m if check_rows is None else min(m, check_rows)
    got = rk.rbf_matvec(q, x, coef, phi, eps)
    check(got.shape == (m, c) and bool(torch.isfinite(got).all()),
          f"rbf_matvec {phi} {dtype}: bad output")
    check(torch.equal(got, rk.rbf_matvec(q, x, coef, phi, eps)),
          f"rbf_matvec {phi} {dtype} {m}x{n} d={d} C={c}: a rerun differs")
    qd, xd, cd = q[:rows].double(), x.double(), coef.double()
    want = rk.rbf_matvec_ref(qd, xd, cd, phi, eps)
    # every phi is >= 0, so sum_j |phi_ij c_j| = K |c|
    scale = rk.rbf_matvec_ref(qd, xd, cd.abs(), phi, eps)
    err = (got[:rows].double() - want).abs()
    rtol = MATVEC_RTOL[dtype]
    check(bool((err <= rtol * scale + 1e-30).all()),
          f"rbf_matvec {phi} {dtype} {m}x{n} d={d} C={c}: max err "
          f"{err.max().item():.3e}, worst ratio "
          f"{(err / scale).max().item():.3e} > {rtol}")
    out = {"max_abs_err": err.max().item()}
    del got, want, scale, err
    if timed:
        out["ms"] = cuda_ms(lambda: rk.rbf_matvec(q, x, coef, phi, eps))
        out["plain_ms"] = cuda_ms(
            lambda: rk.rbf_matvec_ref(q, x, coef, phi, eps))
        out["bound_ms"], out["bound_by"] = matvec_bound(m, n, d, c,
                                                        q.element_size())
        out["library_ms"] = None   # no one PyTorch call: cdist, then a GEMM
    return out


def phase_kernels(rk, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_checks = 0
    stores = set()
    for dtype in (torch.float32, torch.float64):
        for phi in PHIS:
            # ragged rows (direct stores), aligned ones (TMA), d templated
            # (1-8) and the runtime loop (20), and a square one
            for na, nb, d in ((7, 13, 2), (1000, 1537, 3), (130, 70, 20),
                              (2001, 2003, 8), (300, 256, 5)):
                stores.add(kmat_case(rk, gen, dev, na, nb, d, phi,
                                     dtype)["store"])
                n_checks += 1
            kmat_case(rk, gen, dev, 500, 500, 1, phi, dtype, square=True)
            # blocks of a larger matrix: a 16-byte row stride and base
            # (TMA), an odd stride, an 8-byte offset, and rows 2,002 floats
            # apart, alternately 16- and 8-byte aligned (direct)
            for ld, off in ((2052, 0), (2003, 0), (2052, 2), (2002, 0)):
                stores.add(kmat_view_case(rk, gen, dev, phi, dtype, ld, off))
                n_checks += 2
            # d = 1..4 templated and 5, 20 the runtime loop; each of these
            # splits the support (1 x 100,000 in 265 splits), the RbfInterp
            # shape below does not
            for m, n, d, c in ((7, 13, 2, 1), (1000, 1537, 3, 8),
                               (1000, 1537, 3, 37), (300, 200, 20, 3),
                               (1, 100_000, 1, 1), (513, 2001, 4, 20),
                               (130, 700, 5, 2)):
                matvec_case(rk, gen, dev, m, n, d, c, phi, dtype)
                n_checks += 1
    check(stores == {"tma", "direct"},
          f"the kernel matrix's odd shapes took only {stores}")
    print(f"    odd shapes: {n_checks} cases, all 4 phi, f32 and f64 "
          f"(kernel matrix rtol {KMAT_RTOL}, both store paths, reruns "
          f"bit-identical, exact phi(0) diagonals, guard cells untouched; "
          f"matvec rtol {MATVEC_RTOL} of sum |phi c|)", flush=True)
    # the main path's shapes: PodI (d = 1) and RbfInterp (d = 3), f32
    n_snap, _, n_modes, n_pq = SIZES["podi"]
    n_sup, n_q, n_check = SIZES["rbf"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, m, n, _, c, plan in main_path_plans(rk, sms):
        print(f"    matvec plan, {label} {m}x{n} C={c} on {sms} SMs: "
              f"{plan.cols} columns x {plan.col_chunks} chunks, "
              f"{plan.q_blocks} query blocks, {plan.splits} splits of "
              f"{plan.split_len} -> {plan.blocks} blocks"
              f"{', then the sum of splits' if plan.splits > 1 else ''}",
              flush=True)
    n_as, k_as = SIZES["active_ss"][:2]
    # (kernel, label, main path, run): the kernel matrix's main-path shapes
    # are x against itself, called as its callers call it: the two fits
    # into the top-left block of their saddle matrix (poly degree 1 adds
    # d + 1 rows and columns; rows padded to 128 bytes), the kNN through
    # the public wrapper. The f64 shape and the kNN's shape before the
    # active_ss cut are measured beside them
    shapes = [
        ("pairwise_kernel_matrix", f"PodI fit K {n_snap}x{n_snap} d=1", True,
         lambda: kmat_case(rk, gen, dev, n_snap, n_snap, 1, "linear",
                           torch.float32, eps=1.0, timed=True, square=True,
                           pad=2)),
        ("pairwise_kernel_matrix", f"RbfInterp fit K {n_sup}x{n_sup} d=3",
         True,
         lambda: kmat_case(rk, gen, dev, n_sup, n_sup, 3, "linear",
                           torch.float32, eps=1.0, timed=True, square=True,
                           pad=4)),
        ("pairwise_kernel_matrix",
         f"active_ss kNN tile {n_as}x{n_as} d={k_as}", True,
         lambda: kmat_case(rk, gen, dev, n_as, n_as, k_as, "linear",
                           torch.float32, eps=1.0, timed=True, square=True)),
        ("pairwise_kernel_matrix", f"f64 K {n_sup}x{n_sup} d=3", False,
         lambda: kmat_case(rk, gen, dev, n_sup, n_sup, 3, "linear",
                           torch.float64, eps=1.0, timed=True, square=True)),
        ("pairwise_kernel_matrix", "kNN tile before the cut 32768x32768 d=8",
         False,
         lambda: kmat_case(rk, gen, dev, 32768, 32768, 8, "linear",
                           torch.float32, eps=1.0, timed=True,
                           check_rows=1024, square=True)),
        ("rbf_matvec", f"PodI predict {n_pq} q x {n_snap} s d=1 C={n_modes}",
         True,
         lambda: matvec_case(rk, gen, dev, n_pq, n_snap, 1, n_modes,
                             "linear", torch.float32, eps=1.0, timed=True,
                             uniform=True)),
        ("rbf_matvec", f"RbfInterp predict {n_q} q x {n_sup} s d=3 C=1",
         True,
         lambda: matvec_case(rk, gen, dev, n_q, n_sup, 3, 1, "linear",
                             torch.float32, eps=1.0, check_rows=n_check,
                             timed=True, uniform=True)),
    ]
    results = []
    for name, label, main, run in shapes:
        results.append((name, label, main, run()))
        torch.cuda.empty_cache()
    # the wrappers' host cost a call, at 64 points (kernels of a few µs)
    x = torch.rand(64, 1, generator=gen, device=dev)
    k = torch.empty(64, 64, device=dev)
    c = torch.rand(64, 1, generator=gen, device=dev)
    costs = {
        "pairwise_kernel_matrix": host_us(
            lambda: rk.pairwise_kernel_matrix(x, x, "linear", 1.0)),
        "_pairwise_kernel_matrix_into": host_us(
            lambda: rk._pairwise_kernel_matrix_into(k, x, x, "linear", 1.0)),
        "rbf_matvec": host_us(lambda: rk.rbf_matvec(x, x, c, "linear", 1.0)),
    }
    print("    host time a call at 64 points (best of 3 x 5000 calls): "
          + ", ".join(f"{n} {us:.2f} us" for n, us in costs.items()),
          flush=True)
    # device times last: a torch.profiler run may leave launches slower for
    # the rest of the process, and the per-call and host times above are
    # host-bound at the small shapes
    for _, _, _, res in results:
        if "profile" in res:
            res["device_ms"] = res.pop("profile")()
            res["device_share"] = res["bound_ms"] / res["device_ms"]
            torch.cuda.empty_cache()
    timings = {"pairwise_kernel_matrix": [], "rbf_matvec": []}
    for name, label, main, res in results:
        res["host_us_64"] = costs[name]
        lib = ("none" if res["library_ms"] is None
               else f"{res['library_ms']:.4f} ms")
        kmat = ""
        if name == "pairwise_kernel_matrix":
            kmat = (f"  device {res['device_ms']:.4f} ms  store "
                    f"{res['store']}  share of bound {res['share']:.3f} per "
                    f"call, {res['device_share']:.3f} device  checked "
                    f"{res['checked_rows']} rows")
        print(f"    {name:24s} {label:44s} kernel {res['ms']:.4f} ms{kmat}  "
              f"plain {res['plain_ms']:.4f} ms  library {lib}  bound "
              f"{res['bound_ms']:.4f} ms ({res['bound_by']})  max|err| "
              f"{res['max_abs_err']:.3e}", flush=True)
        timings[name].append({"shape": label, "main_path": main, **res})
    return timings


# ---------------------------------------------------------------------------
# phases 4-7: the main path

def orthonormal(n, k, gen, dev, center=False):
    g = torch.randn(n, k, generator=gen, device=dev, dtype=torch.float32)
    if center:
        g -= g.mean(dim=0, keepdim=True)
    return torch.linalg.qr(g).Q


def rsvd_matrix(dev, gen):
    """A = U diag(s) V^T of the rsvd and single_pass phases, and s."""
    n, m, _, _, _, n_sig = SIZES["rsvd"]
    s_true = torch.logspace(0, -3, n_sig, dtype=torch.float64, device=dev)
    u0 = orthonormal(n, n_sig, gen, dev)
    v0 = orthonormal(m, n_sig, gen, dev)
    return (u0 * s_true.float()) @ v0.mT, s_true


def phase_rsvd(port, a, s_true):
    n, m, rank, n_iter, n_os, _ = SIZES["rsvd"]
    (_, s_cold, _), cold = wall(lambda: port.rsvd(a, rank, n_iter, n_os,
                                                  seed=1))
    warm_s = []
    for _ in range(3):
        (u, s, vt), sec = wall(lambda: port.rsvd(a, rank, n_iter, n_os,
                                                 seed=1))
        warm_s.append(sec)
    check(u.shape == (n, rank) and s.shape == (rank, 1)
          and vt.shape == (rank, m), "rsvd shapes")
    check(all(bool(torch.isfinite(t).all()) for t in (u, s, vt)),
          "rsvd non-finite output")
    rel = ((s[:, 0].double() - s_true[:rank]).abs() / s_true[:rank]).max()
    tol = 1e-3
    check(rel.item() <= tol, f"rsvd sigma rel err {rel.item():.3e} > {tol}")
    return {"sigma_rel_err": rel.item(), "cold_s": cold,
            "warm_s": sorted(warm_s)}


def phase_single_pass(port, a, s_true):
    """single_pass_svd and block_krylov_svd on the rsvd phase's matrix.

    The matrix's sigma fall by 3.4% an index, so the tail beyond the 110
    sketch columns holds 2.6 times sigma_100: without a power iteration the
    last sigma of a single pass at 10 oversamples are off by 10-15%. At
    that setting the leading half is held to 5e-2 and all of them to 0.25;
    a second call with SIZES["single_pass_os"] oversamples holds all of
    them to 5e-2."""
    n, m, rank, _, n_os, _ = SIZES["rsvd"]
    more_os = SIZES["single_pass_os"]
    eye = torch.eye(rank, device=a.device)
    out = {}
    # name, call, tolerance on the leading n_held sigma, n_held, tolerance
    # on all of them
    runs = ((f"single_pass ({n_os} oversamples)",
             lambda: port.single_pass_svd(a, rank, n_os, key=1),
             5e-2, rank // 2, 0.25),
            (f"single_pass ({more_os} oversamples)",
             lambda: port.single_pass_svd(a, rank, more_os, key=1),
             5e-2, rank, 5e-2),
            (f"block_krylov ({n_os} oversamples)",
             lambda: port.block_krylov_svd(
                 a, rank, SIZES["krylov_iters"], n_os, key=1),
             1e-3, rank, 1e-3))
    for name, fn, tol, n_held, tol_all in runs:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, cold = wall(fn)
        warm = []
        for _ in range(3):
            (u, s, vt), sec = wall(fn)
            warm.append(sec)
        peak = torch.cuda.max_memory_allocated() - base
        check(u.shape == (n, rank) and s.shape == (rank,)
              and vt.shape == (rank, m), f"{name} shapes")
        check(all(bool(torch.isfinite(t).all()) for t in (u, s, vt)),
              f"{name} non-finite output")
        rel = (s.double() - s_true[:rank]).abs() / s_true[:rank]
        held, worst = rel[:n_held].max().item(), rel.max().item()
        orth = (u.mT @ u - eye).abs().max().item()
        check(held <= tol, f"{name}: leading {n_held} sigma rel err "
              f"{held:.3e} > {tol}")
        check(worst <= tol_all,
              f"{name}: sigma rel err {worst:.3e} > {tol_all}")
        check(orth <= 1e-4, f"{name}: |U^T U - I| {orth:.3e} > 1e-4")
        out[name] = {"held": held, "n_held": n_held, "tol": tol,
                     "worst": worst, "tol_all": tol_all, "orth": orth,
                     "cold_s": cold, "warm_s": sorted(warm),
                     "peak_mb": peak / 2 ** 20}
        del u, s, vt
    return out


def phase_rpca(port, dev, gen):
    n, m, rank, n_sig = SIZES["rpca"]
    s_true = torch.logspace(3, 1, n_sig, dtype=torch.float64, device=dev)
    u0 = orthonormal(n, n_sig, gen, dev, center=True)
    v0 = orthonormal(m, n_sig, gen, dev)
    mu = torch.randn(1, m, generator=gen, device=dev)
    x = mu + (u0 * s_true.float()) @ v0.mT
    (s, comps), sec = wall(lambda: port.rpca(x, rank, seed=2))
    check(s.shape == (rank, 1) and comps.shape == (rank, m), "rpca shapes")
    rel = ((s[:, 0].double() - s_true[:rank]).abs() / s_true[:rank]).max()
    align = (comps.double() * v0[:, :rank].mT.double()).sum(1).abs().min()
    tol = 1e-3
    check(rel.item() <= tol, f"rpca sigma rel err {rel.item():.3e} > {tol}")
    check(1 - align.item() <= tol,
          f"rpca components off the true directions: {1 - align.item():.3e}")
    del x, u0, v0, comps
    return {"sigma_rel_err": rel.item(), "component_gap": 1 - align.item(),
            "wall_s": sec}


def pod_family(t, s):
    return torch.exp(-t * s) + 0.3 * torch.sin(2 * math.pi * s * t)


def phase_podi(port, rk, dev, gen):
    n_snap, n_pts, n_modes, n_q = SIZES["podi"]
    t = torch.linspace(0, 1, n_snap, device=dev)[:, None]
    s = torch.linspace(0, 1, n_pts, device=dev)[None, :]
    x = pod_family(t, s)
    pod, fit_s = wall(lambda: port.PyPodI(x, t, n_modes, key=3))
    del x
    tq = torch.rand(n_q, 1, generator=gen, device=dev).sort(dim=0).values
    y, pred_s = wall(lambda: pod.predict(tq))
    check(y.shape == (n_pts, n_q) and bool(torch.isfinite(y).all()),
          "PodI prediction shape / finite")
    truth = pod_family(tq, s).mT
    rel = (torch.linalg.matrix_norm(y - truth)
           / torch.linalg.matrix_norm(truth)).item()
    tol = 1e-3
    check(rel <= tol, f"PodI vs family rel err {rel:.3e} > {tol}")
    # the RBF step against the plain path, in f64 on the same coefficients
    c = pod._rbf_coeffs.double()
    n = pod.t_abscissa.shape[0]
    tq64, t64 = tq.double(), pod.t_abscissa.double()
    w_ref = (rk.rbf_matvec_ref(tq64, t64, c[:n], "linear", 1.0)
             + torch.cat([tq64, torch.ones_like(tq64)], 1) @ c[n:])
    y_ref = pod.modes.double() @ w_ref.mT
    rel_plain = (torch.linalg.matrix_norm(y.double() - y_ref)
                 / torch.linalg.matrix_norm(y_ref)).item()
    tol_plain = 1e-4
    check(rel_plain <= tol_plain,
          f"PodI kernel vs plain path rel err {rel_plain:.3e} > {tol_plain}")
    del y, truth, y_ref
    return {"truth_rel_err": rel, "plain_rel_err": rel_plain, "fit_s": fit_s,
            "predict_s": pred_s}


def rbf_target(x):
    return torch.sin(2 * x[:, 0]) + x[:, 1] * x[:, 2]


def phase_rbf(port, rk, dev, gen):
    n, n_q, n_check = SIZES["rbf"]
    x = torch.rand(n, 3, generator=gen, device=dev)
    y = rbf_target(x)
    rbf, fit_s = wall(
        lambda: port.PyRbfInterp(1, 1.0, dim=3, poly_degree=1).fit(x, y))
    resid = (torch.linalg.vector_norm(rbf.predict(x)[:, 0] - y)
             / torch.linalg.vector_norm(y)).item()
    tol_resid = 1e-4
    check(resid <= tol_resid, f"RbfInterp fit residual {resid:.3e}")
    xq = torch.rand(n_q, 3, generator=gen, device=dev)
    times = []
    for _ in range(3):
        yq, sec = wall(lambda: rbf.predict(xq))
        times.append(sec)
    check(yq.shape == (n_q, 1) and bool(torch.isfinite(yq).all()),
          "RbfInterp prediction shape / finite")
    truth_err = (torch.linalg.vector_norm(yq[:, 0] - rbf_target(xq))
                 / torch.linalg.vector_norm(rbf_target(xq))).item()
    check(truth_err <= 1e-2, f"RbfInterp vs target rel err {truth_err:.3e}")
    # first 8192 predictions against the plain f64 path, same coefficients
    c = rbf.coeffs.double()
    q64, x64 = xq[:n_check].double(), x.double()
    ones = torch.ones(n_check, 1, dtype=torch.float64, device=dev)
    want = (rk.rbf_matvec_ref(q64, x64, c[:n], "linear", 1.0)
            + torch.cat([q64, ones], 1) @ c[n:])
    scale = (rk.rbf_matvec_ref(q64, x64, c[:n].abs(), "linear", 1.0)
             + torch.cat([q64, ones], 1).abs() @ c[n:].abs())
    ratio = ((yq[:n_check].double() - want).abs() / scale).max().item()
    check(ratio <= MATVEC_RTOL[torch.float32],
          f"RbfInterp predict vs plain f64: worst err / scale {ratio:.3e}")
    return {"fit_s": fit_s, "fit_residual": resid, "truth_rel_err": truth_err,
            "predict_1M_s": sorted(times), "plain_ratio": ratio}



# ---------------------------------------------------------------------------
# phases 8-10: the slice of DMDc, active subspaces and the samplers

def latent_system(n_t: int, seed: int):
    """z_{t+1} = M z_t + G u_t in f64 on the host: 8 latent states in four
    rotation blocks of radii 0.995-0.97, turned by a random orthogonal Q;
    u = a sine and a damped cosine. Returns (z (8, n_t), u (2, n_t))."""
    gen = torch.Generator().manual_seed(seed)
    m = torch.zeros(8, 8, dtype=torch.float64)
    for i, (r, w) in enumerate(((0.995, 0.05), (0.99, 0.11), (0.98, 0.23),
                                (0.97, 0.4))):
        m[2 * i:2 * i + 2, 2 * i:2 * i + 2] = r * torch.tensor(
            [[math.cos(w), -math.sin(w)], [math.sin(w), math.cos(w)]],
            dtype=torch.float64)
    q = torch.linalg.qr(torch.randn(8, 8, generator=gen,
                                    dtype=torch.float64)).Q
    m = q @ m @ q.T
    g = 0.1 * torch.randn(8, 2, generator=gen, dtype=torch.float64)
    t = torch.arange(n_t, dtype=torch.float64)
    u = torch.stack([torch.sin(0.07 * t),
                     torch.exp(-0.002 * t) * torch.cos(0.031 * t)])
    z = torch.empty(8, n_t, dtype=torch.float64)
    z[:, 0] = torch.randn(8, generator=gen, dtype=torch.float64)
    for k in range(n_t - 1):
        z[:, k + 1] = m @ z[:, k] + g @ u[:, k]
    return z, u


def lifted(z, n_x, gen, dev, batch=None):
    """x = Phi z in f32 with Phi (n_x, 8) orthonormal (a batch of them)."""
    shape = (n_x, 8) if batch is None else (batch, n_x, 8)
    phi = torch.linalg.qr(torch.randn(shape, generator=gen, device=dev,
                                      dtype=torch.float64)).Q
    return (phi @ z.to(dev)).float()


def traj_err(pred, x):
    """max |pred - x[..., 1:]| / max |x| over the rolled steps."""
    n = pred.shape[-1]
    return ((pred - x[..., 1:n + 1]).abs().max() / x.abs().max()).item()


def phase_dmdc(port, dev, gen, seed):
    n_x, n_t, n_modes, n_iters = SIZES["dmdc"]
    n_steps = n_t - 1
    z, u = latent_system(n_t, seed)
    u = u.float().to(dev)
    x = lifted(z, n_x, gen, dev)
    tol = 1e-3
    model, fit_s = wall(lambda: port.DMDc(x, u, n_modes, n_iters, key=seed))
    out = {"fit_s": fit_s, "lambda_max": float(abs(model.lambdas).max())}
    for method in ("modes", "reduced"):
        pred, sec = wall(lambda: model.predict_multiple(x[:, :1],
                                                        u[:, :n_steps],
                                                        method))
        check(pred.shape == (n_x, n_steps) and bool(torch.isfinite(pred).all()),
              f"DMDc {method} rollout shape / finite")
        err = traj_err(pred, x)
        check(err <= tol, f"DMDc {method} rollout err {err:.3e} > {tol}")
        out[method] = (err, sec)
    del x, model, pred
    torch.cuda.empty_cache()
    # PyDMDc: predict rolls the sequence through the dense (n_x, n_x) A
    xd = lifted(z, SIZES["dmdc_dense"], gen, dev)
    pyd, fit_d = wall(lambda: port.PyDMDc(xd, u, n_modes, n_iters, key=seed))
    pred, sec = wall(lambda: pyd.predict(xd[:, :1], u[:, :n_steps]))
    err = traj_err(pred, xd)
    check(err <= tol, f"PyDMDc dense rollout err {err:.3e} > {tol}")
    out["dense"] = (err, sec, fit_d)
    del xd, pyd, pred
    torch.cuda.empty_cache()
    # the ensemble: members share the latent dynamics, each its own Phi
    n_b, n_xe = SIZES["ensemble"]
    xb = lifted(z, n_xe, gen, dev, batch=n_b)
    ub = u.expand(n_b, -1, -1)
    fit, fit_e = wall(lambda: port.dmdc_fit_ensemble(xb, ub, n_modes,
                                                     n_iters, key=seed))
    for method in ("reduced", "modes"):
        pred, sec = wall(lambda: port.rollout_ensemble(
            fit, xb[:, :, :1], u[:, :n_steps], method))
        err = max(traj_err(pred[i], xb[i]) for i in range(n_b))
        check(err <= tol, f"ensemble {method} rollout err {err:.3e} > {tol}")
        out["ens_" + method] = (err, sec)
    out["ens_fit_s"] = fit_e
    return out


def phase_active_ss(port, dev, gen):
    n, k, n_nbr, n_comps, _ = SIZES["active_ss"]
    x = torch.rand(n, k, generator=gen, device=dev) * 2 - 1
    a = torch.randn(k, generator=gen, device=dev)
    a /= torch.linalg.vector_norm(a)
    y = torch.exp(0.3 * (x @ a))
    (comps, vals, sensi), sec = wall(lambda: port.active_ss(x, y, 2, n_nbr,
                                                            n_comps))
    check(comps.shape == (k, n_comps) and vals.shape == (k, n_comps)
          and sensi.shape == (k,), "active_ss shapes")
    check(all(bool(torch.isfinite(t).all()) for t in (comps, vals, sensi)),
          "active_ss non-finite output")
    gap = 1.0 - abs(float(comps[:, 0].double() @ a.double()))
    tol = 1e-3
    check(gap <= tol, f"active_ss leading direction: 1-|cos| {gap:.3e} > {tol}")
    return {"wall_s": sec, "gap": gap, "x": x, "y": y}


def phase_samplers(port, dev, seed):
    from corrla_rs_tpu_torch.ops import samplers

    n, ndim, chunk = SIZES["dirichlet"]
    bounds = np.asarray(DIRICHLET_BOUNDS)
    out = {}
    s, sec = wall(lambda: port.cs_dirichlet_sample(
        bounds, n, 500, chunk, 1.0, np.ones(ndim), seed=seed, device=dev))
    check(s.shape == (n, ndim) and s.device == dev,
          "cs_dirichlet_sample shape / device")
    sum_err = (s.sum(1) - 1.0).abs().max().item()
    b = torch.as_tensor(bounds, device=dev, dtype=s.dtype)
    inside = bool(((s >= b[:, 0]) & (s <= b[:, 1])).all())
    check(sum_err <= 1e-6 and inside,
          f"cs_dirichlet_sample sums {sum_err:.3e} / inside bounds {inside}")
    # acceptance of one device chunk, and a numpy rejection reference
    gen = torch.Generator(device=dev).manual_seed(seed)
    zs = samplers._draw_dirichlet(gen, chunk, torch.ones(ndim, device=dev),
                                  True, torch.float64, dev)
    acc = ((zs >= b[:, 0]) & (zs <= b[:, 1])).all(1).double().mean().item()
    rng = np.random.default_rng(seed)
    e = rng.exponential(size=(2_000_000, ndim))
    ref = e / e.sum(1, keepdims=True)
    ref = ref[((ref >= bounds[:, 0]) & (ref <= bounds[:, 1])).all(1)]
    mean, var = s.mean(0).cpu().numpy(), s.var(0).cpu().numpy()
    z_max = float(np.max(np.abs(mean - ref.mean(0)) / np.sqrt(
        var / n + ref.var(0) / len(ref))))
    check(0.05 <= acc <= 0.5, f"acceptance {acc:.3f} outside 5-50%")
    check(z_max <= 4.0, f"coordinate means {z_max:.2f} standard errors off")
    out["dirichlet"] = (sec, acc, sum_err, z_max, len(ref))
    # DEMC: 1,024 seed chains and the reference scale on the card, then the
    # reference scale asked for on the CPU (the C++ host route)
    for label, (chains, gens), where in DEMC_RUNS:
        where = dev if where == "cuda" else torch.device(where)
        (smp, ar), sec = wall(lambda: port.cs_mcmc_dirichlet_sample(
            DEMC_BOUNDS, gens, chains, 500, chunk if chains >= 512 else
            20000, 1.0, np.ones(3), 0.8, 1e-12, seed=seed, device=where))
        route = "device" if isinstance(smp, torch.Tensor) else "host C++"
        if where.type == "cuda":
            check(route == "device" and smp.device == where,
                  f"DEMC {label}: asked for {where}, ran on the {route} route")
        smp = torch.as_tensor(smp)
        check(smp.shape == (gens * chains, 3), f"DEMC {label} shape")
        sum_err = (smp.sum(1) - 1.0).abs().max().item()
        check(sum_err <= 1e-6 and 0.3 <= ar <= 0.7,
              f"DEMC {label}: sums {sum_err:.3e}, acceptance {ar:.3f}")
        out[label] = (sec, ar, sum_err, route)
    return out


def detail_active_ss(rk, dev, x, y):
    """Times of the kNN and grads steps alone, and the kNN against its
    plain version on the first queries under the tie rule."""
    from corrla_rs_tpu_torch.models.active_subspaces import local_poly_grads
    from corrla_rs_tpu_torch.ops.knn import knn

    _, _, n_nbr, _, n_chk = SIZES["active_ss"]
    (_, idx), knn_s = wall(lambda: knn(x, x, n_nbr))
    y2 = y[:, None]
    _, grads_s = wall(lambda: local_poly_grads(x[idx], y2[idx], x, 2))
    xq = x[:n_chk]
    d_k, i_k = knn(xq, x, n_nbr)
    dist = rk.pairwise_kernel_matrix_ref(xq.double(), x.double(), "linear")
    d_r, i_r = torch.topk(dist, n_nbr, dim=1, largest=False, sorted=True)
    kth = d_r[:, -1:]
    mark_k = torch.zeros_like(dist, dtype=torch.bool).scatter_(1, i_k, True)
    mark_r = torch.zeros_like(dist, dtype=torch.bool).scatter_(1, i_r, True)
    differ = mark_k ^ mark_r
    near_tie = (dist - kth).abs() <= KNN_TIE_RTOL * kth
    bad = int((differ & ~near_tie).sum())
    tied_rows = int(differ.any(1).sum())
    d_err = ((d_k.double() - torch.gather(dist, 1, i_k)).abs()
             / torch.gather(dist, 1, i_k).clamp_min(1e-30)).max().item()
    check(bad == 0, f"kNN: {bad} neighbours differ from plain beyond ties")
    check(d_err <= KMAT_RTOL[torch.float32],
          f"kNN distances vs f64: rel err {d_err:.3e}")
    return {"knn_s": knn_s, "grads_s": grads_s, "tied_rows": tied_rows,
            "dist_rel_err": d_err}


def detail_rbf_fit(rk, dev, gen):
    """RbfInterp's fit at the main path's size, its saddle matrix built two
    ways: concatenated from K, P, P^T and 0, as before the kernel matrix
    wrote K in place (K is read and written twice more), and filled in
    place as ``rbf_fit`` does. The best of 3 CUDA-synchronised walls each,
    for the assembly alone and for the whole fit (with the LU solve)."""
    from corrla_rs_tpu_torch.ops import interp
    from corrla_rs_tpu_torch.ops.stats_corr import build_full_vandermonde

    n = SIZES["rbf"][0]
    x = torch.rand(n, 3, generator=gen, device=dev)
    y = rbf_target(x)[:, None]

    def by_cat():
        k = rk.pairwise_kernel_matrix(x, x, "linear", 1.0)
        p = build_full_vandermonde(x, 1)
        q = p.shape[1]
        return torch.cat([torch.cat([k, p], dim=1),
                          torch.cat([p.mT, p.new_zeros((q, q))], dim=1)])

    def in_place():
        p = build_full_vandermonde(x, 1)
        q = p.shape[1]
        kp = interp._padded_square(n + q, x.dtype, dev)
        rk._pairwise_kernel_matrix_into(kp[:n, :n], x, x, "linear", 1.0)
        kp[:n, n:] = p
        kp[n:, :n] = p.mT
        kp[n:, n:] = 0
        return kp

    def fit_by_cat():
        kp = by_cat()
        y_pad = torch.cat([y, y.new_zeros((kp.shape[0] - n, 1))])
        return torch.linalg.solve(kp, y_pad)

    check(torch.equal(by_cat(), in_place()),
          "the saddle matrix filled in place differs from the concatenation")
    out = {}
    for key, fn in (("asm_cat", by_cat), ("asm", in_place),
                    ("fit_cat", fit_by_cat),
                    ("fit", lambda: interp.rbf_fit(x, y, "linear", 1.0, 1)),
                    ("asm_cat2", by_cat), ("asm2", in_place)):
        out[key] = min(wall(fn)[1] for _ in range(3))
    before, after = fit_by_cat(), interp.rbf_fit(x, y, "linear", 1.0, 1)
    out["fit_rel_diff"] = ((after - before).abs().max()
                           / before.abs().max()).item()
    return out


def detail_demc(dev, seed):
    """Per-generation time of DEMC at the device route's population."""
    from corrla_rs_tpu_torch.ops import samplers

    chains, gens = SIZES["demc"]
    seeds = samplers.constr_dirichlet_sample(
        DEMC_BOUNDS, chains, 500, SIZES["dirichlet"][2], key=seed, device=dev)
    ln_post = samplers.ln_like_sum(samplers.ln_like_dirichlet(np.ones(3)),
                                   samplers.ln_prior_uniform(DEMC_BOUNDS))
    _, sec = wall(lambda: samplers.demc_run(
        seeds, ln_post, gens, 0.8, 1e-12, seed,
        lambda v: v / torch.sum(v)))
    return sec / gens * 1e3

# ---------------------------------------------------------------------------
# phases 11-13: DREAM, the factorizations on the RSVD core, the MLE layer

def phase_dream(port, dev, seed):
    from corrla_rs_tpu_torch.ops.dream import dream_run

    chains, d, gens, n_adapt = SIZES["dream"]
    cov = torch.tensor([[1.0, 0.6, 0.3], [0.6, 1.0, 0.5], [0.3, 0.5, 1.0]],
                       dtype=torch.float64, device=dev)
    prec = torch.linalg.inv(cov).float()

    def ln_prob(x):
        return -0.5 * (x @ prec @ x)

    heads = np.random.default_rng(seed).standard_normal(
        (chains, d)).astype(np.float32) * 3.0
    # the first call warms the allocator and the vmap machinery up
    wall(lambda: dream_run(heads, ln_prob, 20, key=seed, n_adapt=n_adapt))
    (hist, state), sec = wall(lambda: dream_run(heads, ln_prob, gens,
                                                key=seed, n_adapt=n_adapt))
    check(hist.device == dev and hist.shape == (gens, chains, d)
          and bool(torch.isfinite(hist).all()),
          "dream history device / shape / finite")
    accept = int(state.n_accept) / (gens * chains)
    check(0.15 <= accept <= 0.6, f"dream acceptance {accept:.3f} outside "
          "0.15-0.6")
    tail = hist[n_adapt:].double()
    pooled = tail.reshape(-1, d)
    sd = torch.sqrt(torch.diagonal(cov))
    mean_err = (pooled.mean(0).abs() / sd).max().item()
    cov_err = ((torch.cov(pooled.T) - cov).abs().max() / cov.abs().max()).item()
    check(mean_err <= 0.05, f"dream pooled mean {mean_err:.3e} sigma off")
    check(cov_err <= 0.10, f"dream covariance {cov_err:.3e} off (tol 0.10)")
    rhat, rhat_s = wall(lambda: port.rank_normalized_rhat(tail))
    check(rhat.device == dev and rhat.max().item() < 1.05,
          f"dream rank-normalized R-hat {rhat.tolist()} >= 1.05")
    return {"wall_s": sec, "ms_gen": sec / gens * 1e3,
            "samples_s": gens * chains / sec, "accept": accept,
            "mean_err": mean_err, "cov_err": cov_err,
            "rhat": rhat.max().item(), "rhat_s": rhat_s,
            "p_cr": [round(v, 4) for v in state.p_cr.tolist()]}


def low_rank(n, m, s, gen, dev, dtype=torch.float32):
    """U diag(s) V^T with orthonormal U (n, k), V (m, k)."""
    u = torch.linalg.qr(torch.randn(n, len(s), generator=gen, device=dev,
                                    dtype=dtype)).Q
    v = torch.linalg.qr(torch.randn(m, len(s), generator=gen, device=dev,
                                    dtype=dtype)).Q
    return (u * s.to(device=dev, dtype=dtype)) @ v.mT


def rel_fro(got, want):
    return (torch.linalg.matrix_norm(got - want)
            / torch.linalg.matrix_norm(want)).item()


def phase_factorize(port, dev, gen, seed):
    out = {}
    tol = {k: v[0] for k, v in FACTORIZE_TOL.items()}

    def done(name, sec, err, extra=""):
        check(err <= tol[name], f"{name}: {err:.3e} > {tol[name]} {extra}")
        out.setdefault(name, []).append((sec, err, extra))
        torch.cuda.empty_cache()

    # Nystrom, in f64: rank 100 with a tail ten thousand times below the
    # last kept. (In f32 the core Cholesky meets cond ~ lambda_1 / (eps
    # ||Y||) ~ 1/eps on such a spectrum and the small pairs are lost, in
    # the JAX package too; its f32 test holds three leading values.)
    n, rank, n_os = SIZES["nystrom"]
    ev = torch.cat([torch.logspace(2, 0, rank, dtype=torch.float64),
                    1e-4 * 0.9 ** torch.arange(100, dtype=torch.float64)]
                   ).to(dev)
    q = torch.linalg.qr(torch.randn(n, len(ev), generator=gen, device=dev,
                                    dtype=torch.float64)).Q
    a = (q * ev) @ q.mT
    (lam, vec), sec = wall(lambda: port.nystrom_eigh(a, rank, n_os, key=seed))
    err = ((lam - ev[:rank]).abs() / ev[:rank]).max().item()
    align = (vec * q[:, :rank]).sum(0).abs().min().item()
    check(align >= 1 - 1e-3, f"nystrom eigenvectors: min |cos| {align:.6f}")
    done("nystrom", sec, err, f"eigenvalues of {n}^2 f64, min |cos| of the "
         f"eigenvectors {align:.6f}")
    del a, q, vec

    # column ID and CUR of an exactly rank-50 matrix
    n, m, rank = SIZES["cur"]
    a = torch.randn(n, rank, generator=gen, device=dev) @ torch.randn(
        rank, m, generator=gen, device=dev) / rank ** 0.5
    (cols, x), sec = wall(lambda: port.column_id(a, rank, key=seed))
    pinned = bool((x[:, cols] == torch.eye(rank, device=dev)).all())
    check(pinned and len(set(cols.tolist())) == rank,
          "column_id: x[:, cols] is not I, or a column repeats")
    done("id_cur", sec, rel_fro(a[:, cols] @ x, a), f"column_id {n}x{m}")
    (rows, cols, u), sec = wall(lambda: port.cur(a, rank, key=seed))
    done("id_cur", sec, rel_fro(a[:, cols] @ u @ a[rows], a), f"cur {n}x{m}")
    del a, x, u

    # HOSVD of a cube of exact multilinear rank
    side, rank = SIZES["hosvd"]
    core0 = torch.randn(rank, rank, rank, generator=gen, device=dev)
    t = core0
    for mode in range(3):
        f0 = torch.linalg.qr(torch.randn(side, rank, generator=gen,
                                         device=dev)).Q
        t = port.mode_multiply(t, f0, mode)
    (core, factors), sec = wall(lambda: port.hosvd(t, (rank,) * 3, key=seed))
    check(core.shape == (rank,) * 3, "hosvd core shape")
    orth = max((f.mT @ f - torch.eye(rank, device=dev)).abs().max().item()
               for f in factors)
    check(orth <= tol["hosvd"], f"hosvd factors: |U^T U - I| {orth:.3e}")
    rec = port.tucker_reconstruct(core, factors)
    done("hosvd", sec, (torch.linalg.vector_norm(rec - t)
                        / torch.linalg.vector_norm(t)).item(),
         f"{side}^3 at ranks {(rank,) * 3}")
    del t, rec, core, factors

    # trace and log-determinant of a well-conditioned SPD matrix
    n, n_decay, ny_rank = SIZES["spd"]
    g = torch.randn(n, n, generator=gen, device=dev)
    w = g @ g.mT / n + torch.eye(n, device=dev)
    del g
    tr_true = torch.trace(w.double()).item()
    ld_true = torch.linalg.slogdet(w.double()).logabsdet.item()
    est, sec = wall(lambda: port.hutchpp_trace(w, 96, key=seed))
    done("hutchpp", sec, abs(est - tr_true) / abs(tr_true), f"{n}^2")
    est, sec = wall(lambda: port.slq_logdet(w, 24, 40, key=seed))
    done("slq", sec, abs(est - ld_true) / abs(ld_true), f"{n}^2")
    del w

    # sketched least squares against the dense solver, in f64
    n, m = SIZES["lstsq"]
    a = low_rank(n, m, torch.logspace(0, -1, m, dtype=torch.float64), gen,
                 dev, torch.float64)
    b = a @ torch.randn(m, generator=gen, device=dev, dtype=torch.float64) \
        + 0.01 * torch.randn(n, generator=gen, device=dev,
                             dtype=torch.float64)
    # CGLS gains a factor of about 2 an iteration at 4 sketch rows a column
    # (measured on the card at this shape: 6.6e-9 of the first residual
    # after the default 30), so 50 iterations for an answer to 1e-9
    (x, hist), sec = wall(lambda: port.sketched_lstsq(a, b, n_iters=50,
                                                      key=seed))
    x_ref, ref_s = wall(lambda: torch.linalg.lstsq(a, b[:, None]).solution)
    check(hist[-1].item() < 1e-10 * hist[0].item(), "sketched_lstsq did not "
          "converge")
    done("lstsq", sec, (x - x_ref[:, 0]).abs().max().item(),
         f"{n}x{m} f64, torch.linalg.lstsq {ref_s:.4f} s")
    del a, b

    # CG on a regularised fast-decay system, plain and Nystrom-preconditioned
    mu = 1e-3
    lam = 100.0 * 0.9 ** torch.arange(n_decay, dtype=torch.float64)
    n = SIZES["spd"][0]
    q = torch.linalg.qr(torch.randn(n, n_decay, generator=gen, device=dev,
                                    dtype=torch.float64)).Q
    k = (q * lam.to(dev)) @ q.mT
    sys_mat = k + mu * torch.eye(n, device=dev, dtype=torch.float64)
    b = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)

    def iters_to_tol(res, rel_tol=1e-8):
        rel = res.residual_norms[:, 0] / torch.linalg.vector_norm(b)
        hit = torch.nonzero(rel <= rel_tol)
        return int(hit[0]) if len(hit) else 10 ** 9

    plain, plain_s = wall(lambda: port.cg_solve(sys_mat, b, n_iters=2000,
                                                tol=1e-10))
    pre, pre_s = wall(lambda: port.nystrom_preconditioner(k, ny_rank, mu,
                                                          key=seed))
    fast, sec = wall(lambda: port.cg_solve(sys_mat, b, n_iters=2000,
                                           tol=1e-10, preconditioner=pre))
    it_plain, it_fast = iters_to_tol(plain), iters_to_tol(fast)
    check(it_fast < 0.1 * it_plain, f"Nystrom PCG took {it_fast} iterations "
          f"against plain CG's {it_plain}")
    done("pcg", sec, (torch.linalg.vector_norm(sys_mat @ fast.x - b)
                      / torch.linalg.vector_norm(b)).item(),
         f"{n}^2 f64: {it_fast} iterations against {it_plain} plain "
         f"({plain_s:.4f} s), preconditioner built in {pre_s:.4f} s")
    del k, sys_mat, q

    # robust PCA: low rank plus sparse, in f64
    n, rank, frac = SIZES["robust_pca"]
    l_true = (torch.randn(n, rank, generator=gen, device=dev,
                          dtype=torch.float64)
              @ torch.randn(rank, n, generator=gen, device=dev,
                            dtype=torch.float64)) / rank ** 0.5
    mask = torch.rand(n, n, generator=gen, device=dev) < frac
    sign = torch.randint(0, 2, (n, n), generator=gen, device=dev) * 2.0 - 1.0
    s_true = torch.where(mask, 10.0 * sign, torch.zeros_like(sign)).double()
    (l_hat, s_hat, info), sec = wall(lambda: port.robust_pca(l_true + s_true))
    support = ((s_hat.abs() > 1e-3) == mask).double().mean().item()
    check(info["rank"] == rank and info["rel_residual"] < 1e-7
          and support > 0.999, f"robust_pca: {info}, support {support:.5f}")
    done("robust_pca", sec, rel_fro(l_hat, l_true),
         f"{n}x{n} f64 rank {rank} + {frac:.0%} sparse: "
         f"{info['iterations']} sweeps, support matched {support:.5f}")
    del l_true, s_true, l_hat, s_hat

    # incremental SVD in blocks against the randomized SVD of the whole
    n, m, blocks, rank, n_chk = SIZES["incremental"]
    # sigma fall by 10% an index: in f32 a Brand update keeps U orthonormal
    # only while the tracked sigma stay well above eps * sigma_1 (at 20% an
    # index and rank 40, U^T U is off by 0.8 in both packages)
    a = low_rank(n, m, 0.9 ** torch.arange(2 * rank, dtype=torch.float64),
                 gen, dev)

    def feed():
        inc = port.IncrementalSvd(rank)
        for blk in torch.chunk(a, blocks, dim=1):
            inc.update(blk)
        return inc

    inc, sec = wall(feed)
    (_, s_ref, _), ref_s = wall(lambda: port.random_svd(a, rank, 8, 10,
                                                        key=seed))
    check(inc.n_cols == m and inc.v.shape == (m, rank),
          "IncrementalSvd state shapes")
    done("incremental", sec,
         ((inc.s[:n_chk] - s_ref[:n_chk]).abs() / s_ref[:n_chk]).max().item(),
         f"{n}x{m} in {blocks} blocks, rank {rank}, leading {n_chk} sigma "
         f"against random_svd ({ref_s:.4f} s)")
    return out


def phase_mle(port, dev, seed):
    from corrla_rs_tpu_torch.ops import univariate_rv as rv

    n, n_kde = SIZES["mle"]
    root_n = n ** 0.5
    out = []

    def fitted(make):
        """(fit, first wall, second wall): the first fit of a process also
        pays torch's run-time compilation of special-function kernels."""
        _, cold = wall(make)
        fit, warm = wall(make)
        return fit, cold, warm

    def held(name, got, want, se, cold, warm):
        z = max(abs(g - w) / e for g, w, e in zip(got, want, se))
        check(z <= 3.0, f"{name}: fitted {got} against {want}, {z:.2f} "
              "standard errors off")
        out.append(f"{name} {tuple(round(g, 4) for g in got)} for {want}, "
                   f"{z:.2f} SE, first fit {cold:.4f} s, again {warm:.4f} s")

    x = rv.NormalRv(2.0, 3.0).sample(n, key=seed)
    check(x.device == dev, "NormalRv.sample is not on the card")
    fit, cold, warm = fitted(lambda: rv.NormalRv(0.0, 1.0).mlfit(x))
    held("NormalRv", (fit.mu, fit.std), (2.0, 3.0),
         (3.0 / root_n, 3.0 / (2 * n) ** 0.5), cold, warm)
    x = rv.BetaRv(2.0, 5.0).sample(n, key=seed + 1)
    fit, cold, warm = fitted(lambda: rv.BetaRv(1.0, 1.0).mlfit(x, method=2))
    tri = lambda v: float(torch.special.polygamma(1, torch.tensor(
        v, dtype=torch.float64)))
    fisher = n * torch.tensor([[tri(2.0) - tri(7.0), -tri(7.0)],
                               [-tri(7.0), tri(5.0) - tri(7.0)]],
                              dtype=torch.float64)
    se = torch.sqrt(torch.diagonal(torch.linalg.inv(fisher))).tolist()
    held("BetaRv", (fit.alpha, fit.beta), (2.0, 5.0), se, cold, warm)
    x = rv.ExponentialRv(2.5).sample(n, key=seed + 2)
    fit, cold, warm = fitted(lambda: rv.ExponentialRv(1.0).mlfit(x))
    held("ExponentialRv", (fit.lam,), (2.5,), (2.5 / root_n,), cold, warm)
    # the KDE of a two-component mixture: its cdf against the empirical one
    # at the deciles, and its pdf's integral
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    pts = torch.randn(n_kde, generator=gen, device=dev, dtype=torch.float64)
    pts = torch.where(torch.rand(n_kde, generator=gen, device=dev) < 0.3,
                      pts * 0.5 + 4.0, pts)
    kde, sec = wall(lambda: port.build_kde(0.5, pts, key=seed))
    check(kde.supports.device == dev, "build_kde is not on the card")
    probs = torch.linspace(0.1, 0.9, 9, dtype=torch.float64, device=dev)
    cdf_err = (kde.cdf(torch.quantile(pts, probs)) - probs).abs().max().item()
    grid = torch.linspace(-8.0, 12.0, 4001, dtype=torch.float64, device=dev)
    mass = torch.trapezoid(kde.pdf(grid), grid).item()
    check(cdf_err <= 0.02 and abs(mass - 1.0) <= 1e-3,
          f"build_kde: cdf off by {cdf_err:.3e} at the deciles, pdf "
          f"integrates to {mass:.5f}")
    out.append(f"build_kde on {n_kde} points: bandwidth {kde.bandwidth:.4f}, "
               f"cdf within {cdf_err:.3e} of the empirical deciles (tol "
               f"0.02), pdf integral {mass:.5f} (tol 1e-3), {sec:.4f} s")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of every input (default 0)")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this check runs on an NVIDIA GPU", file=sys.stderr)
        return 2

    # 1. device
    t0 = time.perf_counter()
    import corrla_rs_tpu_torch as port
    from corrla_rs_tpu_torch.ops import _build
    from corrla_rs_tpu_torch.ops import rbf_kernels as rk

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    report("device", t0, f"{torch.cuda.get_device_name(dev)} | nvidia-smi: "
           f"{smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
           "TF32 off")

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    info = _build.build_info()
    rows = ptxas_rows(info.get("log", ""))
    matvec_registers(rows, main_path_plans(
        rk, torch.cuda.get_device_properties(dev).multi_processor_count))
    kmat_registers(rows)
    report("build", t0, f"{'built' if info.get('built') else 'loaded'} "
           f"{info['path']} nvcc {info.get('seconds', 0.0):.1f} s "
           f"({len(_build._sources())} sources at once); "
           f"{ptxas_summary(rows)}")

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    timings = phase_kernels(rk, dev, args.seed)
    report("kernels", t0, "both kernels agree with their plain versions")

    # 4-7. the main path (single_pass rides on rsvd's matrix), with the
    # launch counts from 0
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    rk.pairwise_kernel_matrix.launches = 0
    rk.rbf_matvec.launches = 0

    t0 = time.perf_counter()
    a, s_true = rsvd_matrix(dev, gen)
    r = phase_rsvd(port, a, s_true)
    report("rsvd", t0, f"100000x10000 f32 rank 100: max sigma rel err "
           f"{r['sigma_rel_err']:.3e} (tol 1e-3); cold {r['cold_s']:.4f} s, "
           f"warm {', '.join(f'{v:.4f}' for v in r['warm_s'])} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    r = phase_single_pass(port, a, s_true)
    report("single_pass", t0, "the same matrix, rank 100: "
           + "; ".join(
               f"{name} leading {v['n_held']} sigma rel err {v['held']:.3e} "
               f"(tol {v['tol']}), all 100 {v['worst']:.3e} (tol {v['tol_all']}), "
               f"|U^T U - I| {v['orth']:.1e} (tol 1e-4), cold "
               f"{v['cold_s']:.4f} s, warm "
               f"{', '.join(f'{w:.4f}' for w in v['warm_s'])} s, peak "
               f"{v['peak_mb']:.0f} MiB beside the matrix"
               for name, v in r.items()))
    del a, s_true
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    r = phase_rpca(port, dev, gen)
    report("rpca", t0, f"200000x512 f32 rank 20: max sigma rel err "
           f"{r['sigma_rel_err']:.3e}, component gap "
           f"{r['component_gap']:.3e} (tol 1e-3); {r['wall_s']:.4f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    r = phase_podi(port, rk, dev, gen)
    report("PodI", t0, f"2000x200000 f32, 20 modes, 512 held-out t: rel err "
           f"vs family {r['truth_rel_err']:.3e} (tol 1e-3), vs plain RBF "
           f"path {r['plain_rel_err']:.3e} (tol 1e-4); fit "
           f"{r['fit_s']:.4f} s, predict {r['predict_s']:.4f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    r = phase_rbf(port, rk, dev, gen)
    report("RbfInterp", t0, f"16384 pts 3-D linear: fit residual "
           f"{r['fit_residual']:.3e} (tol 1e-4), fit {r['fit_s']:.4f} s; "
           f"1048576 predictions {', '.join(f'{v:.4f}' for v in r['predict_1M_s'])} s, "
           f"vs target {r['truth_rel_err']:.3e} (tol 1e-2), first 8192 vs "
           f"plain f64: err/scale {r['plain_ratio']:.3e} "
           f"(tol {MATVEC_RTOL[torch.float32]})")

    first = {"pairwise_kernel_matrix": rk.pairwise_kernel_matrix.launches,
             "rbf_matvec": rk.rbf_matvec.launches}
    for name, count in first.items():
        check(count > 0, f"{name} was not launched on the main path")
    print(f"[launches] ok  rsvd/rpca/PodI/RbfInterp: {first}", flush=True)
    torch.cuda.empty_cache()

    # 8-10. this slice's path, with the launch counts from 0 again
    rk.pairwise_kernel_matrix.launches = 0
    rk.rbf_matvec.launches = 0

    t0 = time.perf_counter()
    r = phase_dmdc(port, dev, gen, args.seed + 2)
    n_x, n_t, n_modes, _ = SIZES["dmdc"]
    report("dmdc", t0, f"{n_x}x{n_t} f32, 2 controls, {n_modes} modes: fit "
           f"{r['fit_s']:.4f} s (max |lambda| {r['lambda_max']:.4f}); "
           f"{n_t - 1}-step rollouts, err / max|x| (tol 1e-3): modes "
           f"{r['modes'][0]:.3e} in {r['modes'][1]:.4f} s "
           f"({r['modes'][1] / (n_t - 1) * 1e3:.4f} ms a step), reduced "
           f"{r['reduced'][0]:.3e} in {r['reduced'][1]:.4f} s "
           f"({r['reduced'][1] / (n_t - 1) * 1e3:.4f} ms a step); PyDMDc dense "
           f"A at {SIZES['dmdc_dense']}: fit {r['dense'][2]:.4f} s, "
           f"{r['dense'][0]:.3e} in {r['dense'][1]:.4f} s; ensemble "
           f"{SIZES['ensemble'][0]}x{SIZES['ensemble'][1]}: fit "
           f"{r['ens_fit_s']:.4f} s, reduced {r['ens_reduced'][0]:.3e} in "
           f"{r['ens_reduced'][1]:.4f} s, modes {r['ens_modes'][0]:.3e} in "
           f"{r['ens_modes'][1]:.4f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ass = phase_active_ss(port, dev, gen)
    n, k, n_nbr, _, _ = SIZES["active_ss"]
    report("active_ss", t0, f"{n} samples {k}-D, order 2, {n_nbr} nbrs: "
           f"1-|cos(w1, a)| {ass['gap']:.3e} (tol 1e-3); "
           f"{ass['wall_s']:.4f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    r = phase_samplers(port, dev, args.seed + 3)
    n, ndim, chunk = SIZES["dirichlet"]
    sec, acc, sum_err, z_max, n_ref = r["dirichlet"]
    lines = [f"cs_dirichlet_sample {n}x{ndim} chunk {chunk}: {sec:.4f} s, "
             f"acceptance {acc:.4f}, max |sum-1| {sum_err:.1e}, means within "
             f"{z_max:.2f} SE of numpy ({n_ref} rows; tol 4)"]
    for label, (chains, gens), where in DEMC_RUNS:
        sec, ar, sum_err, route = r[label]
        lines.append(f"cs_mcmc_dirichlet_sample {chains} chains x {gens} on "
                     f"{where}: route {route}, {sec:.4f} s, acceptance "
                     f"{ar:.4f} (0.3-0.7), max |sum-1| {sum_err:.1e}")
    report("samplers", t0, "; ".join(lines))

    second = {"pairwise_kernel_matrix": rk.pairwise_kernel_matrix.launches,
              "rbf_matvec": rk.rbf_matvec.launches}
    check(second["pairwise_kernel_matrix"] > 0,
          "pairwise_kernel_matrix was not launched by the kNN of active_ss")
    print(f"[launches] ok  dmdc/active_ss/samplers: {second}", flush=True)
    torch.cuda.empty_cache()

    # 11-13. this slice's path; it reaches no kernel, and the counts show it
    rk.pairwise_kernel_matrix.launches = 0
    rk.rbf_matvec.launches = 0

    t0 = time.perf_counter()
    r = phase_dream(port, dev, args.seed + 4)
    chains, d, gens, n_adapt = SIZES["dream"]
    report("dream", t0, f"{chains} chains x {d} dims x {gens} generations "
           f"({n_adapt} adapting) f32: {r['wall_s']:.4f} s, "
           f"{r['ms_gen']:.4f} ms a generation, {r['samples_s']:.4e} "
           f"samples/s; acceptance {r['accept']:.4f} (0.15-0.6), pooled mean "
           f"{r['mean_err']:.3e} sigma off (tol 0.05), covariance "
           f"{r['cov_err']:.3e} off (tol 0.10), rank-normalized R-hat "
           f"{r['rhat']:.4f} (< 1.05, {r['rhat_s']:.4f} s), p_cr {r['p_cr']}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    r = phase_factorize(port, dev, gen, args.seed + 5)
    report("factorize", t0, "; ".join(
        f"{name} {extra}: {err:.3e} (tol {FACTORIZE_TOL[name][0]}, "
        f"{FACTORIZE_TOL[name][1]}) in {sec:.4f} s"
        for name, rows in r.items() for sec, err, extra in rows))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    r = phase_mle(port, dev, args.seed + 6)
    report("mle", t0, "; ".join(r))

    third = {"pairwise_kernel_matrix": rk.pairwise_kernel_matrix.launches,
             "rbf_matvec": rk.rbf_matvec.launches}
    check(not any(third.values()),
          f"dream/factorize/mle launched a kernel: {third}")
    print(f"[launches] ok  dream/factorize/mle (no kernel on this path): "
          f"{third}", flush=True)
    torch.cuda.empty_cache()

    # timing details and the kNN against its plain version (not counted)
    t0 = time.perf_counter()
    fit_r = detail_rbf_fit(rk, dev, gen)
    torch.cuda.empty_cache()
    knn_r = detail_active_ss(rk, dev, ass["x"], ass["y"])
    torch.cuda.empty_cache()
    gen_ms = detail_demc(dev, args.seed + 3)
    report("details", t0, f"RbfInterp fit at {SIZES['rbf'][0]} points: "
           f"saddle matrix concatenated (before) {fit_r['fit_cat']:.4f} s, "
           f"filled in place (after) {fit_r['fit']:.4f} s; assembly alone "
           f"{fit_r['asm_cat'] * 1e3:.3f} / {fit_r['asm_cat2'] * 1e3:.3f} ms "
           f"against {fit_r['asm'] * 1e3:.3f} / {fit_r['asm2'] * 1e3:.3f} ms "
           "(the same matrix, bit for bit; coefficients differ by "
           f"{fit_r['fit_rel_diff']:.1e} of their largest); "
           f"active_ss kNN {knn_r['knn_s']:.4f} s, grads step "
           f"{knn_r['grads_s']:.4f} s; kNN vs plain f64 on "
           f"{SIZES['active_ss'][4]} queries: {knn_r['tied_rows']} rows "
           f"differ only at near-ties (gap < {KNN_TIE_RTOL} rel), distance "
           f"rel err {knn_r['dist_rel_err']:.3e}; DEMC generation at "
           f"{SIZES['demc'][0]} chains {gen_ms:.4f} ms")

    # a kernel's numbers are those of its largest main-path shape (by
    # bound); "shapes" holds every timed shape, "launches" both paths'
    # counts
    paths = {"rsvd/rpca/PodI/RbfInterp": first,
             "dmdc/active_ss/samplers": second,
             "dream/factorize/mle": third}
    table = {"kernels": []}
    for name in ("pairwise_kernel_matrix", "rbf_matvec"):
        top = max((row for row in timings[name] if row["main_path"]),
                  key=lambda row: row["bound_ms"])
        table["kernels"].append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": sum(p[name] for p in paths.values()),
            "launches_by_path": {k: p[name] for k, p in paths.items()},
            **{key: top[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")},
            "shapes": timings[name]})
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
