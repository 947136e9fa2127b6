"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one Hopper GPU (sm_90a),
``nvcc`` and PyTorch built for CUDA:

    python3 chip_smoke.py [--seed N]

Phases, in order; each prints one line with its result, tolerance and wall
time, and any failure raises (exit code != 0):

1. device: name and power limit from nvidia-smi, TF32 off;
2. build: nvcc compiles corrla_rs_tpu_torch/csrc/*.cu (timed);
3. kernels: both CUDA kernels against their plain PyTorch versions (run in
   f64 on the card) for every phi, f32 and f64, at odd shapes and at the
   main path's shapes, with kernel and plain times;
4. rsvd: A = U diag(s) V^T, 100,000 x 10,000 f32 with 200 known geometric
   sigma, rank 100, 8 iterations, 10 oversamples;
5. rpca: 200,000 x 512 f32 with a known centered spectrum, rank 20;
6. PodI: 2,000 snapshots x 200,000 points f32 of a smooth one-parameter
   family, 20 modes, predicted at 512 held-out t against the family;
7. RbfInterp: 16,384 support points in 3-D, linear kernel, poly degree 1
   (K is 16k x 16k f32), fit residual, then 1,048,576 predictions through
   the matvec kernel, the first 8,192 checked against the plain f64 path.

The kernels' launch counts are set to 0 before phase 4 and read after phase
7; both kernels must have launched on the main path. The last lines are the
kernel table as JSON, the nvidia-smi line, and the result JSON. Nothing of
JAX is imported. Without a CUDA device it exits with code 2 and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time

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
}
SOURCE = "corrla_rs_tpu_torch/csrc/rbf_kernels.cu"
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


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` runs after a warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def ptxas_summary(log: str) -> str:
    """Registers / spills per kernel from nvcc's -Xptxas=-v output."""
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
    if not rows:
        return "no ptxas report (library was already built)"
    regs = [r[1] for r in rows if r[1] is not None]
    return (f"{len(rows)} kernels, registers {min(regs)}-{max(regs)}, "
            f"spill bytes {sum(r[2] for r in rows)}")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version

def kmat_case(rk, gen, dev, na, nb, d, phi, dtype, eps=0.7, timed=False):
    xa = torch.randn(na, d, generator=gen, device=dev, dtype=dtype)
    xb = torch.randn(nb, d, generator=gen, device=dev, dtype=dtype)
    got = rk.pairwise_kernel_matrix(xa, xb, phi, eps)
    want = rk.pairwise_kernel_matrix_ref(xa.double(), xb.double(), phi, eps)
    err = (got.double() - want).abs()
    rtol = KMAT_RTOL[dtype]
    ok = bool((err <= rtol * (want.abs() + want.abs().max())).all())
    check(ok and bool(torch.isfinite(got).all()),
          f"pairwise_kernel_matrix {phi} {dtype} {na}x{nb} d={d}: max err "
          f"{err.max().item():.3e}")
    out = {"max_abs_err": err.max().item()}
    del got, want, err
    if timed:
        out["ms"] = cuda_ms(lambda: rk.pairwise_kernel_matrix(xa, xb, phi,
                                                              eps))
        out["plain_ms"] = cuda_ms(
            lambda: rk.pairwise_kernel_matrix_ref(xa, xb, phi, eps))
    return out


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
        out["ms"] = cuda_ms(lambda: rk.rbf_matvec(q, x, coef, phi, eps),
                            reps=3)
        out["plain_ms"] = cuda_ms(
            lambda: rk.rbf_matvec_ref(q, x, coef, phi, eps), reps=2)
    return out


def phase_kernels(rk, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_checks = 0
    for dtype in (torch.float32, torch.float64):
        for phi in PHIS:
            for na, nb, d in ((7, 13, 2), (1000, 1537, 3), (130, 70, 20)):
                kmat_case(rk, gen, dev, na, nb, d, phi, dtype)
                n_checks += 1
            for m, n, d, c in ((7, 13, 2, 1), (1000, 1537, 3, 8),
                               (1000, 1537, 3, 37), (300, 200, 20, 3)):
                matvec_case(rk, gen, dev, m, n, d, c, phi, dtype)
                n_checks += 1
    print(f"    odd shapes: {n_checks} cases, all 4 phi, f32 and f64 "
          f"(kernel matrix rtol {KMAT_RTOL}, matvec rtol {MATVEC_RTOL} of "
          "sum |phi c|)", flush=True)
    # the main path's shapes: PodI (d = 1) and RbfInterp (d = 3), f32
    timings = {}
    n_snap, _, n_modes, n_pq = SIZES["podi"]
    n_sup, n_q, n_check = SIZES["rbf"]
    shapes = [
        ("pairwise_kernel_matrix", f"PodI fit K {n_snap}x{n_snap} d=1",
         lambda: kmat_case(rk, gen, dev, n_snap, n_snap, 1, "linear",
                           torch.float32, eps=1.0, timed=True)),
        ("pairwise_kernel_matrix", f"RbfInterp fit K {n_sup}x{n_sup} d=3",
         lambda: kmat_case(rk, gen, dev, n_sup, n_sup, 3, "linear",
                           torch.float32, eps=1.0, timed=True)),
        ("rbf_matvec", f"PodI predict {n_pq} q x {n_snap} s d=1 C={n_modes}",
         lambda: matvec_case(rk, gen, dev, n_pq, n_snap, 1, n_modes,
                             "linear", torch.float32, eps=1.0, timed=True,
                             uniform=True)),
        ("rbf_matvec", f"RbfInterp predict {n_q} q x {n_sup} s d=3 C=1",
         lambda: matvec_case(rk, gen, dev, n_q, n_sup, 3, 1, "linear",
                             torch.float32, eps=1.0, check_rows=n_check,
                             timed=True, uniform=True)),
    ]
    for name, label, run in shapes:
        res = run()
        print(f"    {name:24s} {label:44s} kernel {res['ms']:.4f} ms  "
              f"plain {res['plain_ms']:.4f} ms  max|err| "
              f"{res['max_abs_err']:.3e}", flush=True)
        timings[name] = res          # the last (largest) shape is reported
        torch.cuda.empty_cache()
    return timings


# ---------------------------------------------------------------------------
# phases 4-7: the main path

def orthonormal(n, k, gen, dev, center=False):
    g = torch.randn(n, k, generator=gen, device=dev, dtype=torch.float32)
    if center:
        g -= g.mean(dim=0, keepdim=True)
    return torch.linalg.qr(g).Q


def phase_rsvd(port, dev, gen):
    n, m, rank, n_iter, n_os, n_sig = SIZES["rsvd"]
    s_true = torch.logspace(0, -3, n_sig, dtype=torch.float64, device=dev)
    u0 = orthonormal(n, n_sig, gen, dev)
    v0 = orthonormal(m, n_sig, gen, dev)
    a = (u0 * s_true.float()) @ v0.mT
    del u0, v0
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
    del a, u, s, vt
    return {"sigma_rel_err": rel.item(), "cold_s": cold,
            "warm_s": sorted(warm_s)}


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
    report("build", t0, f"{'built' if info.get('built') else 'loaded'} "
           f"{info['path']} nvcc {info.get('seconds', 0.0):.1f} s; "
           f"{ptxas_summary(info.get('log', ''))}")

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    timings = phase_kernels(rk, dev, args.seed)
    report("kernels", t0, "both kernels agree with their plain versions")

    # 4-7. the main path, with the launch counts from 0
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    rk.pairwise_kernel_matrix.launches = 0
    rk.rbf_matvec.launches = 0

    t0 = time.perf_counter()
    r = phase_rsvd(port, dev, gen)
    report("rsvd", t0, f"100000x10000 f32 rank 100: max sigma rel err "
           f"{r['sigma_rel_err']:.3e} (tol 1e-3); cold {r['cold_s']:.4f} s, "
           f"warm {', '.join(f'{v:.4f}' for v in r['warm_s'])} s")
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

    launches = {"pairwise_kernel_matrix": rk.pairwise_kernel_matrix.launches,
                "rbf_matvec": rk.rbf_matvec.launches}
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
    print(f"[launches] ok  {launches}", flush=True)

    table = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": timings[name]["max_abs_err"],
         "ms": timings[name]["ms"], "plain_ms": timings[name]["plain_ms"]}
        for name in ("pairwise_kernel_matrix", "rbf_matvec")
    ]}
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
