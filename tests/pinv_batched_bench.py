"""Time the candidates for the batched pseudoinverse behind ``active_ss``.

Run on a machine with one NVIDIA GPU, from the root of a checkout:

    PYTHONPATH=. python3 tests/pinv_batched_bench.py [--n 32768] [--sub 1024]
    PYTHONPATH=. python3 tests/pinv_batched_bench.py --grid

It builds the local quadratic Vandermondes of ``chip_smoke.py``'s active_ss
phase (``--n`` samples uniform in [-1, 1]^8, 64 neighbours, 45 columns; the
neighbours by ``torch.cdist`` and ``torch.topk``, so no kernel is built) and
times, in f32 and in f64, the pseudoinverse with the semantics of
``ops.mat_utils.pinv`` (every sigma inverted as 1 / (sigma + eps)) by:

- ``svd``: ``mat_utils.pinv``, ``torch.linalg.svd`` of the batch (cuSOLVER
  once a matrix), on the first ``--sub`` matrices;
- ``qr_svd``: batched Householder QR, then the SVD of the 45 x 45 R;
- ``gram_eigh``: ``torch.linalg.eigh`` of the 45 x 45 Gram in f64, sigma the
  root of the eigenvalues floored at 0;
- ``jacobi``: ``mat_utils.pinv_batched``, the one-sided Jacobi as batched
  tensor operations, on all ``--n`` matrices.

``jacobi`` (a fixed number of launches whatever the batch, so the subset
says little) and any candidate whose subset time extrapolates to under 25 s
are also run on all of them. Each is held against ``svd`` in f64 on the subset: the
largest relative error of the fitted coefficients pinv(V) y. Prints one line
a measurement, the nvidia-smi name and power limit, and a JSON summary.

``--grid`` times instead where the Jacobi stops paying: Gaussian matrices of
GRID_SHAPES in f32 and f64, ``svd`` on GRID_SVD_SUB matrices (a loop, so a
time a matrix; also on the batch itself where that takes under 5 s) and
``jacobi`` on batches of GRID_BATCHES (skipped above 2^27 elements), each
the best of two after a warm-up. ``break_even`` is the
Jacobi's seconds over the SVD's seconds a matrix: the batch from which the
Jacobi is the faster. ``ops.mat_utils._fit_pinv`` takes its rule from it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from corrla_rs_tpu_torch.ops.mat_utils import pinv, pinv_batched
from corrla_rs_tpu_torch.ops.stats_corr import build_vandermonde

EPS = 1.0e-14


def qr_svd(a, eps=EPS):
    q, r = torch.linalg.qr(a)
    u, s, vh = torch.linalg.svd(r, full_matrices=False)
    return (vh.mT * (1.0 / (s + eps))[..., None, :]) @ (q @ u).mT


def gram_eigh(a, eps=EPS):
    a64 = a.double()
    lam, v = torch.linalg.eigh(a64.mT @ a64)
    s = torch.sqrt(lam.clamp_min(0.0))
    # A = U S V^T, so pinv = V (S + eps)^-1 U^T with U = A V / S
    coef = 1.0 / ((s + eps) * s.clamp_min(1e-300))
    return ((v * coef[..., None, :]) @ (a64 @ v).mT).to(a.dtype)


def wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def neighbours(x, n_nbr, chunk=4096):
    idx = []
    for start in range(0, x.shape[0], chunk):
        d = torch.cdist(x[start:start + chunk], x)
        idx.append(torch.topk(d, n_nbr, dim=1, largest=False).indices)
    return torch.cat(idx)


GRID_SHAPES = ((16, 8), (64, 16), (64, 45), (64, 64), (128, 64), (256, 128),
               (256, 256))
GRID_BATCHES = (8, 64, 512, 4096)
GRID_SVD_SUB = 32


def grid(gen, dev, smi):
    rows = []
    for dtype in (torch.float32, torch.float64):
        for m, n in GRID_SHAPES:
            a = torch.randn(GRID_SVD_SUB, m, n, generator=gen, device=dev,
                            dtype=dtype)
            wall(lambda: pinv(a[:2]))
            svd_s = min(wall(lambda: pinv(a))[1] for _ in range(2)) \
                / GRID_SVD_SUB
            for batch in GRID_BATCHES:
                if batch * m * n > 2 ** 27:
                    continue
                a = torch.randn(batch, m, n, generator=gen, device=dev,
                                dtype=dtype)
                wall(lambda: pinv_batched(a[:2]))
                sec = min(wall(lambda: pinv_batched(a))[1] for _ in range(2))
                # the SVD on the batch itself where that takes seconds (up
                # to 32 x 32 cuSOLVER's batched routine runs, not a loop)
                measured = svd_s * batch < 5.0
                svd_batch = (min(wall(lambda: pinv(a))[1] for _ in range(2))
                             if measured else svd_s * batch)
                row = {"dtype": str(dtype), "shape": [m, n], "batch": batch,
                       "jacobi_s": sec, "svd_s": svd_batch,
                       "svd_measured_on_the_batch": measured,
                       "svd_ms_a_matrix_of_32": svd_s * 1e3,
                       "break_even": sec / svd_s}
                rows.append(row)
                print(json.dumps(row), flush=True)
            del a
            torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "grid": rows}))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=32768)
    parser.add_argument("--sub", type=int, default=1024)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--grid", action="store_true",
                        help="time the Jacobi against the SVD loop over "
                        "shapes and batch sizes instead")
    args = parser.parse_args()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.grid:
        grid(gen, dev, smi)
        return
    x = torch.rand(args.n, 8, generator=gen, device=dev) * 2 - 1
    a_dir = torch.randn(8, generator=gen, device=dev)
    y = torch.exp(0.3 * (x @ (a_dir / torch.linalg.vector_norm(a_dir))))
    idx = neighbours(x, 64)
    rows = []
    for dtype in (torch.float32, torch.float64):
        van = build_vandermonde(x.to(dtype)[idx], True)     # (n, 64, 45)
        rhs = y.to(dtype)[idx][..., None]
        sub, rhs_sub = van[:args.sub], rhs[:args.sub]
        ref = pinv(sub.double()) @ rhs_sub.double()
        scale = ref.abs().amax(dim=(1, 2), keepdim=True)
        cond = torch.linalg.cond(sub[:64].double()).max().item()
        print(f"{dtype}: {tuple(van.shape)}, cond of the first 64 up to "
              f"{cond:.3e}", flush=True)
        for name, fn in (("svd", pinv), ("qr_svd", qr_svd),
                         ("gram_eigh", gram_eigh), ("jacobi", pinv_batched)):
            wall(lambda: fn(sub[:8]))                        # warm up
            got, sec = wall(lambda: fn(sub))
            err = (((got @ rhs_sub).double() - ref).abs() / scale).max().item()
            row = {"dtype": str(dtype), "name": name, "n": args.sub,
                   "seconds": sec, "ms_a_matrix": sec / args.sub * 1e3,
                   "coeff_rel_err": err}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del got
            if name == "jacobi" or sec / args.sub * args.n < 25.0:
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                best = min(wall(lambda: fn(van))[1]
                           for _ in range(2 if name == "jacobi" else 1))
                row = {"dtype": str(dtype), "name": name, "n": args.n,
                       "seconds": best, "ms_a_matrix": best / args.n * 1e3,
                       "peak_mib": (torch.cuda.max_memory_allocated() - base)
                       / 2 ** 20}
                rows.append(row)
                print(json.dumps(row), flush=True)
        del van, rhs
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "rows": rows}))


if __name__ == "__main__":
    main()
