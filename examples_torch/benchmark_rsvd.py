"""RSVD benchmark on the port: the workload of ``examples/benchmark_rsvd.py``.

Reference config (benchmark_rsvd.py:62-110): 100,000 x 10,000 Gaussian
matrix, rank 4, 8 power iterations, 10 oversamples, compared against the
pure-numpy implementation of the same algorithm. Also runs the rank-100
north-star config. The matrix is drawn on the device.

Run:  python examples_torch/benchmark_rsvd.py [--with-numpy] [--device cpu]
"""
# (the JAX script's enable_persistent_cache, an XLA compile cache, has no
# counterpart: nothing is compiled ahead of a call here)
import time

import numpy as np
import torch

import _harness as h
from corrla_rs_tpu_torch import random_svd
from corrla_rs_tpu_torch.utils.tracing import timed


def numpy_rsvd(A, omega_rank=4, n_oversamples=10, power_iter=8, rng=None):
    """Reference-harness numpy algorithm (benchmark_rsvd.py:16-53)."""
    rng = rng or np.random.default_rng(0)
    omega = rng.standard_normal((A.shape[1], omega_rank + n_oversamples))
    Y = A @ omega
    for _ in range(power_iter):
        Y = A @ (A.T @ Y)
    Q, _ = np.linalg.qr(Y)
    B = Q.T @ A
    u_t, s, v = np.linalg.svd(B, full_matrices=False)
    u = Q @ u_t
    return u[:, :omega_rank], s[:omega_rank], v[:omega_rank]


def main(argv=None):
    ap = h.parser(__doc__)
    ap.add_argument("--with-numpy", action="store_true",
                    help="also run the slow CPU numpy baseline")
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--cols", type=int, default=10_000)
    args = ap.parse_args(argv)
    dev = h.start(args, "benchmark_rsvd")

    print(f"device: {dev}")
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((args.rows, args.cols), generator=gen, device=dev,
                    dtype=torch.float32)

    walls = {}
    for rank, label in [(4, "reference config"), (100, "north-star config")]:
        wall, (u, s, vt) = timed(
            lambda: random_svd(a, rank, 8, 10, key=1, stabilize="always",
                               qr_method="cholesky")
        )
        walls[f"rank{rank}_s"] = wall
        print(f"rank-{rank} ({label}): {wall:.4f} s;"
              f" sigma[:4] = {h.host(s[:4])}")
    ok = bool(np.all(np.isfinite(h.host(s))))

    if args.with_numpy:
        an = h.host(a).astype(np.float64)
        t0 = time.perf_counter()
        _u, s_np, _v = numpy_rsvd(an, 4, 10, 8)
        print(f"numpy rank-4: {time.perf_counter()-t0:.2f} s;"
              f" sigma = {s_np}")

    h.finish("benchmark_rsvd", dev, ok,
             f"{args.rows} x {args.cols}: rank 4 {walls['rank4_s']:.4g} s, "
             f"rank 100 {walls['rank100_s']:.4g} s",
             {"shape": [args.rows, args.cols], **walls})


if __name__ == "__main__":
    main()
