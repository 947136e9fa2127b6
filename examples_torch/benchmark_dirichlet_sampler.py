"""Constrained-sampler benchmark on the port: the workload of
``examples/benchmark_dirichlet_sampler.py``.

Reference configs:
- rejection sampling (benchmark_dirichlet_sampler.py:104-131): 3-D
  U234/U235/U238 bounds, 3,000 samples, chunk 1e6, <= 500 shots, vs a
  pure-python rejection loop;
- hybrid MCMC (benchmark_dirichlet_sampler.py:68-87): 12 seed samples,
  gamma=0.8, eps=1e-12, alpha=0.6, 3,000 samples + acceptance ratio.

Plus the DREAM throughput demo (north-star kernel, not in the reference).

Route: on a CUDA device the hybrid sampler runs its DEMC on the card; only
``--device cpu`` takes the C++ host pipeline (``native.py``), as the JAX
package does for small populations on the host. The script prints which.

Run:  python examples_torch/benchmark_dirichlet_sampler.py [--device cpu]
"""
# (the JAX script's enable_persistent_cache, an XLA compile cache, has no
# counterpart here)
import time

import numpy as np
import torch

import _harness as h
from corrla_rs_tpu_torch import cs_dirichlet_sample, cs_mcmc_dirichlet_sample
from corrla_rs_tpu_torch.ops.dream import dream_run

BOUNDS = np.array([[0.0, 0.0026], [0.1955, 0.1995], [0.80, 0.825]])


def py_rejection(bounds, n_samples, max_zshots=500, chunk=1_000_000):
    """Pure-python rejection baseline (reference harness :6-50)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(max_zshots):
        z = rng.dirichlet(np.ones(len(bounds)), size=chunk)
        ok = np.all((bounds[:, 0] <= z) & (z <= bounds[:, 1]), axis=1)
        out.extend(z[ok])
        if len(out) >= n_samples:
            return np.asarray(out[:n_samples])
    raise RuntimeError("not enough samples")


def main(argv=None):
    ap = h.parser(__doc__)
    ap.add_argument("--samples", type=int, default=3_000)
    ap.add_argument("--chunk", type=int, default=1_000_000)
    ap.add_argument("--chains", type=int, default=8192,
                    help="DREAM chains of the throughput demo")
    ap.add_argument("--gens", type=int, default=1000,
                    help="DREAM generations of the throughput demo")
    args = ap.parse_args(argv)
    dev = h.start(args, "benchmark_dirichlet_sampler")

    n, chunk = args.samples, args.chunk
    # corrla rejection sampler (on device); the first call pays the
    # one-time costs (CUDA context, allocator)
    t0 = time.perf_counter()
    s = cs_dirichlet_sample(BOUNDS, n, 500, chunk, 1.0, np.ones(3))
    _ = float(s[-1, 0])
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    s = cs_dirichlet_sample(BOUNDS, n, 500, chunk, 1.0, np.ones(3), seed=1)
    _ = float(s[-1, 0])
    t_dev = time.perf_counter() - t0
    sum_err = float(torch.max(torch.abs(torch.sum(s, 1) - 1.0)))
    print(f"cs_dirichlet_sample: {t_dev:.3f} s for {n} samples"
          f" (first call: {t_first:.1f} s;"
          f" sum check: {sum_err:.1e})")

    t0 = time.perf_counter()
    _sp = py_rejection(BOUNDS, n, chunk=chunk)
    print(f"pure-python rejection: {time.perf_counter()-t0:.3f} s")

    # hybrid MCMC (reference config: 12 seeds, gamma .8, eps 1e-12, a=.6)
    t0 = time.perf_counter()
    smc, ar = cs_mcmc_dirichlet_sample(
        BOUNDS, n, 12, 500, chunk, 1.0, np.full(3, 0.6), 0.8, 1e-12
    )
    _ = float(smc[-1, 0])
    t_mcmc = time.perf_counter() - t0
    route = ("C++ host pipeline (native.py)" if isinstance(smc, np.ndarray)
             else f"DEMC on {smc.device}")
    print(f"cs_mcmc_dirichlet_sample: {t_mcmc:.3f} s,"
          f" {smc.shape[0]} samples, acceptance ratio {ar:.3f};"
          f" route: {route}")

    # DREAM throughput (north-star kernel)
    def lnp(x):
        return -0.5 * torch.sum(x**2)

    heads0 = torch.as_tensor(
        np.random.default_rng(1).standard_normal((args.chains, 3)),
        dtype=torch.float32, device=dev)
    hist, state = dream_run(heads0, lnp, args.gens, key=0, n_adapt=100)
    _ = float(state.heads[0, 0])
    t0 = time.perf_counter()
    hist, state = dream_run(heads0, lnp, args.gens, key=1, n_adapt=100)
    _ = float(state.heads[0, 0]) + float(hist[-1, 0, 0])
    dt = time.perf_counter() - t0
    rate = args.chains * args.gens / dt / 1e6
    print(f"DREAM: {rate:.2f} M samples/s"
          f" ({args.chains} chains x {args.gens} gens in {dt:.3f} s)")
    ok = sum_err < 1e-5 and 0.0 < ar < 1.0 and bool(
        torch.isfinite(hist).all())
    h.finish("benchmark_dirichlet_sampler", dev, ok,
             f"rejection {t_dev:.4g} s; hybrid MCMC {t_mcmc:.4g} s on "
             f"{route}, acceptance {float(ar):.3f}; DREAM {rate:.4g} M "
             "samples/s",
             {"rejection_s": t_dev, "mcmc_s": t_mcmc, "mcmc_route": route,
              "acceptance": float(ar), "dream_msamples_s": rate})


if __name__ == "__main__":
    main()
