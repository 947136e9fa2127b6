"""Active-subspace benchmark on the port: the workload of
``examples/benchmark_active_ss.py``, the README demo config
(readme.md:104-110) plus the anisotropic quality fixture from the reference
test suite (active_subspaces.rs:324-385). The kNN launches the kernel
matrix.

Run:  python examples_torch/benchmark_active_ss.py [--device cpu]
"""
# (the JAX script's enable_persistent_cache, an XLA compile cache, has no
# counterpart here)
import numpy as np

import _harness as h
from corrla_rs_tpu_torch import active_ss
from corrla_rs_tpu_torch.utils.tracing import timed


def main(argv=None):
    ap = h.parser(__doc__)
    ap.add_argument("--samples", type=int, default=1000)
    args = ap.parse_args(argv)
    dev = h.start(args, "benchmark_active_ss")
    rng = np.random.default_rng(0)

    # README demo shapes: x (1000, 10), order 1, 30 neighbors, 8 comps
    n = args.samples
    x = rng.standard_normal((n, 10)).astype(np.float32)
    y = rng.standard_normal((n, 1)).astype(np.float32)
    wall, (comps, vals, sensi) = timed(lambda: active_ss(x, y, 1, 30, 8))
    print(f"active_ss ({n} x 10, order 1): {wall:.4f} s;"
          f" comps {tuple(comps.shape)}, sensi {h.host(sensi).round(3)}")

    # quality fixture: y = 0.2 x1 + 0.5 x2^2 + 0.1 x3 x1 -> x2 dominates
    cov = np.array([[0.9, 0.5, 0.5], [0.5, 0.9, 0.5], [0.5, 0.5, 0.9]])
    xs = rng.multivariate_normal(np.zeros(3), cov, size=400).astype(np.float32)
    ys = (0.2 * xs[:, 0] + 0.5 * xs[:, 1] ** 2
          + 0.1 * xs[:, 2] * xs[:, 0])[:, None].astype(np.float32)
    wall2, (c2, v2, s2) = timed(lambda: active_ss(xs, ys, 2, 14, 2))
    s2 = h.host(s2)
    dominant = bool(s2[1] > s2[0] and s2[1] > s2[2])
    print(f"anisotropic fixture (order 2): {wall2:.4f} s;"
          f" sensitivities = {s2.round(4)}"
          f" (x2 dominant: {dominant})")
    h.finish("benchmark_active_ss", dev, dominant,
             f"active_ss {wall:.4g} s; fixture {wall2:.4g} s, x2 dominant "
             f"{dominant}",
             {"demo_s": wall, "fixture_s": wall2, "x2_dominant": dominant})


if __name__ == "__main__":
    main()
