"""PCA benchmark on the port: the workload of ``examples/benchmark_pca.py``.

Reference config (benchmark_pca.py:10-34): 10,000 x 12 multivariate-normal
data, 4 components, compared against sklearn PCA when available.

Run:  python examples_torch/benchmark_pca.py [--device cpu]
"""
# (the JAX script's enable_persistent_cache, an XLA compile cache, has no
# counterpart here)
import numpy as np

import _harness as h
from corrla_rs_tpu_torch import rpca
from corrla_rs_tpu_torch.utils.tracing import timed


def main(argv=None):
    ap = h.parser(__doc__)
    ap.add_argument("--rows", type=int, default=10_000)
    args = ap.parse_args(argv)
    dev = h.start(args, "benchmark_pca")

    rng = np.random.RandomState(42)
    cov = np.random.default_rng(0).uniform(0, 1, size=(12, 12))
    cov = cov @ cov.T + np.eye(12)
    x = rng.multivariate_normal(np.zeros(12), cov, size=args.rows).astype(
        np.float32
    )

    wall, (s, comps) = timed(lambda: rpca(x, 4, 4, 6))
    s = h.host(s)
    print(f"corrla rpca: {wall:.4f} s; singular values = {s[:, 0]}")
    metrics = {"rpca_s": wall, "sigma": s[:, 0].tolist()}

    try:
        import time

        from sklearn.decomposition import PCA

        t0 = time.perf_counter()
        sk = PCA(4).fit(np.asarray(x, np.float64))
        print(f"sklearn PCA: {time.perf_counter()-t0:.4f} s;"
              f" singular values = {sk.singular_values_}")
        rel = np.abs(s[:, 0] - sk.singular_values_) / sk.singular_values_
        print(f"sigma rel err vs sklearn: {rel.max():.2e}")
        metrics["sigma_rel_err_vs_sklearn"] = float(rel.max())
    except ImportError:
        print("sklearn not available; skipping comparison")

    h.finish("benchmark_pca", dev, bool(np.all(np.isfinite(s))),
             f"rpca {wall:.4g} s; sigma "
             + ", ".join(f"{v:.6g}" for v in s[:, 0]), metrics)


if __name__ == "__main__":
    main()
