"""RBF interpolation benchmark on the port: the workload of
``examples/benchmark_rbf_interp.py``: N-D multiquadric interpolation fit +
predict, compared against scipy.interpolate.RBFInterpolator when available.
The fit launches the kernel matrix, the predict the matvec.

Run:  python examples_torch/benchmark_rbf_interp.py [--device cpu]
"""
# (the JAX script's enable_persistent_cache, an XLA compile cache, has no
# counterpart here)
import numpy as np

import _harness as h
from corrla_rs_tpu_torch import RbfInterp
from corrla_rs_tpu_torch.utils.tracing import timed

SCIPY_SLACK = 1.5


def main(argv=None):
    ap = h.parser(__doc__)
    ap.add_argument("--points", type=int, default=2_000)
    ap.add_argument("--queries", type=int, default=500)
    args = ap.parse_args(argv)
    dev = h.start(args, "benchmark_rbf_interp")

    rng = np.random.default_rng(0)
    n_fit, n_query, dim = args.points, args.queries, 3
    x = rng.standard_normal((n_fit, dim)).astype(np.float32)
    y = np.sin(x).sum(axis=1, keepdims=True).astype(np.float32)
    xq = (rng.standard_normal((n_query, dim)) * 0.8).astype(np.float32)
    yq_true = np.sin(xq).sum(axis=1, keepdims=True)

    rbf = RbfInterp(2, 1.0, dim, 1)
    wall_fit, _ = timed(lambda: rbf.fit(x, y), n_runs=1)
    wall_pred, pred = timed(lambda: rbf.predict(xq))
    err = float(np.abs(h.host(pred) - yq_true).max())
    print(f"corrla RbfInterp ({n_fit} pts, {dim}-D): fit {wall_fit:.4f} s,"
          f" predict {wall_pred:.4f} s, max err {err:.4f}")
    metrics = {"fit_s": wall_fit, "predict_s": wall_pred, "max_err": err}

    try:
        import time

        from scipy.interpolate import RBFInterpolator

        t0 = time.perf_counter()
        sp = RBFInterpolator(
            np.asarray(x, np.float64), np.asarray(y, np.float64),
            kernel="multiquadric", epsilon=1.0, degree=1,
        )
        t_fit = time.perf_counter() - t0
        t0 = time.perf_counter()
        sp_pred = sp(np.asarray(xq, np.float64))
        t_pred = time.perf_counter() - t0
        sp_err = float(np.abs(sp_pred - yq_true).max())
        print(f"scipy RBFInterpolator: fit {t_fit:.4f} s,"
              f" predict {t_pred:.4f} s, max err {sp_err:.4f}")
        metrics.update(scipy_fit_s=t_fit, scipy_predict_s=t_pred,
                        scipy_max_err=sp_err)
        # the port's own check (the JAX script has none): the f32 fit
        # within SCIPY_SLACK of scipy's f64 error on the same data
        ok = bool(err <= SCIPY_SLACK * sp_err)
        print(f"check: max err {err:.4f} <= {SCIPY_SLACK} x scipy's "
              f"{sp_err:.4f}: {ok}")
        line = (f"fit {wall_fit:.4g} s, predict {wall_pred:.4g} s, max err "
                f"{err:.4g}; scipy on the host {t_fit:.4g} / {t_pred:.4g} "
                f"s, {sp_err:.4g}")
    except ImportError:
        print("scipy not available; skipping comparison")
        ok = bool(np.isfinite(err))
        line = (f"fit {wall_fit:.4g} s, predict {wall_pred:.4g} s, max err "
                f"{err:.4g}")

    h.finish("benchmark_rbf_interp", dev, ok, line, metrics)


if __name__ == "__main__":
    main()
