"""DMDc benchmark on the port: the workload of ``examples/benchmark_dmd.py``.

Reference config (benchmark_dmd.py:16-18,116-126): 5,000 x 40 snapshots,
1 control input, 12 modes, 20 RSVD iterations; fit + predict wall-clock,
compared against PyDMD's DMDc when available.

Run:  python examples_torch/benchmark_dmd.py [--device cpu]
"""
# (the JAX script's enable_persistent_cache, an XLA compile cache, has no
# counterpart here)
import numpy as np

import _harness as h
from corrla_rs_tpu_torch import DMDc
from corrla_rs_tpu_torch.utils.tracing import timed


def main(argv=None):
    ap = h.parser(__doc__)
    ap.add_argument("--states", type=int, default=5_000)
    args = ap.parse_args(argv)
    dev = h.start(args, "benchmark_dmd")

    nx, nt = args.states, 40
    x = np.linspace(0.0, 10.0, nx)
    t = np.linspace(0.0, 10.0, nt)
    u_seq = np.exp(0.2 * t)[None, :]
    snaps = np.sin(x[:, None] + 0.2 * t[None, :]) * u_seq
    snaps = snaps.astype(np.float32)
    u_seq32 = u_seq.astype(np.float32)

    wall_fit, model = timed(lambda: DMDc(snaps, u_seq32, 12, 20), n_runs=1)
    print(f"DMDc fit ({nx} x {nt}, 12 modes, 20 iters): {wall_fit:.4f} s")

    x0 = snaps[:, 0:1]
    wall_pred, pred = timed(lambda: model.predict_multiple(x0, u_seq32))
    err = float(np.abs(h.host(pred)[:, 19] - snaps[:, 20]).max())
    print(f"DMDc predict: {wall_pred:.4f} s; max abs err @ step 20: {err:.4f}")

    try:
        import time

        from pydmd import DMDc as PyDMDc

        t0 = time.perf_counter()
        ref = PyDMDc(svd_rank=12)
        ref.fit(np.asarray(snaps, np.float64), np.asarray(u_seq, np.float64))
        print(f"PyDMD DMDc fit: {time.perf_counter()-t0:.4f} s")
    except ImportError:
        print("pydmd not available; skipping comparison")

    h.finish("benchmark_dmd", dev, bool(np.isfinite(err)),
             f"fit {wall_fit:.4g} s, predict {wall_pred:.4g} s; max abs "
             f"err at step 20 {err:.4g}",
             {"fit_s": wall_fit, "predict_s": wall_pred,
              "max_abs_err_step20": err})


if __name__ == "__main__":
    main()
