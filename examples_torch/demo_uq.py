"""End-to-end UQ workflow on the Ishigami benchmark, on the port: the
workload of ``examples/demo_uq.py``.

The full uncertainty-quantification loop, none of which exists in the
reference:

  1. screen inputs cheaply        (ops.morris, r*(d+1) evaluations)
  2. build a space-filling design (ops.design, scrambled Sobol')
  3. fit surrogates               (ops.pce + ops.gp.SparseGpRegressor; the
                                   sparse GP's distances launch the kernel
                                   matrix)
  4. read sensitivities           (PCE coefficients, analytically)
  5. cross-check on the true model (ops.sobol pick-freeze estimators)
  6. ship the surrogate           (utils.export, a torch.export program)

Run:  python examples_torch/demo_uq.py [--device cpu]
"""
# (the JAX script's enable_persistent_cache, an XLA compile cache, has no
# counterpart here)
import os
import tempfile

import numpy as np
import torch

import _harness as h
from corrla_rs_tpu_torch import (
    PolynomialChaos,
    SparseGpRegressor,
    morris_screening,
    sobol_indices,
    sobol_sample,
)
from corrla_rs_tpu_torch.utils.export import export_model_call, load_exported

BOUNDS = np.array([[-np.pi, np.pi]] * 3)
S1_EXACT = np.array([0.3139, 0.4424, 0.0])
ST_EXACT = np.array([0.5576, 0.4424, 0.2437])


def ishigami(x):
    return (torch.sin(x[:, 0]) + 7.0 * torch.sin(x[:, 1]) ** 2
            + 0.1 * x[:, 2] ** 4 * torch.sin(x[:, 0]))


def main(argv=None):
    ap = h.parser(__doc__)
    ap.add_argument("--design", type=int, default=4096,
                    help="points of the Sobol' design the surrogates fit")
    ap.add_argument("--n-base", type=int, default=16384,
                    help="base samples of the pick-freeze estimators")
    args = ap.parse_args(argv)
    dev = h.start(args, "demo_uq")

    # 1. Morris screening: 4 evaluations per trajectory
    scr = morris_screening(ishigami, BOUNDS, n_traj=128, key=0, n_levels=8)
    print("Morris mu*:", np.round(h.host(scr["mu_star"]), 3),
          "sigma:", np.round(h.host(scr["sigma"]), 3),
          "-> all inputs active")

    # 2-3. qmc design + PCE surrogate
    x = sobol_sample(BOUNDS, args.design, key=1)
    y = ishigami(x)
    pce = PolynomialChaos(9, "uniform", BOUNDS).fit(x, y)
    r2, mean, var = float(pce.r2), float(pce.mean), float(pce.var)
    print(f"PCE(order 9): r2 {r2:.5f}; mean {mean:.4f} "
          f"(exact 3.5); var {var:.3f} (exact 13.845)")

    # 4. analytic Sobol' indices from the PCE coefficients
    pc = pce.sobol_indices()
    print("PCE  S1:", np.round(h.host(pc["s1"]), 3),
          "(exact", S1_EXACT, ")")
    print("PCE  ST:", np.round(h.host(pc["st"]), 3),
          "(exact", ST_EXACT, ")")

    # 5. cross-check with pick-freeze estimators on the true model
    est = sobol_indices(ishigami, BOUNDS, args.n_base, key=2, plan="sobol")
    print("est  S1:", np.round(h.host(est["s1"]), 3),
          " ST:", np.round(h.host(est["st"]), 3))

    # sparse GP surrogate on the same design (non-polynomial alternative)
    gp = SparseGpRegressor("matern52", inducing=128, key=3).fit(x, y)
    xq = sobol_sample(BOUNDS, 512, key=4)
    gp_err = float(torch.max(torch.abs(gp.predict(xq)[0] - ishigami(xq))))
    print(f"SGPR(128 inducing): max err {gp_err:.3f} on held-out qmc points")

    # 6. export the PCE surrogate as a serving program
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ishigami_pce.pt2")
        export_model_call(pce, "predict", (xq,), path)
        serve = load_exported(path)
        delta = float(torch.max(torch.abs(serve(xq) - pce.predict(xq))))
    print(f"exported artifact reproduces the surrogate to {delta:.1e}")
    print("UQ demo OK")
    ok = bool(np.isfinite([r2, mean, var, gp_err, delta]).all())
    h.finish("demo_uq", dev, ok,
             f"PCE r2 {r2:.5f}, mean {mean:.4f}; SGPR max err {gp_err:.4g}; "
             f"export delta {delta:.1e}", {
        "pce_r2": r2, "pce_mean": mean, "pce_var": var,
        "pce_s1": h.host(pc["s1"]).tolist(),
        "est_s1": h.host(est["s1"]).tolist(), "sgpr_max_err": gp_err,
        "export_delta": delta})


if __name__ == "__main__":
    main()
