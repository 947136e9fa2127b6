"""Demo: system identification and mode selection on synthetic data, on the
port: the workload of ``examples/demo_sysid.py``.

Walks the identification chain the reference cannot do at all:
operating input-output data -> OKID Markov parameters -> ERA balanced
realization -> validated forced-response prediction; then optimized
DMD on unequally sampled snapshots and sparsity-promoting mode
selection on an overfit DMD. The data are numpy float64, so the fits run
in float64 on the chosen device.

Run:  python examples_torch/demo_sysid.py [--device cpu]
"""
# (the JAX script's enable_persistent_cache, an XLA compile cache, has no
# counterpart here)
import numpy as np

import _harness as h
from corrla_rs_tpu_torch import DMD, OptDmd, era_okid, spdmd


def main(argv=None):
    args = h.parser(__doc__).parse_args(argv)
    dev = h.start(args, "demo_sysid")
    rng = np.random.default_rng(0)

    # --- a hidden 3-state SISO plant, driven by noise -------------------
    a = np.array([[0.9, 0.2, 0.0], [0.0, 0.7, 0.3], [0.0, 0.0, 0.5]])
    b = np.array([[1.0], [0.5], [-0.3]])
    c = np.array([[1.0, -0.4, 0.2]])
    d = np.array([[0.3]])
    u = rng.standard_normal((1, 1000))
    x = np.zeros(3)
    y = np.empty((1, 1000))
    for t in range(1000):
        y[:, t] = c @ x + d @ u[:, t]
        x = a @ x + b @ u[:, t]

    fit = era_okid(u, y, rank=3, n_markov=30, n_obs=15)
    poles = np.sort(h.host(fit.lambdas).real)
    hsv = h.host(fit.hsv)
    print("ERA/OKID identified poles:", np.round(poles, 6))
    print("          true poles:     ", [0.5, 0.7, 0.9])
    print("Hankel singular values:   ", np.round(hsv, 4))
    u2 = rng.standard_normal((1, 100))
    x = np.zeros(3)
    y2 = np.empty((1, 100))
    for t in range(100):
        y2[:, t] = c @ x + d @ u2[:, t]
        x = a @ x + b @ u2[:, t]
    held_out = float(np.max(np.abs(h.host(fit.predict(u2)) - y2)))
    print("held-out response err:    ", held_out)

    # --- optimized DMD on unequally sampled snapshots -------------------
    gaps = 0.05 + 0.1 * rng.random(150)
    ts = np.concatenate([[0.0], np.cumsum(gaps)])
    alphas = np.array([-0.05 + 1.2j, -0.05 - 1.2j])
    phi = rng.standard_normal((16, 2)) + 1j * rng.standard_normal((16, 2))
    phi[:, 1] = np.conj(phi[:, 0])
    snaps = np.real(phi @ np.exp(np.outer(alphas, ts)))
    ofit = OptDmd(snaps, 2, t=ts)
    fitted = h.host(ofit.alphas)
    fitted = fitted[np.argsort(fitted.imag)]
    print("\nOptDmd on jittered sampling -> alphas:", np.round(fitted, 6))

    # --- sparsity-promoting selection on an overfit DMD -----------------
    t_eq = np.arange(160)
    lam3 = np.array([0.99 * np.exp(1j * 0.4), 0.99 * np.exp(-1j * 0.4), 0.9])
    phi3 = rng.standard_normal((20, 3)) + 1j * rng.standard_normal((20, 3))
    phi3[:, 1] = np.conj(phi3[:, 0])
    xx = np.real(phi3 @ lam3[:, None] ** t_eq[None, :])
    xx += 1e-5 * rng.standard_normal(xx.shape)
    dfit = DMD(xx, 8)
    sel = spdmd(dfit, xx, gammas=np.logspace(-8, 4, 13))
    print("\nspDMD Pareto front (gamma -> nnz @ loss%):")
    front = []
    for g, k, p in zip(h.host(sel["gammas"]), h.host(sel["nnz"]),
                       h.host(sel["ploss_pct"])):
        print(f"  {g:10.2e} -> {k} @ {p:.4f}%")
        front.append([float(g), int(k), float(p)])

    ok = (np.all(np.isfinite(poles)) and held_out < 1e-3
          and np.all(np.isfinite(fitted)))
    h.finish("demo_sysid", dev, bool(ok),
             "poles " + ", ".join(f"{z:.7g}" for z in poles)
             + f"; held-out err {held_out:.3g}; spDMD front of {len(front)}",
             {
        "poles": poles.tolist(), "hsv": hsv.tolist(),
        "held_out_err": held_out,
        "optdmd_alphas": [[z.real, z.imag] for z in fitted.tolist()],
        "spdmd_front": front})


if __name__ == "__main__":
    main()
