"""Beyond-parity extensions demo on the port: the workload of
``examples/demo_extensions.py``. GP regression (its distances launch the
kernel matrix), Gaussian, bivariate and vine copulas, Sobol' indices,
batched on-device eigenvalues, an ensemble DMDc, an out-of-core PCA and
MCMC convergence diagnostics (reference roadmap items readme.md:34,49-54
that were never implemented there, plus production MCMC checks).

Run:  python examples_torch/demo_extensions.py [--device cpu]
"""
# (the JAX script's enable_persistent_cache, an XLA compile cache, has no
# counterpart here)
import numpy as np
import torch

import _harness as h
from corrla_rs_tpu_torch import (
    DreamSampler,
    GaussianCopula,
    GpRegressor,
    effective_sample_size,
    gelman_rubin,
)


def main(argv=None):
    ap = h.parser(__doc__)
    ap.add_argument("--stream-rows", type=int, default=200_000,
                    help="rows of the generated source of the streamed PCA")
    ap.add_argument("--n-base", type=int, default=16384,
                    help="base samples of the Sobol' estimators")
    args = ap.parse_args(argv)
    dev = h.start(args, "demo_extensions")
    rng = np.random.default_rng(0)
    metrics = {}

    # GP regression with hyperparameter MLE
    x = np.sort(rng.uniform(0, 6, 80)).astype(np.float32)[:, None]
    y = np.sin(x[:, 0]) + 0.05 * rng.standard_normal(80).astype(np.float32)
    gp = GpRegressor("matern52").fit(x, y)
    xq = np.linspace(0.2, 5.8, 25, dtype=np.float32)[:, None]
    mean, var = gp.predict(xq)
    err = float(np.max(np.abs(h.host(mean) - np.sin(xq[:, 0]))))
    print(f"GP(matern52): max err {err:.4f}; fitted noise_var "
          f"{float(gp.noise_var):.2e}, length_scale "
          f"{float(gp.length_scale):.2f}")
    metrics["gp_max_err"] = err

    # Gaussian copula: lognormal x gaussian marginals with latent rho=0.8
    z = rng.multivariate_normal([0, 0], [[1, 0.8], [0.8, 1]], size=4000)
    data = np.stack([np.exp(z[:, 0]), 2 * z[:, 1] + 5], axis=1)
    cop = GaussianCopula().fit(torch.as_tensor(data.astype(np.float32),
                                               device=dev))
    synth = h.host(cop.sample(4000, key=1))
    print(f"copula: latent corr {float(cop.corr[0, 1]):.3f};"
          f" synthetic marginal medians {np.median(synth, axis=0).round(3)}"
          f" vs data {np.median(data, axis=0).round(3)}")
    metrics["copula_corr"] = float(cop.corr[0, 1])

    # C-vine copula (the reference's 'vine copulas' roadmap item)
    from corrla_rs_tpu_torch import CVineCopula
    from corrla_rs_tpu_torch.ops.vine import kendall_tau

    zc = rng.multivariate_normal(
        [0, 0, 0],
        [[1.0, 0.7, 0.2], [0.7, 1.0, 0.4], [0.2, 0.4, 1.0]], size=1200)
    zc[:, 2] = np.exp(zc[:, 2])  # one heavy marginal
    vine = CVineCopula().fit(zc)
    vs = h.host(vine.sample(3000, key=4))
    tau_vine = float(kendall_tau(vs[:, 0], vs[:, 1]))
    print("vine: pair families "
          f"{[p[0] for row in vine.pairs for p in row]}; "
          f"tau01 data {float(kendall_tau(zc[:, 0], zc[:, 1])):.3f} "
          f"vine {tau_vine:.3f}")
    metrics["vine_tau01"] = tau_vine

    # Bivariate copula with AIC family selection (readme.md:49-53 TODO)
    from corrla_rs_tpu_torch.ops.copula import BivariateCopula

    biv = BivariateCopula("auto").fit(torch.as_tensor(
        data.astype(np.float32), device=dev))
    bs = h.host(biv.sample(3000, key=6))
    print(f"bivariate copula: family {biv.fitted_family} tau "
          f"{float(biv.tau):.3f}; sample tau "
          f"{float(kendall_tau(bs[:, 0], bs[:, 1])):.3f}")

    # Sobol' indices: global variance-based sensitivity (extension)
    from corrla_rs_tpu_torch.ops.sobol import sobol_indices

    def ishigami(xq):
        return (torch.sin(xq[:, 0]) + 7.0 * torch.sin(xq[:, 1]) ** 2
                + 0.1 * xq[:, 2] ** 4 * torch.sin(xq[:, 0]))

    sob = sobol_indices(
        ishigami, np.array([[-np.pi, np.pi]] * 3), args.n_base, key=7,
        plan="sobol", n_boot=64,
    )
    print(f"Sobol (Ishigami): S1 {h.host(sob['s1']).round(3)}"
          f" (exact [0.314 0.442 0.   ]);"
          f" ST {h.host(sob['st']).round(3)}"
          f" (exact [0.558 0.442 0.244])")
    metrics["sobol_s1"] = h.host(sob["s1"]).tolist()

    # Batched on-device spectra: the Francis-QR eig over a family of
    # perturbed DMD-style operators in one call on the stack (the JAX
    # script's jit(vmap(eigvals_device)); no host LAPACK anywhere)
    from corrla_rs_tpu_torch.ops.eig_device import eigvals_device

    base = np.diag(np.linspace(0.5, 0.99, 12)).astype(np.float32)
    fam = torch.as_tensor(
        base[None] + 0.05 * rng.standard_normal((64, 12, 12)).astype(
            np.float32), device=dev)
    blr, bli = eigvals_device(fam)
    rho = np.sqrt(h.host(blr) ** 2 + h.host(bli) ** 2).max(axis=1)
    print(f"batched eig (64 operators, one call): spectral radius "
          f"p5/p50/p95 = {np.percentile(rho, [5, 50, 95]).round(3)}")
    metrics["eig_rho_p50"] = float(np.percentile(rho, 50))

    # Ensemble DMDc: 16 complete fits (RSVDs + Francis-QR eig + modes) in
    # one batched call — bootstrap-style spectral UQ
    from corrla_rs_tpu_torch import dmdc_fit_ensemble, rollout_ensemble
    from corrla_rs_tpu_torch.ops.mat_utils import mat_linspace

    xg = mat_linspace(0.0, 10.0, 20)[:, 0].to(torch.float32)
    tg = mat_linspace(0.0, 10.0, 40)[:, 0].to(torch.float32)
    uc = torch.exp(0.2 * tg)[None, :]
    snap = torch.sin(xg[:, None] + 0.2 * tg[None, :]) * uc
    ens = snap[None] + 2e-3 * torch.as_tensor(
        rng.standard_normal((16,) + tuple(snap.shape)).astype(np.float32),
        device=snap.device)
    fit = dmdc_fit_ensemble(
        ens, uc.expand((16,) + tuple(uc.shape)), n_modes=6,
        n_iters=40, key=11,
    )
    lam = h.host(fit["lambdas_re"]) + 1j * h.host(fit["lambdas_im"])
    rho = np.abs(lam).max(axis=1)
    pred = rollout_ensemble(fit, ens[:, :, 0:1], uc, method="reduced")
    errs = np.abs(h.host(pred[:, :, 19]) - h.host(ens[:, :, 20]))
    print(f"ensemble DMDc (16 members, one call): dominant |lambda| "
          f"{rho.min():.4f}..{rho.max():.4f}; worst rollout err "
          f"{errs.max():.1e}")
    metrics["ensemble_worst_err"] = float(errs.max())

    # R-vine with learned structure + rotated families (round 3): a
    # Markov chain in the first three variables, a NEGATIVE-tau
    # lower-upper-tail pair in the last two — the rotated clayton family
    # the base set cannot represent
    from corrla_rs_tpu_torch import RVineCopula
    from corrla_rs_tpu_torch.ops import vine as _vine

    th90 = _vine._theta_from_tau("clayton90", -0.5)
    ww = rng.uniform(1e-6, 1 - 1e-6, (1500, 2))
    neg = h.host(_vine._HINV["clayton90"](
        torch.as_tensor(ww[:, 1], device=dev),
        torch.as_tensor(ww[:, 0], device=dev), th90))
    zr = rng.standard_normal((1500, 2))
    chain2 = 0.85 * zr[:, 0] + np.sqrt(1 - 0.7225) * zr[:, 1]
    rdata = np.stack([zr[:, 0], chain2, ww[:, 0], neg], axis=1)
    rv = RVineCopula().fit(rdata)
    tree0 = [(a, b, fam) for (a, b, _c, fam, _t) in rv.trees[0]]
    print("R-vine learned structure:", tree0)

    # Out-of-core streamed PCA: the matrix never exists in memory (a
    # generator source), 3 total passes
    from corrla_rs_tpu_torch import RowBlockSource, streamed_pca

    basis = rng.standard_normal((6, 64)).astype(np.float32)

    def make_rows(lo, hi):
        local = np.random.default_rng(1234 + lo)
        coef = local.standard_normal((hi - lo, 6)).astype(np.float32)
        return coef @ (basis * np.array(
            [5, 4, 3, 2, 1, 0.5], np.float32)[:, None])

    src = RowBlockSource(make_rows, (args.stream_rows, 64), np.float32)
    s_pca, comps = streamed_pca(src, 4, block_rows=16_384)
    print(f"streamed PCA over a generated {args.stream_rows} x 64 source: "
          f"sigma {h.host(s_pca[:, 0]).round(1)}")
    metrics["streamed_pca_sigma"] = h.host(s_pca[:, 0]).tolist()

    # DREAM + diagnostics
    def lnp(q):
        return -0.5 * torch.sum(q**2)

    s = DreamSampler(lnp, torch.as_tensor(
        rng.standard_normal((16, 4)).astype(np.float32), device=dev),
        n_adapt=300, key=2)
    s.sample_mcmc(2000)
    hist = s.chain_history[800:]
    rhat = h.host(gelman_rubin(hist))
    print(f"DREAM: acceptance {s.accept_ratio():.3f};"
          f" R-hat {rhat.round(3)};"
          f" ESS {h.host(effective_sample_size(hist)).astype(int)}")
    metrics["dream_rhat_max"] = float(rhat.max())
    ok = bool(np.isfinite(err) and np.isfinite(errs).all()
              and np.isfinite(rho).all() and np.isfinite(rhat).all())
    h.finish("demo_extensions", dev, ok,
             f"GP max err {metrics['gp_max_err']:.4g}; Sobol S1 "
             + ", ".join(f"{v:.3f}" for v in metrics["sobol_s1"])
             + f"; DREAM R-hat <= {metrics['dream_rhat_max']:.4g}", metrics)


if __name__ == "__main__":
    main()
