"""The two reference-side findings behind examples_torch/, measured on the
CPU in both packages (ROADMAP queue 3, reference-side findings):

- ``dream``: demo_pipeline.py's stage 6 on the CPU in f32, per key: how many
  of the 1,024 DREAM chains end stuck in the prior's tail (their mean over
  the kept generations more than 0.1 from theta_true) under JAX's
  ``dream_run`` and the port's on the same starts, how many of those the
  stage's thinning keeps, and stage 8 (bridge + PSIS; |dlogZ|, k-hat and
  whether the stage passes) in each package on its own draws: JAX's bridge
  on JAX's ``dream_run`` draws against JAX's SMC evidence, the port's on the
  port's ``dream_run`` draws and on its draws under DreamSampler's outlier
  correction (what examples_torch/demo_pipeline.py runs);
- ``okid``: the sweep's era/okid stage over noise-free records drawn from
  seeds 0..N-1 in f32, the error of both packages' identified Markov
  parameters (a failure is > 0.05, the stage's limit).

Run from the repository root: ``PYTHONPATH=. python3
tests/examples_findings.py [dream|okid] [--keys 6] [--records 40]`` (about
a minute a DREAM key on 8 cores).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "examples_torch"), ROOT]


def dream(n_keys: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import demo_pipeline as m
    from corrla_rs_tpu.ops.bridge import (
        bridge_sampling_evidence as jax_bridge,
    )
    from corrla_rs_tpu.ops.dream import dream_run as jax_dream_run
    from corrla_rs_tpu.ops.psis import psis as jax_psis
    from corrla_rs_tpu.ops.smc import smc_sample as jax_smc
    from corrla_rs_tpu_torch.ops.dream import DreamSampler, dream_run
    from corrla_rs_tpu_torch.utils.device import set_default_device

    set_default_device("cpu")
    p = m.Pipeline("cpu")
    p.s1_data()
    y_obs = p.y_obs.numpy()
    tg = p.t_grid.astype(np.float32)
    uc = p.u_ctrl.astype(np.float32)
    xs = p.x_grid[p.sensor_idx].astype(np.float32)
    pm = jnp.asarray(m.PRIOR_MEAN, jnp.float32)
    ps = jnp.asarray(m.PRIOR_STD, jnp.float32)

    def jax_ln_like(theta):
        lam, c, g = theta[0], theta[1], theta[2]
        field = (g * jnp.exp(-lam * tg)[None, :]
                 * jnp.sin(3.0 * xs[:, None] - 4.0 * c * tg[None, :])
                 + 0.25 * jnp.sin(5.0 * xs)[:, None] * uc[None, :])
        resid = field - y_obs
        return -0.5 / m.NOISE_STD**2 * jnp.sum(resid * resid)

    def jax_ln_prior(theta):
        return (-0.5 * jnp.sum(((theta - pm) / ps) ** 2)
                - jnp.sum(jnp.log(ps)) - 1.5 * jnp.log(2 * jnp.pi))

    def jax_ln_post(theta):
        return jax_ln_like(theta) + jax_ln_prior(theta)

    burn, n, gens = m.BURN, m.CHAINS, m.GENS
    thinned = np.arange(0, (gens - burn) * n, 100) % n

    def stuck(kept):
        far = np.abs(kept.mean(0) - m.THETA_TRUE).max(1) > 0.1
        return int(far.sum()), int(np.isin(np.where(far)[0], thinned).sum())

    def stage8(kept):
        draws = kept.reshape(-1, 3)
        p.dream_draws = draws[:: max(1, draws.shape[0] // 8192)]
        return p.s8_bridge_psis()[1:]

    def jax_stage8(kept):
        """The JAX script's stage 8 on JAX's draws and JAX's SMC."""
        draws = kept.reshape(-1, 3)
        draws = draws[:: max(1, draws.shape[0] // 8192)]
        br = jax_bridge(jax_ln_post, jnp.asarray(draws), key=7)
        gap = abs(float(br.log_evidence) - jax_log_z)
        z = np.random.default_rng(11).standard_normal((4096, 3))
        mu = np.asarray(br.proposal_mean, np.float64)
        chol = np.asarray(br.proposal_chol, np.float64)
        ln_gauss = (-0.5 * np.sum(z * z, axis=1) - 1.5 * np.log(2.0 * np.pi)
                    - np.sum(np.log(np.diag(chol))))
        lw = np.asarray(jax.vmap(jax_ln_post)(
            jnp.asarray(mu + z @ chol.T, jnp.float32)), np.float64) - ln_gauss
        k_hat = float(jax_psis(lw).k_hat)
        return (f"{gap:.3f}, {k_hat:.3f}",
                bool(br.converged) and gap < 1.0 and k_hat < 0.7)

    # stage 7 in both packages from the same particles
    smc_rng = np.random.default_rng()
    smc_rng.bit_generator.state = p.rng.bit_generator.state
    p.s7_smc()
    init = m.PRIOR_MEAN + m.PRIOR_STD * smc_rng.standard_normal((m.PARTICLES,
                                                                 3))
    jax_log_z = float(jax_smc(jax_ln_like, jax_ln_prior,
                              jnp.asarray(init, jnp.float32), n_mcmc=5,
                              key=5).log_evidence)
    print(f"SMC log Z: port {p.log_z_smc:.3f}, JAX {jax_log_z:.3f}; chains "
          f"{n}, generations {gens}, the first {burn} discarded")
    for key in range(n_keys):
        heads0 = p.prior_draws(n)
        hist, _ = dream_run(heads0, p.ln_post, gens, key=key,
                            n_adapt=m.N_ADAPT)
        port = hist[burn:].numpy()
        jhist, _ = jax_dream_run(jnp.asarray(heads0.numpy()), jax_ln_post,
                                 gens, key=key, n_adapt=m.N_ADAPT)
        jax_kept = np.asarray(jhist[burn:])
        sampler = DreamSampler(p.ln_post, heads0, n_adapt=m.N_ADAPT, key=key,
                               outlier_correct=True)
        sampler.sample_mcmc(gens)
        corrected = sampler.chain_history[1 + burn:].numpy()
        print(f"key {key}: stuck chains (of them thinned) JAX "
              f"{stuck(jax_kept)}, port {stuck(port)}, port corrected "
              f"{stuck(corrected)} ({sampler.n_outlier_resets} resets); "
              f"stage 8 (|dlogZ|, k-hat; pass) JAX {jax_stage8(jax_kept)}, "
              f"port {stage8(port)}, port corrected {stage8(corrected)}",
              flush=True)


def okid(n_records: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from corrla_rs_tpu.models.era import era_okid as jax_era_okid
    from corrla_rs_tpu_torch.models.era import era_okid
    from corrla_rs_tpu_torch.utils.device import set_default_device

    set_default_device("cpu")
    a = np.array([[0.9, 0.2], [0.0, 0.7]])
    b = np.array([[1.0], [0.5]])
    c = np.array([[1.0, -0.4]])

    def markov_err(fit):
        a_h, b_h, c_h, d_h = (np.asarray(getattr(v, "cpu", lambda: v)(),
                                         np.float64)
                              for v in (fit.a, fit.b, fit.c, fit.d))
        errs = [abs(float(np.atleast_2d(d_h)[0, 0]) - 0.1)]
        ak, akh = np.eye(2), np.eye(a_h.shape[0])
        for _ in range(12):
            errs.append(abs((c_h @ akh @ b_h).item() - (c @ ak @ b).item()))
            ak, akh = a @ ak, a_h @ akh
        return max(errs)

    fails = {"JAX": [], "port": []}
    for seed in range(n_records):
        rng = np.random.default_rng(seed)
        u = rng.standard_normal((1, 400))
        x, y = np.zeros(2), np.zeros((1, 400))
        for k in range(400):
            y[:, k] = c @ x + 0.1 * u[:, k]
            x = a @ x + b @ u[:, k]
        u32, y32 = u.astype(np.float32), y.astype(np.float32)
        for name, fn in (("JAX", jax_era_okid), ("port", era_okid)):
            err = markov_err(fn(u32, y32, rank=2, n_markov=30))
            if not err < 0.05:
                fails[name].append((seed, float(f"{err:.3g}")))
    for name, got in fails.items():
        print(f"{name}: {len(got)} of {n_records} f32 records fail "
              f"(seed, error): {got}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("dream", "okid"))
    ap.add_argument("--keys", type=int, default=6)
    ap.add_argument("--records", type=int, default=40)
    args = ap.parse_args()
    if args.what == "dream":
        dream(args.keys)
    else:
        okid(args.records)


if __name__ == "__main__":
    main()
