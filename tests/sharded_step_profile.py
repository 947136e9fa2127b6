"""Where the extra host time of a sharded generation, step or stage goes, at
world size 1 on one card: HMC (4,096 chains x 16 dims, 16 leapfrog steps,
no warmup), DEMC (8,192 chains x 3 dims), the stochastic EnKF (1,024
members) and the particle filter (16,384 particles) a step on a 64-state
linear model with 16 observed, and SMC (8,192 particles x 4 dims, 5
mutation steps) a stage, each sharded on an NCCL world of one against the
single-device run on the same draws.

Run on a machine with a CUDA card, from the repo root:

    PYTHONPATH=. python3 tests/sharded_step_profile.py

For each path it warms both sides, prints the walls of 5 alternated
unprofiled runs of each side (medians, ms a generation, step or stage),
then profiles the two sides in the order sharded, single, single, sharded
and sums each side's two sessions: the self CPU time a generation, the
operators whose call counts differ (the work the sharded path adds) and
the time of the operators both sides call equally often (the same work,
read slower or faster). Then the card's name and power limit.
"""
from __future__ import annotations

import datetime
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch


def _wall(fn, gens):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / gens * 1e3


def _profile(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_cpu_time_total, e.count)
            for e in prof.key_averages()}


def _report(name, runs, gens, unit="generation"):
    for fn in runs.values():
        fn()
    walls = {side: [] for side in runs}
    for _ in range(5):
        for side, fn in runs.items():
            walls[side].append(_wall(fn, gens))
    ops = {side: {} for side in runs}
    for side in ("sharded", "single", "single", "sharded"):
        for key, (us, calls) in _profile(runs[side]).items():
            t, c = ops[side].get(key, (0.0, 0))
            ops[side][key] = (t + us, c + calls)
    per_gen = 2 * gens
    keys = set(ops["sharded"]) | set(ops["single"])
    added, same = [], 0.0
    for key in keys:
        t1, c1 = ops["sharded"].get(key, (0.0, 0))
        t0, c0 = ops["single"].get(key, (0.0, 0))
        if c1 != c0:
            added.append(((t1 - t0) / per_gen, (c1 - c0) / per_gen, key))
        else:
            same += (t1 - t0) / per_gen
    added.sort(reverse=True)
    total = {side: sum(t for t, _ in v.values()) / per_gen
             for side, v in ops.items()}
    print(f"{name}: wall {statistics.median(walls['sharded']):.4f} / "
          f"{statistics.median(walls['single']):.4f} ms a {unit} "
          f"(sharded / single-device, medians of 5 alternated runs); self "
          f"CPU {total['sharded']:.1f} / {total['single']:.1f} us a "
          f"{unit} (two sessions a side, sharded first and last); the "
          f"operators both call equally often {same:+.1f} us; the ones whose "
          f"calls differ (us, calls a {unit}): " + ", ".join(
              f"{k} {t:+.1f} ({c:+.2f})" for t, c, k in added[:10]),
          flush=True)


def _filters(enkf_filter, particle_filter, mesh, dev):
    """The stochastic EnKF and the particle filter a step on x' = A x + w,
    y = C x + v: 64 states, 16 observed, 20 steps."""
    n, p, steps = 64, 16, 20
    gen = torch.Generator(device=dev).manual_seed(2)
    f64 = torch.float64
    a = 0.95 * torch.linalg.qr(torch.randn(n, n, generator=gen, device=dev,
                                           dtype=f64)).Q
    c = torch.randn(p, n, generator=gen, device=dev, dtype=f64) / n ** 0.5
    q_var, r_var = 1.0 - 0.95 ** 2, 4.0
    ys = torch.randn(steps, p, generator=gen, device=dev, dtype=f64)
    ens = torch.randn(1024, n, generator=gen, device=dev, dtype=f64)
    _report("enkf_filter stochastic, 1024 members", {
        side: (lambda m=m: enkf_filter(ens, ys, lambda v: a @ v, c, r_var, 1,
                                       method="stochastic", q=q_var,
                                       mesh=m))
        for side, m in (("sharded", mesh), ("single", None))}, steps, "step")

    def propagate(g, cloud):
        return cloud @ a.mT + q_var ** 0.5 * torch.randn(
            cloud.shape, generator=g, device=cloud.device, dtype=cloud.dtype)

    def loglik(x, y):
        return -0.5 * torch.sum((y - c @ x) ** 2) / r_var

    cloud = torch.randn(16384, n, generator=gen, device=dev, dtype=f64)
    _report("particle_filter, 16384 particles", {
        side: (lambda m=m: particle_filter(cloud, ys, propagate, loglik, 1,
                                           mesh=m))
        for side, m in (("sharded", mesh), ("single", None))}, steps, "step")


def _smc(smc_sample, chains, dev):
    """SMC a stage: 8,192 particles x 4 dims, 5 mutation steps, a Gaussian
    likelihood under a wide Gaussian prior."""
    f64 = torch.float64
    gen = torch.Generator(device=dev).manual_seed(3)
    y = torch.linspace(-1.0, 1.5, 4, dtype=f64, device=dev)

    def ln_prior(x):
        return -0.5 * torch.sum(x ** 2) / 4.0

    def ln_like(x):
        return -0.5 * torch.sum((x - y) ** 2) / 0.25

    init = 2.0 * torch.randn(8192, 4, generator=gen, device=dev, dtype=f64)
    runs = {side: (lambda m=m: smc_sample(ln_like, ln_prior, init, n_mcmc=5,
                                          key=1, mesh=m))
            for side, m in (("sharded", chains), ("single", None))}
    stages = runs["single"]().n_stages
    _report(f"smc_sample 8192 x 4, 5 mutation steps, {stages} stages", runs,
            stages, "stage")


def main() -> int:
    if not torch.cuda.is_available():
        print("sharded_step_profile: needs a CUDA device", file=sys.stderr)
        return 2
    import torch.distributed as dist

    from corrla_rs_tpu_torch.ops.enkf import enkf_filter
    from corrla_rs_tpu_torch.ops.hmc import hmc_run
    from corrla_rs_tpu_torch.ops.particle import particle_filter
    from corrla_rs_tpu_torch.ops.samplers import demc_run
    from corrla_rs_tpu_torch.parallel import mesh as pm
    from corrla_rs_tpu_torch.ops.smc import smc_sample
    from corrla_rs_tpu_torch.parallel.sharded_samplers import \
        demc_run_sharded

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as folder:
        pm.init_distributed(backend="nccl", rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(folder, "s"),
                                                 1),
                            timeout=datetime.timedelta(seconds=300))
        try:
            chains = pm.make_mesh(axis_name="chains")
            gen = torch.Generator(device=dev).manual_seed(0)
            d = 16
            idx = torch.arange(d, dtype=torch.float64, device=dev)
            cov = 0.5 ** (idx[:, None] - idx[None, :]).abs()
            prec = torch.linalg.inv(cov).float()

            def ln_prob(x):
                return -0.5 * (x @ prec @ x)

            x0 = torch.randn(4096, d, generator=gen, device=dev) * 3.0
            gens = 20
            _report("hmc_run 4096 x 16, 16 leapfrog steps", {
                "sharded": lambda: hmc_run(x0, ln_prob, gens, 0, 16, key=1,
                                           mesh=chains),
                "single": lambda: hmc_run(x0, ln_prob, gens, 0, 16, key=1)},
                gens)

            def ln3(x):
                return -0.5 * torch.sum(x * x)

            heads = torch.randn(8192, 3, generator=gen, device=dev) * 3.0
            gens = 100
            _report("demc_run 8192 x 3", {
                "sharded": lambda: demc_run_sharded(heads, ln3, gens, 0.8,
                                                    1e-6, key=1,
                                                    mesh=chains),
                "single": lambda: demc_run(heads, ln3, gens, 0.8, 1e-6, 1)},
                gens)
            _filters(enkf_filter, particle_filter, pm.make_mesh(), dev)
            _smc(smc_sample, chains, dev)
        finally:
            dist.destroy_process_group()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
