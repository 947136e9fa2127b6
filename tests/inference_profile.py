"""Where the time goes in stretch_run, hmc_run, nuts_run and the filters.

Run from the repo root on a machine with one NVIDIA GPU:

    PYTHONPATH=. python3 tests/inference_profile.py

On ``chip_smoke.py``'s correlated 16-D Gaussian (``chip_smoke.gauss16``) it
profiles a few generations of each sampler with torch.profiler and prints,
for each: the wall time a generation, the device-busy time (the sum of
kernel times), the kernel launches a generation and the kernels that take
most of the device time. It also times one batched value-and-gradient of the
target alone (the unit of work of HMC and NUTS) and one step of the Kalman,
ensemble and particle filters on ``chip_smoke.state_space_model``. Not a
test: pytest collects nothing here.
"""
import math
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import SIZES, gauss16, state_space_model
from svd_dream_profile import profiled
import corrla_rs_tpu_torch as port


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    ln_prob, _ = gauss16(dev)
    d = SIZES["gauss16"]
    rng = np.random.default_rng(0)

    def start(n):
        return torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32,
                               device=dev)

    n = SIZES["stretch"][0]
    x = start(n)
    value_and_grad = torch.func.vmap(torch.func.grad_and_value(ln_prob))
    profiled(f"vmap(grad_and_value(ln_prob)) on {n} x {d} (times a call of "
             "20)", lambda: [value_and_grad(x) for _ in range(20)], 3)
    profiled(f"vmap(ln_prob) on {n} x {d} (times a call of 20)",
             lambda: [torch.func.vmap(ln_prob)(x) for _ in range(20)], 3)

    def summed_grad(pts):
        # the same gradient from reverse mode over the batched value: the
        # chains are independent, so the sum's gradient is theirs row by row
        pts = pts.detach().requires_grad_(True)
        lnp = torch.func.vmap(ln_prob)(pts)
        return torch.autograd.grad(lnp.sum(), pts)[0], lnp.detach()

    g_func, g_sum = value_and_grad(x)[0], summed_grad(x)[0]
    print(f"    autograd.grad of the summed vmap(ln_prob) against "
          f"vmap(grad_and_value): max |difference| "
          f"{(g_func - g_sum).abs().max().item():.3e}")
    profiled(f"autograd.grad of the summed vmap(ln_prob) on {n} x {d} (times "
             "a call of 20)", lambda: [summed_grad(x) for _ in range(20)], 3)

    gens = 50
    profiled(f"stretch_run {n} walkers x {d} dims (times a call of {gens} "
             "generations)",
             lambda: port.stretch_run(x, ln_prob, gens, key=1), 2)
    n, _, _, n_leap = SIZES["hmc"]
    x = start(n)
    gens = 20
    profiled(f"hmc_run {n} chains x {d} dims, {n_leap} leapfrog steps "
             f"(times a call of {gens} generations, none of them warmup)",
             lambda: port.hmc_run(x, ln_prob, gens, 0, n_leap, key=1,
                                  init_step_size=0.5), 2)
    n, _, _, depth = SIZES["nuts"]
    x = start(n)
    gens = 10
    profiled(f"nuts_run {n} chains x {d} dims, max depth {depth} (times a "
             f"call of {gens} generations, none of them warmup)",
             lambda: port.nuts_run(x, ln_prob, gens, 0, depth, key=1,
                                   init_step_size=0.5), 2)

    # one step of each filter on the smoke's state-space model
    n_s, p, _ = SIZES["ssm"]
    a, c, q_var, r_var, rng = state_space_model(0, n_s, p)
    steps = 20
    ys = rng.standard_normal((steps, p))
    a_t = torch.as_tensor(a, device=dev)
    c_t = torch.as_tensor(c, device=dev)
    profiled(f"kalman_filter {n_s} states (times a call of {steps} steps)",
             lambda: port.kalman_filter(a, np.zeros((n_s, 1)), c, None, q_var,
                                        r_var, np.zeros((1, steps)), ys.T), 2)
    n_ens = SIZES["enkf"][0]
    ens0 = rng.standard_normal((n_ens, n_s))
    for method in ("stochastic", "etkf"):
        profiled(f"enkf_filter {method} {n_ens} members (times a call of "
                 f"{steps} steps)",
                 lambda: port.enkf_filter(ens0, ys, lambda v: a_t @ v, c,
                                          r_var, 1, method=method, q=q_var), 2)
    n_part = SIZES["pf"]
    cloud = rng.standard_normal((n_part, n_s))
    sd_q = math.sqrt(q_var)

    def propagate(gen, xs):
        return xs @ a_t.mT + sd_q * torch.randn(
            xs.shape, generator=gen, dtype=xs.dtype, device=xs.device)

    def loglik(xp, y):
        return -0.5 * torch.sum((y - c_t @ xp) ** 2) / r_var

    profiled(f"particle_filter {n_part} particles (times a call of {steps} "
             "steps)",
             lambda: port.particle_filter(cloud, ys, propagate, loglik, 1), 2)
    profiled(f"ukf_filter {n_s} states (times a call of {steps} steps)",
             lambda: port.ukf_filter(np.zeros(n_s), np.eye(n_s), ys,
                                     lambda v: a_t @ v, lambda v: c_t @ v,
                                     q_var, r_var), 2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
