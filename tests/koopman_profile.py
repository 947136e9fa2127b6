"""Where the time goes in the largest Koopman/DMD-family fits and rollouts.

Run from the repo root on a machine with one NVIDIA GPU:

    PYTHONPATH=. python3 tests/koopman_profile.py

At ``chip_smoke.py``'s sizes and on its data (``edmd_rbf_data``,
``kdmd_data``, ``optdmd_data``, ``bagged_data``) it profiles, with
torch.profiler: the RBF ``Edmd`` fit (the kernel matrix's lift, the Grams,
the host eig), the Nystrom ``KernelDmd`` fit, ``bop_dmd`` and
``bagged_dmd`` (64 members each), the 8-D ``PolynomialChaos`` fit, and
the host-bound rollouts of ``Sindy.simulate`` and ``OpInf``; for each, the
wall time a call, the device-busy time (the sum of kernel times), the
launches a call and the kernels that take most of the device time. Not a
test: pytest collects nothing here.
"""
import subprocess
import sys

import torch

import chip_smoke as cs
from svd_dream_profile import profiled
import corrla_rs_tpu_torch as port
from corrla_rs_tpu_torch.ops.pce import total_degree_multi_indices


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(12)
    f64 = torch.float64

    x, centers = cs.edmd_rbf_data(gen, dev)
    gamma = cs.SIZES["edmd_gamma"]
    y = cs.rbf_map(x)
    profiled(f"Edmd rbf fit, {centers.shape[0]} centres x {x.shape[1]} "
             "pairs f64",
             lambda: port.Edmd(x, dictionary="rbf", centers=centers,
                               gamma=gamma, y_data=y), 1)
    del x, y, centers
    torch.cuda.empty_cache()

    n_x, _, m_nys = cs.SIZES["kdmd"]
    a_lat, lam = cs.rotation_latent(gen, cs.KOOPMAN_PAIRS, dev)
    q = torch.linalg.qr(torch.randn(n_x, a_lat.shape[0], generator=gen,
                                    device=dev, dtype=f64))[0]
    x, y = cs.kdmd_data(gen, dev, m_nys, a_lat, q)
    rank = len(cs.product_spectrum(lam, 2))
    profiled(f"KernelDmd nystrom poly, {n_x} x {m_nys} f64, rank {rank}",
             lambda: port.KernelDmd(x, rank, kernel="poly", degree=2,
                                    length_scale=3.0, gram_method="nystrom",
                                    y_data=y), 1)
    del x, y
    torch.cuda.empty_cache()

    x, _ = cs.optdmd_data(gen, dev)
    profiled(f"bop_dmd 64 members, {tuple(x.shape)} f64, 10 modes",
             lambda: port.bop_dmd(x, 10), 1)
    del x
    x, _ = cs.bagged_data(gen, dev)
    _, _, n_mem, n_modes = cs.SIZES["bagged"]
    profiled(f"bagged_dmd {n_mem} members, {tuple(x.shape)} f32, "
             f"{n_modes} modes",
             lambda: port.bagged_dmd(x, n_modes, n_members=n_mem), 1)
    del x
    torch.cuda.empty_cache()

    d8, o8, n8 = cs.SIZES["pce_8d"]
    xs = torch.rand(n8, d8, generator=gen, device=dev, dtype=f64) * 3 - 1
    n_terms = total_degree_multi_indices(d8, o8).shape[0]
    ys = torch.sin(xs.sum(dim=1))
    profiled(f"PolynomialChaos total degree {o8} in {d8}-D ({n_terms} "
             f"terms), {n8} samples f64",
             lambda: port.PolynomialChaos(o8, bounds=[[-1.0, 2.0]] * d8)
             .fit(xs, ys), 2)
    del xs, ys

    dt = 0.002
    traj = torch.as_tensor(cs.lorenz_host(20_000, dt), device=dev)
    sindy = port.Sindy(degree=cs.SIZES["sindy"][1]).fit(traj, dt=dt)
    profiled("Sindy.simulate degree 5, 200 RK4 steps",
             lambda: sindy.simulate(traj[0], 200, dt=dt), 2)
    n_x, n_t, r = cs.SIZES["opinf"]
    z = torch.randn(n_t, r, generator=gen, device=dev, dtype=f64)
    basis = torch.linalg.qr(torch.randn(n_x, r, generator=gen, device=dev,
                                        dtype=f64))[0]
    oi = port.OpInf(r).fit(z @ basis.mT, x_dot=-0.3 * z @ basis.mT,
                           basis=basis)
    profiled(f"OpInf.simulate_reduced r = {r}, 200 RK4 steps",
             lambda: oi.simulate_reduced(z[0], 200, 0.01), 2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
