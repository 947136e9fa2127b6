"""Where the time goes in the DMDc ensemble, batched and as lone fits.

Run from the repo root on a machine with one NVIDIA GPU:

    PYTHONPATH=. python3 tests/ensemble_profile.py

(with ``PYTHONPATH`` at another checkout it profiles that checkout's
package on the same inputs). Profiles (torch.profiler, CPU and CUDA
activities) warm calls of ``dmdc_fit_ensemble`` and of the lone ``DMDc``
fits it is held to, at two shapes: bench_torch.py's ensemble phase (16
members x 20 states x 40 snapshots f32, 6 modes, 20 iterations) and
chip_smoke.py's (8 members x 20,000 states x 1,001 snapshots f32 of its
latent system, 10 modes, 10 iterations). For each it prints: the wall
time a call, the device-busy time (the sum of kernel times; the kernels of
one stream do not overlap), the kernels and the host synchronisations
(cudaStreamSynchronize, cudaDeviceSynchronize and the device-to-host
copies) a call, the kernels launched most often, the calls of the host
operators that may wait on the device, and the host operators that take
most of the host's time. Not a test: pytest collects nothing here.
"""
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

import bench_torch
import chip_smoke
from corrla_rs_tpu_torch.models import dmd

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
         "cudaMemcpyAsync")
# host operators that read the device back or may wait on it
WAITING_OPS = ("aten::_local_scalar_dense", "aten::linalg_svd",
               "aten::_linalg_svd", "aten::linalg_eig", "aten::_to_copy",
               "aten::linalg_qr", "aten::linalg_cholesky_ex",
               "aten::randint", "aten::item")


def profiled(label, fn, calls=3):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / calls * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [ev for ev in events if ev.device_time_total > 0
               and ev.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ev.device_time_total for ev in kernels) / 1e3 / calls
    n_kernels = sum(ev.count for ev in kernels) // calls
    syncs = {ev.key: ev.count // calls for ev in events if ev.key in SYNCS}
    waits = {ev.key: ev.count // calls for ev in events
             if ev.key in WAITING_OPS}
    print(f"{label}: wall {wall_ms:.3f} ms a call, device busy {busy:.3f} ms "
          f"({busy / wall_ms:.1%}), {n_kernels} kernels a call; runtime "
          f"calls that may wait a call: {syncs}; host operators that may "
          f"wait a call: {waits}")
    for ev in sorted(kernels, key=lambda ev: ev.count, reverse=True)[:8]:
        print(f"    kernel x{ev.count // calls:<6d} "
              f"{ev.device_time_total / 1e3 / calls:9.3f} ms  "
              f"{ev.key[:80]}")
    ops = sorted(((ev.self_cpu_time_total / 1e3 / calls, ev.count // calls,
                   ev.key) for ev in events
                  if ev.device_type == torch.autograd.DeviceType.CPU),
                 reverse=True)
    for ms, count, key in ops[:10]:
        print(f"    host {ms:9.3f} ms  x{count:<6d} {key[:80]}")


def lone_fits(x_b, u_b, n_modes, n_iters, key):
    """Each member fitted alone by ``DMDc``, seeded as the ensemble seeds
    it (see bench_torch.lone_fits)."""
    keys = dmd._split_seed(key, len(x_b), x_b.device)
    return [dmd.DMDc(x, u, n_modes, n_iters, key=k)
            for x, u, k in zip(x_b, u_b, keys)]


def smoke_ensemble(dev, seed=2):
    """chip_smoke.py's ensemble inputs (its dmdc phase's latent system,
    lifted to 8 members of 20,000 states)."""
    n_b, n_x = chip_smoke.SIZES["ensemble"]
    n_t = chip_smoke.SIZES["dmdc"][1]
    z, u = chip_smoke.latent_system(n_t, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x_b = chip_smoke.lifted(z, n_x, gen, dev, batch=n_b)
    return x_b, u.float().to(dev).expand(n_b, -1, -1)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    print(f"package: {dmd.__file__}")
    dev = torch.device("cuda", 0)
    shape = bench_torch.sizes(False)["ensemble"]
    ens, u_b = (torch.as_tensor(x, device=dev)
                for x in bench_torch.ensemble_data(*shape))
    label = "x".join(map(str, shape))
    profiled(f"dmdc_fit_ensemble {label}",
             lambda: dmd.dmdc_fit_ensemble(ens, u_b,
                                           **bench_torch.ENSEMBLE_KW))
    profiled(f"{shape[0]} lone DMDc fits",
             lambda: bench_torch.lone_fits(ens, u_b))
    x_b, u_s = smoke_ensemble(dev)
    n_modes, n_iters = chip_smoke.SIZES["dmdc"][2:]
    label = "x".join(map(str, x_b.shape))
    profiled(f"dmdc_fit_ensemble {label}",
             lambda: dmd.dmdc_fit_ensemble(x_b, u_s, n_modes, n_iters,
                                           key=2))
    profiled(f"{x_b.shape[0]} lone DMDc fits of {label}",
             lambda: lone_fits(x_b, u_s, n_modes, n_iters, 2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
