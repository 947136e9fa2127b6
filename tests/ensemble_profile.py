"""Where the time goes in bench_torch.py's ensemble phase.

Run from the repo root on a machine with one NVIDIA GPU:

    PYTHONPATH=. python3 tests/ensemble_profile.py

Profiles (torch.profiler, CPU and CUDA activities) three warm calls of
``dmdc_fit_ensemble`` on bench_torch.py's 16 members x 20 states x 40
snapshots, and of the 16 lone ``DMDc`` fits it is held to, and prints for
each: the wall time a call, the device-busy time (the sum of kernel times;
the kernels of one stream do not overlap), the kernels and the host
synchronisations (cudaStreamSynchronize, cudaDeviceSynchronize and the
device-to-host copies) a call, and the host operators that take most of the
host's time. Not a test: pytest collects nothing here.
"""
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

import bench_torch
from corrla_rs_tpu_torch.models.dmd import dmdc_fit_ensemble

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
         "cudaMemcpyAsync")


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
    print(f"{label}: wall {wall_ms:.3f} ms a call, device busy {busy:.3f} ms "
          f"({busy / wall_ms:.1%}), {n_kernels} kernels a call; runtime "
          f"calls that may wait a call: {syncs}")
    ops = sorted(((ev.self_cpu_time_total / 1e3 / calls, ev.count // calls,
                   ev.key) for ev in events
                  if ev.device_type == torch.autograd.DeviceType.CPU),
                 reverse=True)
    for ms, count, key in ops[:10]:
        print(f"    host {ms:9.3f} ms  x{count:<6d} {key[:80]}")


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    shape = bench_torch.sizes(False)["ensemble"]
    ens, u_b = (torch.as_tensor(x, device=dev)
                for x in bench_torch.ensemble_data(*shape))
    label = "x".join(map(str, shape))
    profiled(f"dmdc_fit_ensemble {label}",
             lambda: dmdc_fit_ensemble(ens, u_b, **bench_torch.ENSEMBLE_KW))
    profiled(f"{shape[0]} lone DMDc fits",
             lambda: bench_torch.lone_fits(ens, u_b))
    return 0


if __name__ == "__main__":
    sys.exit(main())
