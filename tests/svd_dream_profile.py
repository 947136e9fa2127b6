"""Where the time goes in single_pass_svd, block_krylov_svd and dream_run.

Run from the repo root on a machine with one NVIDIA GPU:

    PYTHONPATH=. python3 tests/svd_dream_profile.py

Builds the 100,000 x 10,000 f32 matrix of ``chip_smoke.py``'s rsvd phase
(``chip_smoke.rsvd_matrix``), profiles three warm calls of each SVD and 50 DREAM generations at 8,192
chains x 3 dims with torch.profiler, and prints for each: the wall time a
call, the device-busy time (the sum of kernel times; the kernels of one
stream do not overlap) and the kernels that take most of it. Not a test:
pytest collects nothing here.
"""
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import rsvd_matrix
import corrla_rs_tpu_torch as port
from corrla_rs_tpu_torch.ops.dream import dream_run


def profiled(label, fn, calls):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / calls * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((ev.device_time_total / 1e3 / calls, ev.count // calls,
                    ev.key) for ev in prof.key_averages()
                   if ev.device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"{label}: wall {wall_ms:.3f} ms a call, device busy {busy:.3f} ms "
          f"({busy / wall_ms:.1%}), {sum(r[1] for r in rows)} kernels a call")
    for ms, count, key in rows[:8]:
        print(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}")


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    a, _ = rsvd_matrix(dev, gen)
    profiled("single_pass_svd 100000x10000 rank 100",
             lambda: port.single_pass_svd(a, 100, 10, key=1), 3)
    profiled("block_krylov_svd 100000x10000 rank 100, 2 iterations",
             lambda: port.block_krylov_svd(a, 100, 2, 10, key=1), 3)
    profiled("random_svd 100000x10000 rank 100, 8 iterations",
             lambda: port.random_svd(a, 100, 8, 10, key=1), 3)
    del a
    prec = torch.linalg.inv(torch.tensor(
        [[1.0, 0.6, 0.3], [0.6, 1.0, 0.5], [0.3, 0.5, 1.0]], device=dev))
    heads = torch.randn(8192, 3, generator=gen, device=dev)
    profiled("dream_run 8192 chains x 3 dims, 50 generations (times a call "
             "of 50)",
             lambda: dream_run(heads, lambda x: -0.5 * (x @ prec @ x), 50,
                               key=2, n_adapt=50), 2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
