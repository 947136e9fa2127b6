"""Time and profile ops.eig_device on one CUDA device: its rounds replayed
as CUDA graphs (the package's path) against the same rounds run eagerly.

    PYTHONPATH=. python3 tests/eig_device_profile.py [--sizes 64 200]

For each n (f64, one random matrix, seed 0) it prints the warm time of
``eig_device`` (median of 3 after one call), the same with every round run
eagerly (``_iterate`` replaced by a plain loop of ``_Francis.round``, the
CPU's path; one call after one, 12 s a call at n = 200), the rounds and
chase steps the QR iteration took (counted in the eager calls), and, at the
sizes in ``--profile`` (default 64: a call at n = 200 is about a million
kernels, too many events for one trace), the kernels one call of the graph
path launched and the device's busy share, from ``torch.profiler``.
``torch.linalg.eig`` on the card is timed beside.
"""
import argparse
import statistics
import time

import numpy as np
import torch

from corrla_rs_tpu_torch.ops import eig_device as ed


def wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def warm(fn, runs: int = 3) -> float:
    fn()
    return statistics.median(wall(fn) for _ in range(runs))


def eager_iterate(state) -> None:
    """``ed._iterate`` without the CUDA graphs: every round eagerly."""
    hi_max, rounds = state.n - 1, 0
    while True:
        if rounds % ed._CHECK_EVERY == 0:
            live_any, hi_max = torch.stack(
                [state.active().any().long(), state.hi.max()]).tolist()
            if not live_any:
                return
        rounds += 1
        state.round(min(state.n - 1, hi_max))


def eager_counted(a, counts):
    """``ed.eig_device(a)`` with every round eager, counting its rounds and
    chase steps into ``counts``."""
    round_fn = ed._Francis.round

    def round_counted(self, steps):
        counts["rounds"] += 1
        counts["steps"] += steps
        return round_fn(self, steps)

    counts.update(rounds=0, steps=0)
    ed._Francis.round = round_counted
    iterate, ed._iterate = ed._iterate, eager_iterate
    try:
        return ed.eig_device(a)
    finally:
        ed._Francis.round, ed._iterate = round_fn, iterate


def busy(fn):
    """(kernels launched, device busy share) of one call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = wall(fn)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    covered, end = 0.0, -np.inf
    for s, e in spans:
        if e > end:
            covered += e - max(s, end)
            end = e
    return len(kernels), covered / 1e6 / t


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", type=int, nargs="+", default=[64, 200])
    parser.add_argument("--profile", type=int, nargs="*", default=[64])
    args = parser.parse_args()
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(dev), torch.__version__, flush=True)
    for n in args.sizes:
        a = torch.as_tensor(np.random.default_rng(0).standard_normal((n, n)),
                            device=dev)
        graphs = warm(lambda: ed.eig_device(a))
        counts = {}
        eager = warm(lambda: eager_counted(a, counts), runs=1)
        lib = warm(lambda: torch.linalg.eig(a))
        line = (f"n={n} f64: eig_device {graphs:.4f} s (rounds replayed as "
                f"CUDA graphs), {eager:.4f} s (eager rounds); "
                f"torch.linalg.eig {lib:.5f} s; {counts['rounds']} rounds, "
                f"{counts['steps']} chase steps")
        if n in args.profile:
            n_kernels, share = busy(lambda: ed.eig_device(a))
            line += (f"; one graph-path call launched {n_kernels} kernels, "
                     f"device busy {share:.1%}")
        print(line, flush=True)


if __name__ == "__main__":
    main()
