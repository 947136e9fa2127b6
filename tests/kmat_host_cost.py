"""Time the kernel-matrix wrapper's host cost a call, for any checkout.

Run on a machine with an NVIDIA GPU, with the checkout to time on the
path:

    PYTHONPATH=<checkout> python3 tests/kmat_host_cost.py [ROUNDS]

Each round prints one JSON line: the host time a call of
``pairwise_kernel_matrix`` at 64 points (d = 1, a kernel of a few µs) and of
``torch.empty`` alone, and the per-call time at PodI's 2000 x 2000, d = 1.
The timers are ``chip_smoke.host_us`` and ``chip_smoke.cuda_ms``, loaded
from this script's own checkout; the package timed is the one on the path,
and only its public ``pairwise_kernel_matrix`` is called, so an older
checkout runs too. Alternate checkouts in one call to compare them: a
host-bound call on a shared host moves more between rounds than between
two close versions.
"""
import importlib.util
import json
import sys
from pathlib import Path

import torch


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(rounds: int) -> None:
    from corrla_rs_tpu_torch.ops import rbf_kernels as rk

    smoke = _chip_smoke()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    small = torch.rand(64, 1, generator=gen, device=dev)
    podi = torch.rand(2000, 1, generator=gen, device=dev)
    for r in range(rounds):
        print(json.dumps({
            "round": r,
            "host_us_64": smoke.host_us(
                lambda: rk.pairwise_kernel_matrix(small, small, "linear", 1.0)),
            "empty_us_64": smoke.host_us(
                lambda: torch.empty((64, 64), dtype=small.dtype,
                                    device=small.device)),
            "call_ms_2000": smoke.cuda_ms(
                lambda: rk.pairwise_kernel_matrix(podi, podi, "linear", 1.0)),
        }), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 3)
