"""Time the kernel matrix into the RBF saddle matrix under several row strides.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    PYTHONPATH=. python3 tests/kmat_saddle_layout.py

For RbfInterp's fit (16,384 points in 3-D, poly degree 1: a 16,388-wide
saddle matrix) and PodI's (2,000 values of t, d = 1: 2,002 wide), K is
written into the top-left block of an (n + p) x ld matrix, with ld the
saddle's own width, that width rounded up to 16 bytes and to 128 bytes,
and K alone (n x n). Each layout prints one JSON line with its store path,
per-call ms (``chip_smoke.cuda_ms``) and device ms (``chip_smoke.device_ms``);
the layouts run in order and then in reverse. Last, the LU solve of the
16,388 saddle system on the contiguous matrix and on the 128-byte padded
view, and the largest difference of their solutions relative to the
largest coefficient.
"""
import json

import torch

from chip_smoke import cuda_ms, device_ms, rbf_target
from corrla_rs_tpu_torch.ops import rbf_kernels as rk
from corrla_rs_tpu_torch.ops.stats_corr import build_full_vandermonde


def _round_up(n: int, align_bytes: int, itemsize: int = 4) -> int:
    step = align_bytes // itemsize
    return -(-n // step) * step


def layouts(n: int, p: int) -> dict:
    return {"alone": (n, n), "saddle": (n + p, n + p),
            "pad16": (n + p, _round_up(n + p, 16)),
            "pad128": (n + p, _round_up(n + p, 128))}


def time_layouts(label, x, p, rounds=2):
    n = x.shape[0]
    table = layouts(n, p)
    order = list(table)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            rows, ld = table[name]
            big = torch.empty(rows, ld, device=x.device)
            out = big[:n, :n]

            def call():
                return rk._pairwise_kernel_matrix_into(out, x, x, "linear",
                                                       1.0)
            print(json.dumps({
                "case": label, "round": r, "layout": name, "ld": ld,
                "store": rk._kmat_store_path(out), "ms": cuda_ms(call),
                "device_ms": device_ms(call, ("kernel_matrix_kernel",))}),
                flush=True)
            del big, out
            torch.cuda.empty_cache()


def time_solve(x, rounds=2):
    n = x.shape[0]
    p_mat = build_full_vandermonde(x, 1)
    p = p_mat.shape[1]
    y = rbf_target(x)[:, None]
    y_pad = torch.cat([y, y.new_zeros((p, 1))])
    mats = {}
    for name in ("saddle", "pad128"):
        rows, ld = layouts(n, p)[name]
        kp = torch.empty(rows, ld, device=x.device)[:, :n + p]
        rk._pairwise_kernel_matrix_into(kp[:n, :n], x, x, "linear", 1.0)
        kp[:n, n:] = p_mat
        kp[n:, :n] = p_mat.mT
        kp[n:, n:] = 0
        mats[name] = kp
    coeffs = {}
    for r in range(rounds):
        for name in (list(mats) if r % 2 == 0 else list(mats)[::-1]):
            coeffs[name] = torch.linalg.solve(mats[name], y_pad)
            ms = cuda_ms(lambda: torch.linalg.solve(mats[name], y_pad),
                         window_ms=200.0, windows=3)
            print(json.dumps({"case": "solve 16388", "round": r,
                              "layout": name, "ms": ms}), flush=True)
    a, b = coeffs["saddle"], coeffs["pad128"]
    print(json.dumps({"case": "solve 16388", "max_rel_diff": (
        (a - b).abs().max() / a.abs().max()).item()}), flush=True)


def main() -> None:
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x3 = torch.rand(16384, 3, generator=gen, device=dev)
    t = torch.linspace(0, 1, 2000, device=dev)[:, None]
    time_layouts("RbfInterp K 16384 d=3", x3, 4)
    time_layouts("PodI K 2000 d=1", t, 2)
    time_solve(x3)


if __name__ == "__main__":
    main()
