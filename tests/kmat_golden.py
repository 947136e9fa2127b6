"""Record the kernel matrix's f32 output bits at fixed inputs.

Run on a machine with an NVIDIA GPU, with the checkout to record on the
path:

    PYTHONPATH=<checkout> python3 tests/kmat_golden.py OUT.npz

It draws the inputs from a fixed numpy seed, runs that checkout's
``pairwise_kernel_matrix`` for every phi at d = 3 and for the linear phi at
d = 8, and saves inputs and outputs. ``tests/data/kmat_f32_bits.npz`` holds
what the kernel computed before its redesign with persistent tiles (one
64 x 64 tile a block, the features staged in shared memory), and
``tests/test_torch_cuda.py::test_kernel_matrix_f32_bits_as_recorded`` holds
the kernel to those bits on both of its store paths.
"""
import sys

import numpy as np
import torch

PHIS = ("linear", "multiquadric", "cubic", "gaussian")
EPS = 0.7
SEED = 20261016
# 132 columns: 528-byte rows, so the output may take the TMA store
N_A, N_B = 40, 132


def inputs() -> dict:
    rng = np.random.default_rng(SEED)
    return {f"{side}{d}": rng.standard_normal((n, d)).astype(np.float32)
            for d in (3, 8) for side, n in (("xa", N_A), ("xb", N_B))}


def cases():
    """(output key, phi, d) of every recorded output."""
    return [(f"{phi}_d3", phi, 3) for phi in PHIS] + [("linear_d8", "linear",
                                                        8)]


def main(path: str) -> None:
    from corrla_rs_tpu_torch.ops import rbf_kernels as rk

    data = inputs()
    dev = torch.device("cuda", 0)
    for key, phi, d in cases():
        xa = torch.from_numpy(data[f"xa{d}"]).to(dev)
        xb = torch.from_numpy(data[f"xb{d}"]).to(dev)
        data[key] = rk.pairwise_kernel_matrix(xa, xb, phi, EPS).cpu().numpy()
    np.savez_compressed(path, **data)
    print(f"wrote {path}: {sorted(data)}")


if __name__ == "__main__":
    main(sys.argv[1])
