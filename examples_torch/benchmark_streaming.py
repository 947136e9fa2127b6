"""Out-of-core streamed RSVD benchmark on the port (matrices larger than the
card's memory): the workload of ``examples/benchmark_streaming.py``.

Streams an n x 10k f32 matrix that never resides on the device (nor, with
the tiled source, on the host) through ops.streaming's streamed SVDs on one
card, and verifies the rank-100 singular values against the exact identity
sigma(A) = sqrt(n_tiles) * sigma(B) for A = [B; B; ...; B]. With the
default 128 tiles, A is 409,600 x 10,000 f32: 16.4 GB a pass.

Run:  python examples_torch/benchmark_streaming.py [--tiles 128]
      [--methods gram,power,single] [--device cpu]

The reference factorizes anything fitting host RAM
(random_svd.rs:63-110); this script is bounded by host *storage*.
"""
from __future__ import annotations

# (the JAX script's enable_persistent_cache, an XLA compile cache, has no
# counterpart here)
import time

import numpy as np

import _harness as h
from corrla_rs_tpu_torch.ops.streaming import (
    RowBlockSource,
    streamed_random_svd,
    streamed_single_pass_svd,
)

BLOCK_ROWS = 3200          # x 10k f32 = 128 MB/block
N_COLS = 10_000
RANK, N_ITER, N_OS = 100, 8, 10
# the Gram and power methods' largest sigma error against the sqrt(n_tiles)
# identity, relative to sigma_1, that counts as a pass (f32 streaming)
SIGMA_TOL = 1e-3


def tiled_source(block: np.ndarray, n_tiles: int) -> RowBlockSource:
    """A = [B; B; ...; B] without materializing A anywhere."""
    b = block.shape[0]

    def fn(start, stop):
        # rows [start, stop) of the tiled matrix == block rows modulo b;
        # a range inside one tile is a view of the block (the streamed SVDs
        # copy it into their pinned buffer), else the tiles' pieces are joined
        lo = start % b
        if lo + (stop - start) <= b:
            return block[lo:lo + stop - start]
        return block[np.arange(start, stop) % b]

    return RowBlockSource(fn, (b * n_tiles, block.shape[1]), block.dtype)


def main(argv=None):
    ap = h.parser(__doc__)
    ap.add_argument("--tiles", type=int, default=128,
                    help="number of 128 MB tiles (128 -> 16 GB)")
    ap.add_argument("--methods", default="gram,power,single",
                    help="comma list from {gram, power, single}")
    ap.add_argument("--block-rows", type=int, default=BLOCK_ROWS)
    ap.add_argument("--cols", type=int, default=N_COLS)
    ap.add_argument("--rank", type=int, default=RANK)
    args = ap.parse_args(argv)
    dev = h.start(args, "benchmark_streaming")
    methods = set(args.methods.split(","))
    block_rows, n_cols, rank = args.block_rows, args.cols, args.rank

    # block with an exactly known decaying spectrum: B = Ql diag(s) Qr^T
    # (sigma_i(B) = s_i by construction), so sigma_i(A) =
    # sqrt(n_tiles) * s_i analytically — a machine-exact oracle at scale
    rng = np.random.default_rng(0)
    r_spec = min(150, block_rows, n_cols)
    ql = np.linalg.qr(rng.standard_normal((block_rows, r_spec)))[0]
    qr_ = np.linalg.qr(rng.standard_normal((n_cols, r_spec)))[0]
    s_true = 100.0 / np.arange(1, r_spec + 1, dtype=np.float64)
    block = ((ql * s_true[None, :]) @ qr_.T).astype(np.float32)
    src = tiled_source(block, args.tiles)
    n = src.shape[0]
    gb = n * n_cols * 4 / 1e9
    print(f"matrix: {n} x {n_cols} f32 = {gb:.1f} GB (streamed, "
          f"never device- or host-resident; spectrum i^-1, rank {r_spec})")
    s_oracle = np.sqrt(args.tiles) * s_true[:rank]

    metrics = {"gb_a_pass": gb}
    ok = True
    for method, passes in (("gram", 3), ("power", N_ITER + 2)):
        if method not in methods:
            continue
        t0 = time.perf_counter()
        _u, s, _vt = streamed_random_svd(
            src, rank, N_ITER, N_OS, key=3, block_rows=block_rows,
            method=method,
        )
        s = h.host(s)          # sync
        wall = time.perf_counter() - t0
        rel = np.abs(s - s_oracle).max() / s_oracle.max()
        print(f"streamed_random_svd[{method:5s}]: {wall:7.2f} s "
              f"({passes} passes = {passes * gb:.0f} GB streamed, "
              f"{passes * gb / wall:.2f} GB/s effective)  "
              f"sigma rel err vs oracle {rel:.2e} (tol {SIGMA_TOL:g})")
        metrics[method] = {"wall_s": wall, "gb_s": passes * gb / wall,
                            "sigma_rel_err": float(rel)}
        ok = ok and bool(rel < SIGMA_TOL)

    if "single" in methods:
        t0 = time.perf_counter()
        _u, s, _vt = streamed_single_pass_svd(
            src, rank, N_OS, key=3, block_rows=block_rows
        )
        s = h.host(s)
        wall = time.perf_counter() - t0
        rel = np.abs(s - s_oracle).max() / s_oracle.max()
        print(f"streamed_single_pass_svd  : {wall:7.2f} s "
              f"(1 pass = {gb:.0f} GB streamed, {gb / wall:.2f} GB/s "
              f"effective)  sigma rel err vs oracle {rel:.2e} "
              f"(sketch-grade; tiled spectrum is rank-{n_cols} gapless)")
        metrics["single"] = {"wall_s": wall, "gb_s": gb / wall,
                              "sigma_rel_err": float(rel)}
        ok = ok and bool(np.isfinite(rel))

    h.finish("benchmark_streaming", dev, ok,
             f"{gb:.4g} GB a pass: " + ", ".join(
                 f"{k} {v['wall_s']:.4g} s ({v['gb_s']:.4g} GB/s, sigma "
                 f"{v['sigma_rel_err']:.3g})"
                 for k, v in metrics.items() if isinstance(v, dict)),
             metrics)


if __name__ == "__main__":
    main()
