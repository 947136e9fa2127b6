"""Out-of-core (host-streamed) randomized SVD / PCA / HOSVD, POD and DMDc.

Counterpart of ``corrla_rs_tpu/ops/streaming.py``. The matrix stays on the
host (a numpy array, an ``np.memmap``, or any row-sliceable source; see
``RowBlockSource`` for generated matrices) and row blocks (column blocks for
``streamed_pod``) stream host -> device, where the small sketch and Gram
factors accumulate. Device memory is O(n k + m k) (+ O(m^2) for the Gram
path), never O(n m).

Passes over the source are the budget, as in the JAX package:

- ``method='gram'`` (default): one pass accumulates G = A^T A; the
  ``n_iter`` power iterations run on G on the device (W <- G W with
  CholeskyQR in m-space, ``_chol_qr_cols``, whose factor is the one every
  CholeskyQR of the package takes, ``random_svd._ridged_r_inv``); one pass
  for Y = A W and one for B = Q^T A. Three passes whatever ``n_iter``;
- ``method='power'``: each iteration applies H = A^T (A W) in one pass;
  n_iter + 2 passes, O(m k) on the device;
- ``streamed_single_pass_svd``: both sketches of the two-sided sketch SVD
  in one pass; the co-range test matrix Psi is drawn again for every block
  (``_draw_sketch`` at the full block shape (ell, block_rows) from
  ``_fold_seed(k_psi, i)``, then cut to the block's rows), never
  materialized at (ell, n). A block's key is its generator's seed, so the
  B = Psi Q product draws the same block again.

The transfer. On a CUDA device each pass keeps two pinned staging buffers
and two device buffers of one block each, allocated once a pass. The host
fills one pinned buffer from the source (``np.asarray(a[lo:hi])``) while
the other's copy runs on a side CUDA stream with ``non_blocking=True``;
events order the compute after its copy and guard the reuse of both
buffers, so at most one block is in flight. The last block is not padded
(the JAX package pads it to one static shape so that its kernels compile
once). Each pass logs, at INFO through ``utils.log.get_logger()``, its
bytes, wall time and effective host-to-device GB/s, and how the time splits
between filling the pinned buffer (host clock), the copies and the compute
(CUDA events); the record carries them as ``record.stream_pass``. On a CPU
device the same functions run without streams: the block is the staging
buffer.

Results are tensors on the device. ``devices=`` takes None (the default
device), one device, or a list of them: with more than one, row blocks go
round-robin to ``devices[i % D]``, each slot with its own accumulator,
pinned double buffer, streams and events, and the slots' partial sums are
added on ``devices[0]`` in slot order (the JAX package's
``_stream_accumulate_multi``). A device may appear twice: two slots on one
card overlap one block's copy with the other's compute. The functions
without ``devices=`` take ``device=``. Seeds split and draw through
``ops.random_svd``'s seams (``_split_seed``, ``_fold_seed``,
``_draw_sketch``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from corrla_rs_tpu_torch.ops import random_svd as _rsvd
from corrla_rs_tpu_torch.utils.device import default_device
from corrla_rs_tpu_torch.utils.log import get_logger

__all__ = [
    "RowBlockSource",
    "streamed_random_svd",
    "streamed_single_pass_svd",
    "streamed_gram",
    "streamed_cov",
    "streamed_pearson_corr",
    "streamed_pca",
    "streamed_pod",
    "streamed_dmdc",
    "streamed_hosvd",
]


class RowBlockSource:
    """Adapter giving a block-producing callable the row-sliceable
    protocol the streaming drivers expect (``.shape``, ``.dtype``,
    ``src[start:stop]``).

    ``fn(start, stop)`` must return the rows ``[start, stop)`` as a host
    array of shape ``(stop - start,) + shape[1:]``. Use for matrices that
    are generated (simulation snapshots, database reads) rather than
    stored: nothing is ever materialized at full size.
    """

    def __init__(self, fn, shape, dtype=np.float32):
        self._fn = fn
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)

    def __getitem__(self, idx):
        if not isinstance(idx, slice) or idx.step not in (None, 1):
            raise TypeError(
                "RowBlockSource supports contiguous row slices only"
            )
        start, stop, _ = idx.indices(self.shape[0])
        out = np.asarray(self._fn(start, stop), dtype=self.dtype)
        expect = (stop - start,) + self.shape[1:]
        if out.shape != expect:
            raise ValueError(
                f"block fn returned shape {out.shape}, expected {expect}"
            )
        return out


def _source_meta(a):
    shape = tuple(int(s) for s in a.shape)
    dtype = np.dtype(getattr(a, "dtype", np.float32))
    return shape, dtype


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _devices(devices) -> list:
    """The slots' devices of ``devices=``: None is the default device; one
    device or a sequence of them. A CUDA device without an index is the
    current one."""
    if devices is None:
        devices = [default_device()]
    elif not isinstance(devices, (list, tuple)):
        devices = [devices]
    if not devices:
        raise ValueError("devices= is empty")
    out = []
    for dev in devices:
        dev = torch.device(dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    return out


def _reduce_slots(parts: list, device):
    """The slots' partial sums (tensors or tuples of them) added on
    ``device`` in slot order."""
    total = parts[0]
    for part in parts[1:]:
        if isinstance(total, tuple):
            total = tuple(t + p.to(device) for t, p in zip(total, part))
        else:
            total = total + part.to(device)
    return total


def _default_block_rows(n: int, row_elems: int, dtype) -> int:
    """~512 MB of source rows a block (>= 64 rows)."""
    itemsize = np.dtype(dtype).itemsize
    b = max(64, int(512e6 / max(row_elems * itemsize, 1)))
    return min(n, b)


def _row_blocks(a, n: int, block_rows: int):
    """(i, host rows [i b, (i + 1) b)); the last block is shorter."""
    for i, lo in enumerate(range(0, n, block_rows)):
        yield i, a[lo:min(lo + block_rows, n)]


def _col_blocks(x, n_cols: int, block_cols: int):
    """(i, host columns ``x[:, lo:hi]``); the last block is narrower."""
    for i, lo in enumerate(range(0, n_cols, block_cols)):
        yield i, x[:, lo:min(lo + block_cols, n_cols)]


def _fill(stage: torch.Tensor, src) -> torch.Tensor:
    """Copy the host block ``src`` into the front of the flat staging
    buffer; returns that part, shaped like the block. torch's copy runs on
    the CPU's threads; a read-only source (an ``np.memmap`` opened 'r') is
    copied by numpy, which takes it without a warning."""
    arr = np.asarray(src)
    view = stage[:arr.size].view(arr.shape)
    if arr.flags.writeable:
        view.copy_(torch.from_numpy(arr))
    else:
        np.copyto(view.numpy(), arr, casting="same_kind")
    return view


class _Slot:
    """One device's share of a pass. CUDA: two pinned staging buffers and
    two device buffers of ``block_elems`` each, a side stream and events;
    the copy of a block runs on the side stream while the host fills the
    other staging buffer, events order compute after copy and guard each
    buffer's reuse, so at most one block of the slot is in flight. CPU:
    the staging buffer is the block. Two slots on one device keep their
    own buffers, streams and events."""

    def __init__(self, device: torch.device, block_elems: int, tdt):
        self.device = device
        self.n_bytes, self.n_blocks, self.fill_s = 0, 0, 0.0
        self.copy_ev, self.compute_ev = [], []
        self.pending = None
        if device.type != "cuda":
            self.stage = torch.empty(block_elems, dtype=tdt)
            return
        self.main = torch.cuda.current_stream(device)
        self.side = torch.cuda.Stream(device)
        self.host = [torch.empty(block_elems, dtype=tdt, pin_memory=True)
                     for _ in range(2)]
        self.dev = [torch.empty(block_elems, dtype=tdt, device=device)
                    for _ in range(2)]
        self.copied = [torch.cuda.Event() for _ in range(2)]
        self.used = [torch.cuda.Event() for _ in range(2)]

    def _filled(self, stage, src):
        t0 = time.perf_counter()
        blk = _fill(stage, src)
        self.fill_s += time.perf_counter() - t0
        self.n_bytes += blk.numel() * blk.element_size()
        self.n_blocks += 1
        return blk

    def put(self, i: int, src, acc, step):
        """Take host block ``i``; returns the accumulator after the step of
        the block before it (CUDA) or of this one (CPU)."""
        if self.device.type != "cuda":
            return step(acc, self._filled(self.stage, src), i)
        b = self.n_blocks % 2
        self.copied[b].synchronize()     # host[b]'s last copy has left it
        hblk = self._filled(self.host[b], src)
        with torch.cuda.stream(self.side):
            self.side.wait_event(self.used[b])   # no compute reads dev[b]
            dblk = self.dev[b][:hblk.numel()].view(hblk.shape)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record(self.side)
            dblk.copy_(hblk, non_blocking=True)
            ev[1].record(self.side)
            self.copied[b].record(self.side)
            self.copy_ev.append(ev)
        acc = self.finish(acc, step)
        self.pending = (i, b, dblk)
        return acc

    def finish(self, acc, step):
        """The step of the block still pending, if any."""
        if self.pending is None:
            return acc
        i, b, dblk = self.pending
        self.pending = None
        self.main.wait_event(self.copied[b])
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record(self.main)
        acc = step(acc, dblk, i)
        ev[1].record(self.main)
        self.used[b].record(self.main)
        self.compute_ev.append(ev)
        return acc


def _stream_slots(blocks, block_elems: int, dtype: np.dtype, devices,
                  accs, step, what: str) -> list:
    """accs[d] = step(accs[d], device_block, i) over the host blocks, one
    pass: block i goes round-robin to slot d = i % len(devices), each slot
    a ``_Slot`` on its device with its own accumulator. Logs the pass's
    statistics (see the module docstring); returns the accumulators."""
    tdt = _torch_dtype(dtype)
    t_pass = time.perf_counter()
    slots = [_Slot(dev, block_elems, tdt) for dev in devices]
    accs = list(accs)
    for i, src in blocks:
        d = i % len(slots)
        accs[d] = slots[d].put(i, src, accs[d], step)
    for d, slot in enumerate(slots):
        accs[d] = slot.finish(accs[d], step)
    copy_ms = compute_ms = None
    if any(dev.type == "cuda" for dev in devices):
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        copy_ms = sum(a.elapsed_time(b) for sl in slots
                      for a, b in sl.copy_ev)
        compute_ms = sum(a.elapsed_time(b) for sl in slots
                         for a, b in sl.compute_ev)
    where = devices[0] if len(devices) == 1 else \
        ",".join(str(dev) for dev in devices)
    _log_pass(what, where, sum(sl.n_blocks for sl in slots),
              sum(sl.n_bytes for sl in slots), t_pass,
              sum(sl.fill_s for sl in slots), copy_ms, compute_ms)
    return accs


def _stream(blocks, block_elems: int, dtype: np.dtype, device: torch.device,
            acc, step, what: str):
    """acc = step(acc, device_block, i) over the host blocks, one pass on
    one device (``_stream_slots`` with one slot)."""
    return _stream_slots(blocks, block_elems, dtype, [device], [acc], step,
                         what)[0]


def _log_pass(what, device, n_blocks, n_bytes, t_pass, fill_s, copy_ms,
              compute_ms):
    wall_s = time.perf_counter() - t_pass
    stats = {"pass": what, "device": str(device), "blocks": n_blocks,
             "bytes": n_bytes, "wall_s": wall_s, "fill_s": fill_s,
             "copy_ms": copy_ms, "compute_ms": compute_ms,
             "gb_s": n_bytes / max(wall_s, 1e-12) / 1e9}
    get_logger().info(
        "streamed pass %s: %d blocks, %.3f GB in %.4f s (%.2f GB/s); fill "
        "%.4f s, copy %s ms, compute %s ms", what, n_blocks, n_bytes / 1e9,
        wall_s, stats["gb_s"], fill_s, copy_ms, compute_ms,
        extra={"stream_pass": stats})


def _rows_pass(a, n, block_rows, device, acc, step, what):
    return _rows_pass_slots(a, n, block_rows, [device], [acc], step,
                            what)[0]


def _rows_pass_slots(a, n, block_rows, devices, accs, step, what) -> list:
    shape, dtype = _source_meta(a)
    row_elems = int(np.prod(shape[1:], dtype=np.int64))
    return _stream_slots(_row_blocks(a, n, block_rows),
                         block_rows * row_elems, dtype, devices, accs, step,
                         what)


def _chol_qr_cols(w, h):
    """Given H = A^T A W, orthonormalize the columns of A W without
    touching n-space: R^T R = W^T H = (A W)^T (A W); returns H R^{-1}
    (A^T A W stabilized, the next iterate): CholeskyQR in m-space.

    Rank-deficient sketches: the diagonal normalizer gets a relative floor
    (eps * max diag), and R^-1 is ``random_svd._ridged_r_inv``'s, with this
    round's own small and large ridges."""
    if w.dtype == torch.float32:
        eps_small, floor_rel = 1e-6, 1e-6
    else:
        eps_small, floor_rel = 1e-14, 1e-14
    k = w.shape[1]
    yty = w.mT @ h
    yty = 0.5 * (yty + yty.mT)
    diag = torch.diagonal(yty)
    mx = diag.max().clamp_min(1e-300)
    d = torch.sqrt(torch.maximum(diag, floor_rel * mx))
    ytyn = yty / (d[:, None] * d[None, :])
    # with the floored normalizer the entries of ytyn are bounded by ~1.1,
    # so lambda_min >= -1.1 k; 2 (1 + k) dominates it
    eye, ridges = _rsvd._ridges(w, eps_small, 2.0 * (1 + k))
    return (h / d[None, :]) @ _rsvd._ridged_r_inv(ytyn, eye, ridges)


def _gram_power(g, omega, n_iter: int):
    """W = orth-stabilized G^q Omega on the device (G = A^T A)."""
    w = omega
    for _ in range(n_iter):
        w = _chol_qr_cols(w, g @ w)
    return w


def _acc_gram_and_sums(acc, blk, _i):
    g, csum = acc
    g.addmm_(blk.mT, blk)
    csum += blk.sum(dim=0)
    return acc


def streamed_gram(a, block_rows: int | None = None, devices=None):
    """G = A^T A (m, m) accumulated on the device in one streamed pass,
    plus the column-sum vector (for centering). Returns ``(g, col_sums,
    n)``.

    The building block for out-of-core PCA/Pearson: the covariance of the
    centered data is ``(g - outer(s, s)/n) / (n - 1)``. ``devices``: see
    the module docstring; the result lies on the first.
    """
    devs = _devices(devices)
    (n, m), dtype = _source_meta(a)
    if block_rows is None:
        block_rows = _default_block_rows(n, m, dtype)
    tdt = _torch_dtype(dtype)
    accs = [(torch.zeros((m, m), dtype=tdt, device=dev),
             torch.zeros((m,), dtype=tdt, device=dev)) for dev in devs]
    g, s = _reduce_slots(_rows_pass_slots(a, n, block_rows, devs, accs,
                                          _acc_gram_and_sums, "gram"),
                         devs[0])
    return g, s, n


def streamed_cov(a, block_rows: int | None = None, devices=None):
    """Out-of-core sample covariance of columns (``mat_cov_centered``
    semantics, stats_corr.rs:32-43) in ONE streamed pass: implicit
    centering off the Gram, cov = (G - s s^T / n) / (n - 1).

    Numerics: single-pass implicit centering cancels catastrophically
    when |column mean| >> column std (error ~ eps * mean^2/var); for such
    data pre-shift the source by an approximate mean (any constant shift
    leaves the covariance unchanged) or stream in f64.
    """
    g, s, n = streamed_gram(a, block_rows, devices)
    return (g - torch.outer(s, s) / n) / (n - 1.0)


def streamed_pearson_corr(a, block_rows: int | None = None, devices=None):
    """Out-of-core Pearson correlation matrix between columns
    (``pearson_corr`` semantics, stats_corr.rs:14-28) in ONE streamed
    pass. Same implicit-centering caveat as ``streamed_cov``."""
    cov = streamed_cov(a, block_rows, devices)
    d = torch.sqrt(torch.diagonal(cov))
    return cov / torch.outer(d, d)


def streamed_random_svd(
    a,
    rank: int,
    n_iter: int,
    n_oversamples: int = 10,
    key=0,
    block_rows: int | None = None,
    method: str = "gram",
    center: bool = False,
    devices=None,
):
    """Out-of-core randomized SVD: A never resident on the device.

    a: host row-sliceable source (numpy array / ``np.memmap`` /
    ``RowBlockSource``) of shape (n, m) with m small enough for (m, k)
    [+ (m, m) for 'gram'] device factors. Returns ``(u, s, vt)`` like
    ``ops.random_svd.random_svd``; u is (n, rank) on the device.

    method='gram' (default): 3 passes over A. method='power': n_iter + 2
    passes, no (m, m) storage. center=True subtracts the column means
    implicitly (exact, through the Gram/sum algebra): the out-of-core PCA
    path; method='gram' only. ``devices`` (method='gram' only, as in the
    JAX package): see the module docstring; the factors lie on the first.
    """
    (n, m), dtype = _source_meta(a)
    if n < m:
        raise ValueError(
            "streamed_random_svd streams ROW blocks and requires n >= m "
            f"(got {n} x {m}); store the transpose (tall orientation) — "
            "an out-of-core transpose would re-read the source m/block "
            "times"
        )
    if center and method != "gram":
        raise ValueError("center=True requires method='gram'")
    if method not in ("gram", "power"):
        raise ValueError(f"method must be 'gram' or 'power', got {method!r}")
    if devices is not None and method != "gram":
        raise ValueError("devices= requires method='gram'")
    devs = _devices(devices)
    dev = devs[0]
    tdt = _torch_dtype(dtype)
    if block_rows is None:
        block_rows = _default_block_rows(n, m, dtype)
    k, rank = _rsvd._widths(m, rank, n_oversamples)
    omega = _rsvd._draw_sketch(key, (m, k), tdt, dev)

    csum = torch.zeros((m,), dtype=tdt, device=dev)
    if method == "gram":
        # with neither the Gram nor the column sums consumed, the pass is
        # skipped: the sketch-only factorization needs 2 passes, not 3
        w = omega
        if n_iter > 0 or center:
            g, csum, _ = streamed_gram(a, block_rows=block_rows,
                                       devices=devs)
            if center:
                mu = csum / n
                g = g - n * torch.outer(mu, mu)
            if n_iter > 0:
                w = _gram_power(g, omega, int(n_iter))
            del g
    else:
        w = omega
        for it in range(int(n_iter)):
            def h_step(h, blk, _i, w=w):
                return h.addmm_(blk.mT, blk @ w)

            h = _rows_pass(a, n, block_rows, dev,
                           torch.zeros((m, k), dtype=tdt, device=dev),
                           h_step, f"power {it + 1}")
            w = _chol_qr_cols(w, h)

    # pass: Y = (A - 1 mu^T) W, written block by block into (n, k) on the
    # first device; each slot multiplies by its own copy of W
    mu_w = ((csum / n)[None, :] @ w) if center else None
    reps = [(w.to(d), None if mu_w is None else mu_w.to(d)) for d in devs]

    def y_step(y, blk, i):
        lo = i * block_rows
        w_d, mu_d = reps[i % len(devs)]
        dst = y[lo:lo + blk.shape[0]]
        out = (torch.matmul(blk, w_d, out=dst) if blk.device == y.device
               else blk @ w_d)
        if mu_d is not None:
            out -= mu_d
        if out is not dst:
            dst.copy_(out)
        return y

    y = torch.empty((n, k), dtype=tdt, device=dev)
    _rows_pass_slots(a, n, block_rows, devs, [y] * len(devs), y_step, "Y")
    q = torch.linalg.qr(y, mode="reduced").Q     # final QR: exact Householder
    del y

    # pass: B = Q^T (A - 1 mu^T) = sum_i Q_i^T A_i - (Q^T 1) mu^T
    q_reps = [q.to(d) for d in devs]

    def b_step(b, blk, i):
        lo = i * block_rows
        return b.addmm_(q_reps[i % len(devs)][lo:lo + blk.shape[0]].mT, blk)

    b = _reduce_slots(_rows_pass_slots(
        a, n, block_rows, devs,
        [torch.zeros((k, m), dtype=tdt, device=d) for d in devs], b_step,
        "B"), dev)
    if center:
        b = b - torch.outer(q.sum(dim=0), csum / n)
    u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
    u = q @ u_b
    return u[:, :rank], s[:rank], vt[:rank, :]


def _psi_keys(k_psi, n_blocks: int, device) -> list:
    """One key a block, ``_fold_seed(k_psi, i)``, each drawing the same
    numbers every time it is used: a generator is replaced by its seed
    (drawing from it would advance it, and both passes draw each block)."""
    keys = [_rsvd._fold_seed(k_psi, i, device) for i in range(n_blocks)]
    return [k.initial_seed() if isinstance(k, torch.Generator) else k
            for k in keys]


def _psi_block(key, ell: int, block_rows: int, rows: int, dtype, device):
    """Columns of Psi for the rows of one block: drawn at the full block
    shape (ell, block_rows), as the JAX package draws them, and cut to the
    block's ``rows``."""
    psi = _rsvd._draw_sketch(key, (ell, block_rows), dtype, device)
    return psi[:, :rows]


def streamed_single_pass_svd(
    a,
    rank: int,
    n_oversamples: int = 10,
    core_oversamples: int | None = None,
    key=0,
    block_rows: int | None = None,
    device=None,
):
    """One-pass out-of-core sketch SVD (Tropp et al. 2017 two-sided
    sketch, the algorithm of ``ops.random_svd.single_pass_svd``, with
    both sketches accumulated while A streams by ONCE).

    The co-range test matrix Psi (ell, n) is never materialized: its
    column block for rows [i*b, (i+1)*b) is drawn again from
    ``_fold_seed(k_psi, i)``, during the accumulation pass and in the
    later (device-only) B = Psi Q product. ``device``: where the factors
    live (default ``utils.device.default_device()``).
    """
    (n, m), dtype = _source_meta(a)
    if n < m:
        raise ValueError(
            f"streamed_single_pass_svd requires tall input (n >= m), got "
            f"{n} x {m}; store the transpose"
        )
    dev = torch.device(device) if device is not None else default_device()
    tdt = _torch_dtype(dtype)
    if block_rows is None:
        block_rows = _default_block_rows(n, m, dtype)
    k, ell = _rsvd._single_pass_widths(n, m, rank, n_oversamples,
                                       core_oversamples)
    rank = min(int(rank), k)
    k_om, k_psi = _rsvd._split_seed(key, 2, dev)
    omega = _rsvd._draw_sketch(k_om, (m, k), tdt, dev)
    psi_keys = _psi_keys(k_psi, -(-n // block_rows), dev)

    def step(acc, blk, i):
        y, w = acc
        lo = i * block_rows
        rows = blk.shape[0]
        torch.matmul(blk, omega, out=y[lo:lo + rows])
        w.addmm_(_psi_block(psi_keys[i], ell, block_rows, rows, tdt, dev),
                 blk)
        return acc

    y, w = _rows_pass(a, n, block_rows, dev,
                      (torch.empty((n, k), dtype=tdt, device=dev),
                       torch.zeros((ell, m), dtype=tdt, device=dev)),
                      step, "single pass")
    q = torch.linalg.qr(y, mode="reduced").Q
    del y

    # B = Psi Q accumulated block by block on the device (Psi drawn again)
    b = torch.zeros((ell, k), dtype=tdt, device=dev)
    for i, lo in enumerate(range(0, n, block_rows)):
        q_i = q[lo:lo + block_rows]
        b.addmm_(_psi_block(psi_keys[i], ell, block_rows, q_i.shape[0], tdt,
                            dev), q_i)
    u_x, s, vt = _rsvd._core_svd(b, w)
    u = q @ u_x
    return u[:, :rank], s[:rank], vt[:rank, :]


def streamed_pca(a, n_comps: int, n_iter: int = 20,
                 n_oversamples: int | None = None, key=0,
                 block_rows: int | None = None, devices=None):
    """Out-of-core PCA: reference ``PcaRsvd`` semantics (pca_rsvd.rs:56-82;
    column centering, RSVD with 20 power iterations, min(n_dim, 10)
    oversamples) on a host-resident sample matrix of any length.

    Returns ``(singular_values (r, 1), components (r, m))`` matching
    ``api.rpca``'s layout.
    """
    (_n, m), _ = _source_meta(a)
    if n_oversamples is None:
        n_oversamples = min(m, 10)
    _u, s, vt = streamed_random_svd(
        a, int(n_comps), n_iter, n_oversamples, key=key,
        block_rows=block_rows, method="gram", center=True,
        devices=devices,
    )
    return s[:, None], vt


def streamed_hosvd(tensor, ranks, block_slabs: int | None = None,
                   compute_mode0_rows: bool = True, device=None):
    """Out-of-core truncated HOSVD for a tensor streamed in slabs along
    axis 0 (the long axis).

    Every mode factor comes from the eigendecomposition of that mode's
    Gram matrix, accumulated slab by slab on the device:

    - mode 0 (long axis): G_0^c = X_(0)^T X_(0) (N, N) with
      N = prod(other dims); U_0 = X_(0) V_r S_r^{-1} in a second pass;
    - modes k >= 1 (short axes): G_k = X_(k) X_(k)^T (I_k, I_k)
      accumulated from each slab's mode-k unfolding;
    - core: in the second pass too, core += U_0[rows]^T (slab x_1 U_1^T
      x_2 ...).

    Device memory O(N^2 + I_0 r_0 + core). Returns ``(core, factors)``
    like ``ops.hosvd.hosvd``; ``factors[0]`` is None when
    ``compute_mode0_rows`` is False.
    """
    from corrla_rs_tpu_torch.ops.hosvd import mode_multiply

    dev = torch.device(device) if device is not None else default_device()
    shape, dtype = _source_meta(tensor)
    tdt = _torch_dtype(dtype)
    ndim = len(shape)
    if ndim < 2:
        raise ValueError("streamed_hosvd needs a tensor of ndim >= 2")
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) != ndim:
        raise ValueError(
            f"ranks {ranks} must have one entry per tensor mode ({ndim})"
        )
    for kk, (r, d) in enumerate(zip(ranks, shape)):
        if not 1 <= r <= d:
            raise ValueError(
                f"ranks[{kk}]={r} must be in [1, {d}]"
            )
    n0 = shape[0]
    n_rest = int(np.prod(shape[1:]))
    if ranks[0] > n_rest:
        # fail before streaming the (possibly multi-GB) source: the mode-0
        # unfolding has only n_rest columns
        raise ValueError(
            f"ranks[0]={ranks[0]} exceeds prod(other dims)={n_rest}; the "
            "mode-0 unfolding cannot have higher rank — lower ranks[0]"
        )
    if block_slabs is None:
        block_slabs = _default_block_rows(n0, n_rest, dtype)

    # pass 1: every mode's Gram at once
    def gram_step(acc, slab, _i):
        g0, gs = acc
        flat = slab.reshape(slab.shape[0], -1)
        g0.addmm_(flat.mT, flat)
        for kk in range(1, ndim):
            unf = torch.movedim(slab, kk, 0).reshape(shape[kk], -1)
            gs[kk - 1].addmm_(unf, unf.mT)
        return acc

    g0, gs = _rows_pass(
        tensor, n0, block_slabs, dev,
        (torch.zeros((n_rest, n_rest), dtype=tdt, device=dev),
         [torch.zeros((shape[kk], shape[kk]), dtype=tdt, device=dev)
          for kk in range(1, ndim)]),
        gram_step, "hosvd grams")

    # short-mode factors: leading eigenvectors of the small Grams
    factors = [None] * ndim
    for kk in range(1, ndim):
        _wv, vv = torch.linalg.eigh(gs[kk - 1])
        factors[kk] = vv.flip(-1)[:, :ranks[kk]]

    # mode-0 factor from the co-Gram: V_r, S_r of X_(0)
    w0, v0 = torch.linalg.eigh(g0)
    del g0
    s0 = torch.sqrt(w0.flip(-1)[:ranks[0]].clamp_min(1e-30))
    v0r = v0.flip(-1)[:, :ranks[0]]

    # pass 2: U_0's rows and the core from the same slab stream
    def proj_step(acc, slab, _i):
        core, u_rows = acc
        proj = slab
        for kk in range(1, ndim):
            proj = mode_multiply(proj, factors[kk].mT, kk)
        flat = slab.reshape(slab.shape[0], -1)
        u_blk = (flat @ v0r) / s0[None, :]
        core.addmm_(u_blk.mT, proj.reshape(proj.shape[0], -1))
        if compute_mode0_rows:
            u_rows.append(u_blk)
        return acc

    core_flat, u_blocks = _rows_pass(
        tensor, n0, block_slabs, dev,
        (torch.zeros((ranks[0], int(np.prod(ranks[1:]))), dtype=tdt,
                     device=dev), []),
        proj_step, "hosvd core")
    factors[0] = torch.cat(u_blocks, dim=0) if compute_mode0_rows else None
    return core_flat.reshape(ranks), factors


def streamed_pod(x, t, n_modes: int, block_cols: int | None = None,
                 device=None):
    """Out-of-core POD: spatial grids larger than memory, via the method
    of snapshots (Sirovich 1987).

    x: (n_snapshots, n_points) with n_points huge: any object supporting
    COLUMN slices ``x[:, lo:hi]`` (numpy array, ``np.memmap``, HDF5
    dataset...). Column chunks stream host -> device exactly twice:

    - pass 1 accumulates the small snapshot Gram H = X X^T
      (n_snap, n_snap) on the device;
    - ``eigh(H)`` gives sigma_i = sqrt(lambda_i), and the mode weights
      come free as W = X Phi = V Sigma;
    - pass 2 assembles the spatial modes Phi = X^T V Sigma^{-1} chunk by
      chunk ((n_points, n_modes) must fit on the device, as the fitted
      model itself).

    Returns a fitted ``models.pod.PodI``, built with the attributes and
    the chain of the port's constructor (t in the snapshots' dtype, the
    weights' RBF fit through ``rbf_fit``, whose kernel matrix runs on the
    card), so ``predict`` and the checkpoints work on it as on any fit.
    """
    from corrla_rs_tpu_torch.models.pod import PodI
    from corrla_rs_tpu_torch.ops.interp import rbf_fit
    from corrla_rs_tpu_torch.utils.config import PodConfig
    from corrla_rs_tpu_torch.utils.device import as_tensor

    dev = torch.device(device) if device is not None else default_device()
    shape, dtype = _source_meta(x)
    if len(shape) != 2:
        raise ValueError(f"x must be 2-D (n_snapshots, n_points), got {shape}")
    n_snap, n_pts = shape
    tdt = _torch_dtype(dtype)
    t = as_tensor(t, device=dev, dtype=tdt)
    if t.shape[0] != n_snap:
        raise ValueError(
            f"t rows ({t.shape[0]}) must match snapshot rows ({n_snap})"
        )
    r = min(int(n_modes), n_snap)
    if block_cols is None:
        block_cols = max(64, int(512e6 / max(n_snap * dtype.itemsize, 1)))
        block_cols = min(n_pts, block_cols)

    def gram_step(h, blk, _i):
        return h.addmm_(blk, blk.mT)

    h = _stream(_col_blocks(x, n_pts, block_cols), n_snap * block_cols,
                dtype, dev, torch.zeros((n_snap, n_snap), dtype=tdt,
                                        device=dev), gram_step, "pod gram")
    lam, v = torch.linalg.eigh(h)
    lam, v = lam.flip(-1), v.flip(-1)
    sig = torch.sqrt(lam[:r].clamp_min(1e-30))
    vs = v[:, :r] / sig[None, :]          # X^T vs = orthonormal modes
    weights = v[:, :r] * sig[None, :]     # X Phi == V Sigma, exactly

    def modes_step(modes, blk, i):
        lo = i * block_cols
        torch.matmul(blk.mT, vs, out=modes[lo:lo + blk.shape[1]])
        return modes

    modes = _stream(_col_blocks(x, n_pts, block_cols), n_snap * block_cols,
                    dtype, dev, torch.empty((n_pts, r), dtype=tdt,
                                            device=dev), modes_step,
                    "pod modes")

    cfg = PodConfig()
    model = PodI.__new__(PodI)
    model._n_iter = int(cfg.n_iter)
    model._n_oversamples = int(cfg.n_oversamples)
    model._device = device
    model.n_snapshots = n_snap
    model.n_modes = r
    model.t_abscissa = t
    model.modes = modes
    model.mode_weights = weights
    model._rbf_coeffs = rbf_fit(t, weights, "linear", 1.0, 1)
    return model


def _top_eigh_desc(g, r: int):
    """(sigma, 1/sigma cut, V) of the top-r singular structure from an
    eigh of the (m, m) Gram, descending, with a relative rank cutoff on
    the inverse: directions below ~sqrt(eps) sigma_max are unresolved by
    the squared Gram, and their 1/sigma would amplify rounding into the
    reduced operators."""
    lam, v = torch.linalg.eigh(g)
    lam = lam.flip(-1)[:r]
    v = v.flip(-1)[:, :r]
    sig = torch.sqrt(lam.clamp_min(0.0))
    cut = (1e-7 if g.dtype == torch.float64 else 1e-4) * sig.max()
    sig_inv = torch.where(sig > cut, 1.0 / sig.clamp_min(1e-300),
                          torch.zeros_like(sig))
    return sig, sig_inv, v


def streamed_dmdc(x, u, n_modes: int, block_rows: int | None = None,
                  dt: float | None = None, device=None):
    """Out-of-core DMDc: state dimensions larger than device memory, via
    the method of snapshots (reference dmd_rom.rs:20-225).

    x: (n_x, n_t) snapshot columns with n_x huge: any object supporting
    ROW slices ``x[lo:hi]``. u: (n_u, n_t) control columns, small, in
    memory. Row chunks stream host -> device exactly twice:

    - pass 1 accumulates the time-axis Gram H = X^T X (n_t, n_t): the
      input-space Gram is H[:-1, :-1] + U1^T U1, the output-space Gram
      H[1:, 1:], the cross term X1^T X' = H[:-1, 1:], so both SVDs (eigh
      of the Grams) and A~ (eq. 29) / B~ (eq. 30) cost no further pass;
    - pass 2 assembles the tall factors chunk by chunk: U_hat (n_x, r),
      the eq. 36 mode prefactor (n_x, r), and B = U_hat B~.

    Returns a fitted ``models.dmd.DMDc`` built with the port's attributes
    and the chain of its constructor's host backend (the r x r eig on the
    host, the modes, the factored dynamics through ``pinv_comp_parts``
    with the host cutoff), so ``predict_multiple`` and the checkpoints work
    on it as on any fit. The snapshot SVDs here are exact (no sketch);
    directions below ~sqrt(eps) sigma_max are rank-cut out of the reduced
    operators.
    """
    from corrla_rs_tpu_torch.models import dmd as _dmd
    from corrla_rs_tpu_torch.utils.config import DmdConfig
    from corrla_rs_tpu_torch.utils.device import as_tensor

    dev = torch.device(device) if device is not None else default_device()
    shape, dtype = _source_meta(x)
    if len(shape) != 2:
        raise ValueError(f"x must be 2-D (n_x, n_t), got {shape}")
    n_x, n_t = shape
    tdt = _torch_dtype(dtype)
    u = as_tensor(u, device=dev)
    if u.ndim != 2 or u.shape[1] != n_t:
        raise ValueError(
            f"u must be (n_u, n_t={n_t}), got {tuple(u.shape)}"
        )
    n_u = u.shape[0]
    m = n_t - 1
    r = min(int(n_modes), m)
    if block_rows is None:
        block_rows = _default_block_rows(n_x, n_t, dtype)

    # pass 1: time-axis Gram
    h = _rows_pass(x, n_x, block_rows, dev,
                   torch.zeros((n_t, n_t), dtype=tdt, device=dev),
                   lambda acc, blk, _i: acc.addmm_(blk.mT, blk), "dmdc gram")

    # reduced algebra, all (m, m)-sized or smaller, on the device
    u1 = u[:, :m].to(tdt)
    g_in = h[:m, :m] + u1.mT @ u1
    s_in, s_in_inv, v_in = _top_eigh_desc(g_in, r)
    s_out, s_out_inv, v_out = _top_eigh_desc(h[1:, 1:], r)
    v_in_s = v_in * s_in_inv[None, :]       # V~ S~^-1   (m, r)
    v_out_s = v_out * s_out_inv[None, :]    # V^ S^^-1   (m, r)
    # U~1^T U_hat = S~^-1 V~^T (X1^T X') V^ S^^-1    (r, r)
    k_mat = (v_in_s.mT @ h[:m, 1:]) @ v_out_s
    # U_hat^T X' V~ S~^-1 = S^ V^^T V~ S~^-1         (r, r)
    tmp_op_scale = s_out[:, None] * (v_out.mT @ v_in_s)
    a_til = tmp_op_scale @ k_mat                          # eq. 29
    b_til = tmp_op_scale @ (u1 @ v_in_s).mT               # eq. 30
    del h, g_in

    # pass 2: tall factors, rows of U_hat = X' V^ S^^-1 and of the mode
    # prefactor X' V~ S~^-1 (U~1^T U_hat)
    def tall_step(acc, blk, i):
        u_hat, tmp_modes = acc
        lo = i * block_rows
        rows = slice(lo, lo + blk.shape[0])
        xp = blk[:, 1:]
        torch.matmul(xp, v_out_s, out=u_hat[rows])
        torch.matmul(xp @ v_in_s, k_mat, out=tmp_modes[rows])
        return acc

    u_hat, tmp_modes_scale = _rows_pass(
        x, n_x, block_rows, dev,
        (torch.empty((n_x, r), dtype=tdt, device=dev),
         torch.empty((n_x, r), dtype=tdt, device=dev)), tall_step,
        "dmdc factors")

    model = _dmd.DMDc.__new__(_dmd.DMDc)
    model.n_snapshots = n_t
    model.n_x = n_x
    model.n_u = n_u
    model.n_modes = r
    model.dt_snapshots = float(dt if dt is not None else DmdConfig().dt)
    model._A = a_til
    model._B = u_hat @ b_til
    model._u_hat = u_hat
    model.lambdas, lam_re, lam_im, v_re, v_im = _dmd._spectrum(a_til, "host")
    model.modes_re = tmp_modes_scale @ v_re
    model.modes_im = tmp_modes_scale @ v_im
    model._a_full = None
    model._w_re, model._w_im = _dmd._factored(
        lam_re, lam_im, model.modes_re, model.modes_im, _dmd._HOST_PINV_RTOL)
    return model
