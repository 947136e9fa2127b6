"""What every script of ``examples_torch/`` shares: the device option, the
first line (the card's name and power limit), host copies, the check of
every kernel launch against its plain version, and the last lines (the
kernels' launch counts, then one JSON result line).

A script runs on the card unless it is given ``--device cpu``. Asked for
``cuda`` on a machine without one, it exits with code 2 and a message that
names the missing device; it never falls back to the CPU.

The last line of every script is one JSON object::

    {"script": "...", "ok": true, "device": "...", "wall_s": ...,
     "headline": "one line of its main figures", "metrics": {...}}

and the line before it is ``launches: {"pairwise_kernel_matrix": N,
"rbf_matvec": M, "modes_product": P}``, the CUDA kernels' launch counts over
the whole run (0 on the CPU, where the wrappers run their plain versions). With
``--check-kernels`` every launch is held against its plain PyTorch version
in f64 on the same inputs, and a ``kernel checks: [...]`` line (one entry a
kernel, phi, dtype and shape) comes before the launch line. ``ok`` says
whether the script's own checks (and the kernel checks) held; the exit code
is the script's own, as in its JAX counterpart.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from corrla_rs_tpu_torch.ops import rbf_kernels  # noqa: E402
from corrla_rs_tpu_torch.utils.device import set_default_device  # noqa: E402

_T0 = [time.perf_counter()]


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with ``--device`` (default ``cuda``)."""
    ap = argparse.ArgumentParser(
        description=doc.strip().splitlines()[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="device to run on: cuda (the card) or cpu")
    ap.add_argument("--check-kernels", action="store_true",
                    help="hold every kernel launch against its plain "
                    "PyTorch version in f64 on the same inputs")
    return ap


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return f"card: none, running on {dev}"
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, timeout=60, check=True)
    return f"card: {proc.stdout.strip().splitlines()[0]}"


def start(args, name: str) -> torch.device:
    """Check and select ``args.device``, wrap the kernel launches if
    ``--check-kernels`` asks for it, print the card line, start the wall
    clock; returns the device."""
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print(f"{name}: no CUDA device (torch.cuda.is_available() is "
                  f"False); --device {args.device} needs an NVIDIA GPU. "
                  "Pass --device cpu to run on the CPU.", file=sys.stderr)
            raise SystemExit(2)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    set_default_device(dev)
    if args.check_kernels:
        check_kernels()
    print(card_line(dev), flush=True)
    _T0[0] = time.perf_counter()
    return dev


def sync(dev: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host(x) -> np.ndarray:
    """A tensor (or anything numpy reads) as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def launches() -> dict:
    return {name: getattr(rbf_kernels, name).launches
            for name in ("pairwise_kernel_matrix", "rbf_matvec",
                         "modes_product")}


# ---------------------------------------------------------------------------
# --check-kernels: every launch of the three CUDA kernels held against its
# plain PyTorch version in f64 on the same inputs, as chip_smoke.py holds
# them at its own shapes: the kernel matrix entrywise to KMAT_RTOL of
# |plain| + the largest |plain| of its block of rows, the matvec to
# MATVEC_RTOL of sum_j |phi_ij c_j|, the modes product entrywise to
# MODES_ERR_KU k u sum_m |a_m w_m|

KMAT_RTOL = {torch.float32: 5e-6, torch.float64: 1e-12}
MATVEC_RTOL = {torch.float32: 1e-4, torch.float64: 1e-12}
MODES_ERR_KU = 2
CHECK_ROWS = 1024   # rows of the plain kernel matrix formed at a time
# "kernel phi dtype shape" -> {"calls", "max_abs_err", "worst_ratio"}
CHECKS: dict = {}


def _worst(err: torch.Tensor, allowed: torch.Tensor) -> float:
    """The largest err / allowed (inf where err is not finite)."""
    err = torch.nan_to_num(err, nan=float("inf"))
    return float((err / allowed).max()) if err.numel() else 0.0


def kmat_error(out, xa, xb, kernel: str, eps: float):
    """(max |out - plain|, worst ratio to the tolerance) of a kernel matrix
    ``out`` of ``xa`` against ``xb``."""
    rtol = KMAT_RTOL[out.dtype]
    xb64 = xb.double()
    max_err = worst = 0.0
    for r0 in range(0, xa.shape[0], CHECK_ROWS):
        want = rbf_kernels.pairwise_kernel_matrix_ref(
            xa[r0:r0 + CHECK_ROWS].double(), xb64, kernel, eps)
        err = (out[r0:r0 + CHECK_ROWS].double() - want).abs()
        allowed = rtol * (want.abs() + want.abs().max()) + 1e-300
        max_err = max(max_err, float(err.max()))
        worst = max(worst, _worst(err, allowed))
    return max_err, worst


def matvec_error(out, x_query, x_support, coeffs, kernel: str, eps: float):
    """(max |out - plain|, worst ratio to the tolerance) of a matvec."""
    q, x, c = x_query.double(), x_support.double(), coeffs.double()
    want = rbf_kernels.rbf_matvec_ref(q, x, c, kernel, eps)
    # every phi is >= 0, so sum_j |phi_ij c_j| = K |c|
    scale = rbf_kernels.rbf_matvec_ref(q, x, c.abs(), kernel, eps)
    err = (out.double() - want).abs()
    return (float(err.max()) if err.numel() else 0.0,
            _worst(err, MATVEC_RTOL[out.dtype] * scale + 1e-300))


def modes_error(out, modes, w):
    """(max |out - plain|, worst ratio to the tolerance) of a modes product
    ``out`` = ``modes @ w.mT``."""
    k = modes.shape[1]
    u = torch.finfo(out.dtype).eps / 2
    wd = w.double()
    max_err = worst = 0.0
    for r0 in range(0, modes.shape[0], CHECK_ROWS):
        md = modes[r0:r0 + CHECK_ROWS].double()
        err = (out[r0:r0 + CHECK_ROWS].double() - md @ wd.mT).abs()
        allowed = MODES_ERR_KU * k * u * (md.abs() @ wd.abs().mT) + 1e-300
        max_err = max(max_err, float(err.max()) if err.numel() else 0.0)
        worst = max(worst, _worst(err, allowed))
    return max_err, worst


def _record(key: str, max_err: float, worst: float) -> None:
    got = CHECKS.setdefault(key, {"calls": 0, "max_abs_err": 0.0,
                                  "worst_ratio": 0.0})
    got["calls"] += 1
    got["max_abs_err"] = max(got["max_abs_err"], max_err)
    got["worst_ratio"] = max(got["worst_ratio"], worst)


def check_kernels() -> None:
    """Hold every launch of the three kernels in this process against its
    plain version (see above). It wraps the three functions through which
    every launch goes, so the launch counts are the program's own; the
    plain versions launch no kernel."""
    phis = {code: name for name, code in rbf_kernels._PHI_CODES.items()}
    launch_kmat = rbf_kernels._launch_kernel_matrix
    matvec_cuda = rbf_kernels._matvec_cuda
    launch_modes = rbf_kernels._launch_modes_product

    def checked_kmat(out, xa, xb, phi, eps):
        launch_kmat(out, xa, xb, phi, eps)
        with torch.no_grad():
            kernel = phis[phi]
            key = (f"pairwise_kernel_matrix {kernel} {str(out.dtype)[6:]} "
                   f"{xa.shape[0]}x{xb.shape[0]} d={xa.shape[1]}")
            _record(key, *kmat_error(out, xa, xb, kernel, eps))

    def checked_matvec(x_query, x_support, coeffs, phi, eps):
        out = matvec_cuda(x_query, x_support, coeffs, phi, eps)
        with torch.no_grad():
            kernel = phis[phi]
            key = (f"rbf_matvec {kernel} {str(out.dtype)[6:]} "
                   f"{x_query.shape[0]}q x {x_support.shape[0]}s "
                   f"d={x_query.shape[1]} C={coeffs.shape[1]}")
            _record(key, *matvec_error(out, x_query, x_support, coeffs,
                                       kernel, eps))
        return out

    def checked_modes(out, modes, w):
        launch_modes(out, modes, w)
        with torch.no_grad():
            key = (f"modes_product {str(out.dtype)[6:]} "
                   f"{modes.shape[0]}x{w.shape[0]} k={modes.shape[1]}")
            _record(key, *modes_error(out, modes, w))

    rbf_kernels._launch_kernel_matrix = checked_kmat
    rbf_kernels._matvec_cuda = checked_matvec
    rbf_kernels._launch_modes_product = checked_modes


def merge_checks(*checks: dict) -> dict:
    """Several processes' CHECKS as one (calls summed, errors the worst)."""
    out: dict = {}
    for part in checks:
        for key, got in part.items():
            have = out.setdefault(key, {"calls": 0, "max_abs_err": 0.0,
                                        "worst_ratio": 0.0})
            have["calls"] += got["calls"]
            have["max_abs_err"] = max(have["max_abs_err"],
                                      got["max_abs_err"])
            have["worst_ratio"] = max(have["worst_ratio"],
                                      got["worst_ratio"])
    return out


def finish(name: str, dev: torch.device, ok: bool, headline: str,
           metrics: dict, *, counts: dict | None = None,
           checks: dict | None = None, **extra) -> None:
    """Print the kernel checks (if any ran), the launch counts and the JSON
    result line. ``counts`` and ``checks`` default to this process's own;
    a script that runs several processes passes their sums. ``headline``
    is one line of the script's main figures. The exit code stays the
    script's own: the benchmarks exit 0 as their JAX counterparts do, and
    ``ok`` tells a reader of the last line whether their checks held."""
    sync(dev)
    checks = CHECKS if checks is None else checks
    if checks:
        rows = [{"check": key, **got} for key, got in sorted(checks.items())]
        bad = [row["check"] for row in rows if not row["worst_ratio"] <= 1.0]
        if bad:
            print(f"FAIL kernel check: {bad}", flush=True)
            ok = False
        print(f"kernel checks: {json.dumps(rows)}", flush=True)
    print(f"launches: {json.dumps(launches() if counts is None else counts)}",
          flush=True)
    print(json.dumps({"script": name, "ok": bool(ok), "device": str(dev),
                      "wall_s": time.perf_counter() - _T0[0],
                      "headline": headline, "metrics": metrics, **extra}),
          flush=True)
