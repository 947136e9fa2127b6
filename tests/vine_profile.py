"""Launches and wall time of one vine pair fit on the card.

Runs ``ops.vine._fit_pair`` on 65,536 planted pairs (a gaussian copula at
Kendall tau 0.5, so ten of the fifteen families are admissible and scored)
two ways: with the port's batched scorer (``vine._PairScorer``: the t grid
as one quantile computation, the rotations as one), and with each family
scored on its own, as the JAX package's code is written
(``sum(_LOGPDF[family](u, v, theta))`` a family). Prints, for each, the
median wall of three fits after a warm-up, the aten operations one fit
dispatches (a ``TorchDispatchMode`` counter), and the CUDA kernels
``torch.profiler`` records for one family's log-density and for the
batched t grid's quantiles (kernels per operation); then the largest
difference between the two ways' log-likelihoods, which must stay below
1e-12 of their scale. Run from the repo root on a machine with a GPU:

    PYTHONPATH=. python3 tests/vine_profile.py [--n 65536]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class OpCount(TorchDispatchMode):
    """Counts the aten operations dispatched while active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


class EachFamily:
    """The families scored one at a time, as the JAX package's code is
    written; the interface of ``vine._PairScorer`` that ``_fit_pair``
    uses."""

    def __init__(self, u, v, families):
        from corrla_rs_tpu_torch.ops import vine

        self._vine, self.u, self.v = vine, u, v
        self.families = list(families)

    def loglik(self, theta):
        return torch.stack([self._vine._LOGPDF[f](self.u, self.v, th).sum()
                            for f, th in zip(self.families, theta)])


def timed(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


def ops_of(fn):
    with OpCount() as count:
        fn()
    torch.cuda.synchronize()
    return count.n


def kernels_of(fn):
    prof_mod = torch.profiler
    with prof_mod.profile(activities=[prof_mod.ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in p.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=65_536)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("vine_profile: no CUDA device", file=sys.stderr)
        return 2
    from corrla_rs_tpu_torch.ops import vine

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.rand(args.n, 2, generator=gen, device=dev,
                   dtype=torch.float64).clamp(1e-6, 1 - 1e-6)
    rho = vine._theta_from_tau("gaussian", 0.5)
    u = vine._HINV["gaussian"](w[:, 1], w[:, 0], rho)
    v = w[:, 0]

    def fit():
        return vine._fit_pair(u, v, vine.FAMILIES)

    batched = vine._PairScorer
    rows = {}
    for name, scorer in (("batched", batched), ("per_family", EachFamily)):
        vine._PairScorer = scorer
        try:
            result, sec = timed(fit)
            rows[name] = {"fit": result[:2], "wall_s": sec,
                          "aten_ops": ops_of(fit)}
        finally:
            vine._PairScorer = batched
        print(f"[{name}] {args.n} pairs, 15 families: {result[0]} theta "
              f"{result[1]:.6f}; median wall {sec:.4f} s; "
              f"{rows[name]['aten_ops']} aten operations a fit", flush=True)

    tau = float(vine.kendall_tau(u, v))
    fams = [f for f in vine.FAMILIES if f != "independent"
            and vine._family_admissible(f, tau)]
    theta = torch.tensor([vine._theta_from_tau(f, tau) for f in fams],
                         dtype=torch.float64, device=dev)
    got = batched(u, v, fams).loglik(theta)
    want = EachFamily(u, v, fams).loglik(theta)
    diff = float((got - want).abs().max() / want.abs().max())
    one_t = kernels_of(lambda: vine._LOGPDF["t5"](u, v, 0.7).sum())
    one_t_ops = ops_of(lambda: vine._LOGPDF["t5"](u, v, 0.7).sum())
    prep = kernels_of(lambda: batched(u, v, fams))
    prep_ops = ops_of(lambda: batched(u, v, fams))
    print(f"[kernels] one t family's log-density: {one_t} CUDA kernels, "
          f"{one_t_ops} aten operations; the batched scorer's setup (the "
          f"t grid's quantiles): {prep} kernels, {prep_ops} operations",
          flush=True)
    ok = diff <= 1e-12 and rows["batched"]["fit"] == rows["per_family"]["fit"]
    print(f"[equal] {len(fams)} admissible families' log-likelihoods differ "
          f"by {diff:.2e} of their scale (tol 1e-12); same fit: "
          f"{rows['batched']['fit'] == rows['per_family']['fit']}",
          flush=True)
    print(json.dumps({"n": args.n, "rows": rows, "one_t_kernels": one_t,
                      "one_t_ops": one_t_ops, "prep_kernels": prep,
                      "prep_ops": prep_ops, "loglik_rel_diff": diff}))
    print(smi)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
