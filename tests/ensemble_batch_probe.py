"""How far the batched DMDc reduction of a member stack lies from the
members' lone fits, and why.

Run from the repo root (on the CPU, or on a machine with one NVIDIA GPU):

    PYTHONPATH=. python3 tests/ensemble_batch_probe.py [--device cuda]

On bench_torch.py's ensemble data (16 members x 20 states x 40 snapshots
f32; numerical rank 2 in the states, 3 with the control, against 6 modes)
it prints, each as the largest gap over the members relative to the
member's largest entry (all six eigenvalues: ``bench_torch.eig_gap``; what
the data determine: ``bench_torch.ensemble_check``):

- ``random_svd._random_svd_members`` on the input and output spaces of
  ``models.dmd._dmdc_reduce`` against ``random_svd`` of each member alone;
- ``dmdc_fit_ensemble`` (the batched pass) against the lone ``DMDc`` fits,
  with member 0's and 1's eigenvalues, by both measures;
- how far the lone fits themselves move when only the arithmetic changes:
  the same snapshots in column-major layout, a second run, and f64 (where
  the batched pass is also held to the lone fits), by both measures;
- stage by stage, each batched call of the RSVD core against the same call
  on each member alone on the batched call's own input, with the
  small-ridge Cholesky's info a member;
- each batched ``torch.linalg`` call of the core alone, on a
  well-conditioned batch of the stage's shapes.

Not a test: pytest collects nothing here.
"""
import argparse
import sys

import numpy as np
import torch

import bench_torch
from corrla_rs_tpu_torch.models import dmd
from corrla_rs_tpu_torch.ops import random_svd as rs
from corrla_rs_tpu_torch.utils.config import DmdConfig

OS = DmdConfig().n_oversamples


def gap(batched, lone):
    """max over members of max|batched[b] - lone[b]| / max|lone[b]|."""
    worst = 0.0
    for got, want in zip(batched, lone):
        scale = float(want.abs().max()) or 1.0
        worst = max(worst, float((got - want).abs().max()) / scale)
    return worst


def all_six(fit, lone) -> float:
    """The largest ``eig_gap`` over the members, all eigenvalues matched."""
    return max(bench_torch.eig_gap(a, b) for a, b in
               zip(bench_torch._lambdas(fit), bench_torch._lambdas(lone)))


def both(name, x, u, fit, lone):
    held = bench_torch.ensemble_check(x, u, fit, lone)
    print(f"  {name:44s} all six {all_six(fit, lone):.3e}; supported "
          f"{held['eig_err']:.3e}, one-step residual {held['residual']:.3e}"
          f", {held['vs_lone']:.3e} from the lone fits' (k = "
          f"{sorted(set(held['supported']))})", flush=True)


def say(name, batched, lone):
    print(f"  {name:44s} {gap(batched, lone):.3e}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    dev = torch.device(parser.parse_args(argv).device)
    n_mem, nx, nt = bench_torch.sizes(False)["ensemble"]
    x, u = (torch.as_tensor(a, device=dev)
            for a in bench_torch.ensemble_data(n_mem, nx, nt))
    kw = bench_torch.ENSEMBLE_KW
    keys = dmd._split_seed(kw["key"], n_mem, dev)
    k1 = [dmd._split_seed(k, 2, dev)[0] for k in keys]
    a = torch.cat([x, u], dim=-2)[..., :-1]
    fat = a.shape[-2] < a.shape[-1]
    aa = a.mT if fat else a
    sketch, rank = rs._widths(aa, kw["n_modes"], OS)
    print(f"{dev}: input space {tuple(a.shape)}, fat {fat}, sketch {sketch}"
          f", rank {rank}")
    # the whole core, batched against the members fitted alone
    us, ss, vts = rs._random_svd_members(a, kw["n_modes"], kw["n_iters"], OS,
                                         k1)
    k1 = [dmd._split_seed(k, 2, dev)[0] for k in keys]
    lone = [rs.random_svd(a[b], kw["n_modes"], kw["n_iters"], OS, key=k1[b])
            for b in range(n_mem)]
    say("random_svd: U S Vt", (us * ss[..., None, :]) @ vts,
        [(u1 * s1) @ vt1 for u1, s1, vt1 in lone])
    say("random_svd: sigma", ss, [s1 for _, s1, _ in lone])
    # the output space's RSVD and the whole reduction
    k2 = [dmd._split_seed(k, 2, dev)[1] for k in keys]
    y_out = x[..., 1:]
    uh = rs._random_svd_members(y_out, kw["n_modes"], kw["n_iters"], OS,
                                k2)[0]
    k2 = [dmd._split_seed(k, 2, dev)[1] for k in keys]
    say("output space: U^ U^T", uh @ uh.mT,
        [(lambda q: q @ q.mT)(rs.random_svd(y_out[b], kw["n_modes"],
                                            kw["n_iters"], OS,
                                            key=k2[b])[0])
         for b in range(n_mem)])
    fit = dmd.dmdc_fit_ensemble(x, u, **kw)
    singles = bench_torch.lone_fits(x, u)
    lone = bench_torch.stacked(singles)
    say("batched B against the lone fits", fit["b_op"], lone["b_op"])
    both("batched against the lone fits", x, u, fit, lone)
    lam = bench_torch._lambdas(fit)
    for b in range(2):
        print(f"  member {b}: batched {np.sort_complex(lam[b])}\n"
              f"            lone    {np.sort_complex(singles[b].lambdas)}")
    # how far lone fits of the same data move when only the arithmetic
    # changes: the snapshots in column-major layout (other GEMM paths)
    others = bench_torch.stacked(bench_torch.lone_fits(x.mT.contiguous().mT,
                                                       u))
    both("lone fits, column-major data, against lone", x, u, others, lone)
    again = bench_torch.stacked(bench_torch.lone_fits(x, u))
    both("lone fits run again against lone", x, u, again, lone)
    # the same comparison in f64
    x64, u64 = x.double(), u.double()
    fit64 = dmd.dmdc_fit_ensemble(x64, u64, **kw)
    lone64 = bench_torch.stacked(bench_torch.lone_fits(x64, u64))
    both("f64: batched against lone fits", x64, u64, fit64, lone64)
    both("f64 lone fits against f32 lone fits", x, u, lone64, lone)
    # stage by stage, each batched call against per-member calls on the
    # same input
    k1 = [dmd._split_seed(k, 2, dev)[0] for k in keys]
    omega = torch.stack([rs._draw_sketch(k, (aa.shape[-1], sketch), aa.dtype,
                                         dev) for k in k1])
    y = aa @ omega
    say("y = A Omega (bmm)", y, [aa[b] @ omega[b] for b in range(n_mem)])
    for i in range(kw["n_iters"]):
        ys = y / torch.linalg.vector_norm(y, dim=-2, keepdim=True)
        g = ys.mT @ ys + 1e-7 * torch.eye(sketch, device=dev)
        info = torch.linalg.cholesky_ex(g, upper=True).info
        lone_info = [int(torch.linalg.cholesky_ex(g[b], upper=True).info)
                     for b in range(n_mem)]
        print(f"  iteration {i}: first round's small-ridge info, batched "
              f"{info.tolist()}, lone {lone_info}")
        q = rs._cholesky_qr2(y)
        say(f"iteration {i}: _cholesky_qr2", q,
            [rs._cholesky_qr2(y[b]) for b in range(n_mem)])
        z = aa @ (aa.mT @ q)
        say(f"iteration {i}: A (A^T Q)", z,
            [aa[b] @ (aa[b].mT @ q[b]) for b in range(n_mem)])
        y = z / torch.linalg.vector_norm(z, dim=(-2, -1), keepdim=True)
    q = rs._householder_qr(y)
    say("final Householder Q Q^T", q @ q.mT,
        [(lambda qb: qb @ qb.mT)(rs._householder_qr(y[b]))
         for b in range(n_mem)])
    bmat = q.mT @ aa
    u_b, s, vt = torch.linalg.svd(bmat, full_matrices=False)
    lone_svd = [torch.linalg.svd(bmat[b], full_matrices=False)
                for b in range(n_mem)]
    say("svd of Q^T A: sigma", s, [sv[1] for sv in lone_svd])
    say("svd of Q^T A: U S Vt", (u_b * s[..., None, :]) @ vt,
        [(sv[0] * sv[1]) @ sv[2] for sv in lone_svd])
    # each torch.linalg call alone, on a well-conditioned batch
    gen = torch.Generator(device=dev).manual_seed(0)
    k = sketch
    panel = torch.randn(n_mem, aa.shape[-2], k, generator=gen, device=dev)
    gram = panel.mT @ panel + 1e-3 * torch.eye(k, device=dev)
    r_up = torch.linalg.cholesky_ex(gram, upper=True).L
    say("cholesky_ex(upper=True)", r_up,
        [torch.linalg.cholesky_ex(gram[b], upper=True).L
         for b in range(n_mem)])
    say("cholesky_ex(upper=False)", torch.linalg.cholesky_ex(gram).L,
        [torch.linalg.cholesky_ex(gram[b]).L for b in range(n_mem)])
    say("solve_triangular(upper, left=False)",
        torch.linalg.solve_triangular(r_up, panel, upper=True, left=False),
        [torch.linalg.solve_triangular(r_up[b], panel[b], upper=True,
                                       left=False) for b in range(n_mem)])
    qq = torch.linalg.qr(panel).Q
    say("qr: Q Q^T", qq @ qq.mT,
        [(lambda qb: qb @ qb.mT)(torch.linalg.qr(panel[b]).Q)
         for b in range(n_mem)])
    small = torch.randn(n_mem, k, aa.shape[-1], generator=gen, device=dev)
    u2, s2, vt2 = torch.linalg.svd(small, full_matrices=False)
    lone2 = [torch.linalg.svd(small[b], full_matrices=False)
             for b in range(n_mem)]
    say("svd (k x m): sigma", s2, [sv[1] for sv in lone2])
    say("svd (k x m): U S Vt", (u2 * s2[..., None, :]) @ vt2,
        [(sv[0] * sv[1]) @ sv[2] for sv in lone2])
    return 0


if __name__ == "__main__":
    sys.exit(main())
