"""How close the DMDc ensemble's batched pass and its lone fits come to the
truth on chip_smoke.py's ensemble data, and which batched product loses
the digits.

Run from the repo root (on the CPU at a narrower state, or on a machine
with one NVIDIA GPU):

    PYTHONPATH=. python3 tests/ensemble_accuracy_probe.py [--device cpu]
        [--states 20000]

chip_smoke.py's dmdc phase fits 8 members of its latent system (8 latent
states lifted to ``--states`` states, 1,001 snapshots f32, 10 modes, 10
iterations, key 2). The probe prints, for ``dmdc_fit_ensemble`` (one
batched pass) and for the lone ``DMDc`` fits of the members:

- the largest distance of a member's eigenvalue to the nearest true one
  (the latent operator's), over the members;
- the 'reduced' rollout's error over 1,000 steps, err / max|x|, as the
  phase measures it;

then each RSVD of the reduction, batched and a member at a time, against
the exact f64 SVD of the same f32 data (sigma; the widest principal angle
to the supported subspace); and for each kind of product that contracts
the long state axis, the error of one ``bmm`` over the stack, of one
``mm`` a member and of ``random_svd._mm`` (the stack's contraction summed
in chunks of ``_MEMBER_CHUNK`` rows, and of twice that), each against the
same product in f64, relative to the product's largest entry.

Not a test: pytest collects nothing here.
"""
import argparse
import sys

import numpy as np
import torch

import chip_smoke
from corrla_rs_tpu_torch.models import dmd
from corrla_rs_tpu_torch.ops import random_svd as rs
from corrla_rs_tpu_torch.utils.config import DmdConfig

SEED = 2


def rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


def eig_to_truth(lam, true):
    """Largest distance from a true eigenvalue to the nearest fitted one."""
    return float(np.abs(np.asarray(lam)[None, :] - true[:, None]).min(1)
                 .max())


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--states", type=int, default=20_000)
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    n_b = chip_smoke.SIZES["ensemble"][0]
    n_t, n_modes, n_iters = chip_smoke.SIZES["dmdc"][1:]
    m, _ = chip_smoke.latent_operator(torch.Generator().manual_seed(SEED))
    true = np.linalg.eigvals(m.numpy())
    z, u = chip_smoke.latent_system(n_t, SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xb = chip_smoke.lifted(z, args.states, gen, dev, batch=n_b)
    u = u.float().to(dev)
    ub = u.expand(n_b, -1, -1)
    print(f"{dev}: {n_b} x {args.states} x {n_t} f32, {n_modes} modes, "
          f"{n_iters} iterations")
    fit = dmd.dmdc_fit_ensemble(xb, ub, n_modes, n_iters, key=SEED)
    keys = dmd._split_seed(SEED, n_b, dev)
    lone = [dmd.DMDc(x, ui, n_modes, n_iters, key=k)
            for x, ui, k in zip(xb, ub, keys)]
    lam = (fit["lambdas_re"].double()
           + 1j * fit["lambdas_im"].double()).cpu().numpy()
    steps = n_t - 1
    pred = dmd.rollout_ensemble(fit, xb[:, :, :1], u[:, :steps])
    for name, eig, roll in (
            ("batched", [eig_to_truth(l, true) for l in lam],
             [chip_smoke.traj_err(pred[i], xb[i]) for i in range(n_b)]),
            ("lone", [eig_to_truth(s.lambdas, true) for s in lone],
             [chip_smoke.traj_err(s.predict_multiple(
                 xb[i][:, :1], u[:, :steps], "reduced"), xb[i])
              for i, s in enumerate(lone)])):
        print(f"  {name:8s} eigenvalues to the truth {max(eig):.3e}, "
              f"reduced rollout err / max|x| {max(roll):.3e}")
    # the two RSVDs of the reduction, batched and a member at a time,
    # against the exact f64 SVD of the same f32 data
    omega = torch.cat([xb, ub], dim=-2)[..., :-1]            # (B, n, m)
    os_ = DmdConfig().n_oversamples
    for name, a, which in (("input space", omega, 0),
                           ("output space", xb[..., 1:], 1)):
        q64, r64 = torch.linalg.qr(a.double())
        w64, s64, _ = torch.linalg.svd(r64)
        u64 = (q64 @ w64)[..., :n_modes]
        s64 = s64[..., :n_modes]

        def child(k):
            return dmd._split_seed(k, 2, dev)[which]

        ub_, sb, _ = rs._random_svd_members(
            a, n_modes, n_iters, os_,
            [child(k) for k in dmd._split_seed(SEED, n_b, dev)])
        lone_u, lone_s = zip(*(rs.random_svd(
            a[i], n_modes, n_iters, os_, key=child(k))[:2]
            for i, k in enumerate(dmd._split_seed(SEED, n_b, dev))))
        for label, uu, ss in (("batched", ub_, sb),
                              ("lone", torch.stack(lone_u),
                               torch.stack(lone_s))):
            k = min(8 if which else 10, n_modes)
            cos = torch.linalg.svdvals(u64[..., :k].mT @ uu.double())
            sin = (1 - cos.min(-1).values.clamp(max=1) ** 2).clamp_min(0)
            print(f"  {name} RSVD, {label:8s} sigma "
                  f"{float(((ss.double() - s64).abs() / s64[..., :1]).max()):.2e}"
                  f", sin of the widest angle to the leading {k} "
                  f"{float(sin.sqrt().max()):.2e}")
    # the long contractions of the reduction, on the batch's own operands
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.linalg.qr(torch.randn(omega.shape[:-1] + (22,),
                                    generator=gen, device=dev)).Q
    cases = {
        "Q^T Q (Gram, k x n x k)": (q.mT, q),
        "A^T Q (m x n x k)": (omega.mT, q),
        "Q^T A (k x n x m)": (q.mT, omega),
    }
    for name, (a, b) in cases.items():
        want = a.double() @ b.double()
        got = {"bmm": a @ b,
               "mm a member": torch.stack([a[i] @ b[i]
                                           for i in range(n_b)]),
               f"_mm ({rs._MEMBER_CHUNK})": rs._mm(a, b)}
        chunk = rs._MEMBER_CHUNK
        try:
            rs._MEMBER_CHUNK = 2 * chunk
            got[f"_mm ({2 * chunk})"] = rs._mm(a, b)
        finally:
            rs._MEMBER_CHUNK = chunk
        print(f"  {name:26s} " + ", ".join(
            f"{k} {rel(v, want):.2e}" for k, v in got.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
