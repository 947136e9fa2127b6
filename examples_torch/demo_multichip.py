"""Multi-device workflows on a device mesh, on the port: the workload of
``examples/demo_multichip.py``.

The JAX script is one controller over a faked 8-device CPU mesh. The port
is SPMD on ``torch.distributed``: this script starts ``--world`` ranks
(``torch.multiprocessing``, spawned), each joins the process group through
``parallel.mesh.init_distributed`` and builds its mesh with ``make_mesh``,
and every rank makes the same calls on the same data, keeping its own rows.
The default is NCCL over every card of the machine; ``--backend gloo``
runs several ranks on one card, and ``--device cpu`` (gloo) is for the
tests. A world larger than NCCL can place (one rank a card) is refused,
never shrunk.

Demonstrates every sharded path in the library:
  1. row-sharded randomized SVD (psum Gram + distributed TSQR)
  2. PCA / POD / DMDc fits with ``mesh=`` (POD's fit launches the kernel
     matrix, its predict the matvec)
  3. chain-sharded DEMC and DREAM (per-generation head all_gather)
  4. sample-sharded active subspaces (the kNN launches the kernel matrix)
  5. data-parallel stats: pearson_corr on a row-sharded DTensor

Run:  python examples_torch/demo_multichip.py [--world N]
      [--backend nccl|gloo] [--device cpu]
"""
from __future__ import annotations

import datetime
import os
import sys
import tempfile
import traceback

import numpy as np
import torch

import _harness as h


def rank_main(rank, world, backend, device_type, store, queue,
              check_kernels):
    """One rank: the whole demo on this rank's share; rank 0 prints. Puts
    (rank, "ok", result) or (rank, "error", traceback) on ``queue``."""
    try:
        if check_kernels:
            h.check_kernels()
        import torch.distributed as dist

        from corrla_rs_tpu_torch import DMDc, PcaRsvd, PodI
        from corrla_rs_tpu_torch.models.active_subspaces import (
            ActiveSsRsvd,
            PolyGradientEstimator,
        )
        from corrla_rs_tpu_torch.ops.samplers import (
            ln_like_sum,
            ln_prior_uniform,
        )
        from corrla_rs_tpu_torch.ops.stats_corr import pearson_corr
        from corrla_rs_tpu_torch.parallel import mesh as pm
        from corrla_rs_tpu_torch.parallel.sharded_rsvd import (
            sharded_random_svd,
        )
        from corrla_rs_tpu_torch.parallel.sharded_samplers import (
            demc_run_sharded,
            dream_run_sharded,
        )
        from corrla_rs_tpu_torch.utils.device import set_default_device

        if device_type == "cpu":
            torch.set_num_threads(1)
        pm.init_distributed(
            backend=backend, device_type=device_type, rank=rank,
            world_size=world, store=dist.FileStore(store, world),
            timeout=datetime.timedelta(seconds=300))
        dev = (torch.device("cuda", torch.cuda.current_device())
               if device_type == "cuda" else torch.device("cpu"))
        set_default_device(dev)

        def say(line):
            if rank == 0:
                print(line, flush=True)

        rng = np.random.default_rng(0)
        mesh = pm.make_mesh(world, device_type=device_type)
        say(f"mesh: {tuple(mesh.shape)} over {backend} "
            f"({device_type}, {world} rank(s))")

        # 1) row-sharded RSVD — the tall sample axis lives across ranks
        a = torch.as_tensor(rng.standard_normal((4000, 64)),
                            dtype=torch.float32, device=dev)
        u, s, vt = sharded_random_svd(a, 8, 8, 8, key=0, mesh=mesh)
        say(f"sharded rsvd: U row-sharded as {list(u.placements)}, "
            f"s[0]={float(s[0]):.3f}")

        # 2) models take mesh= directly
        pca = PcaRsvd(a, 4, mesh=mesh)
        ev = h.host(pca.explained_var())
        say(f"sharded PCA:  explained var {ev.round(2)}")

        nx, ns = 800, 16
        xg = np.linspace(0, 10, nx)
        tg = np.linspace(1, 9, ns)[:, None]
        snaps = torch.as_tensor(
            (0.5 * tg) * np.exp(-((xg[None, :] - tg) ** 2) / 4.0),
            dtype=torch.float32, device=dev)
        pod = PodI(snaps, torch.as_tensor(tg, dtype=torch.float32,
                                          device=dev), 4, mesh=mesh)
        field = pm._full(pod.predict(torch.tensor([[5.0]],
                                                  dtype=torch.float32,
                                                  device=dev)))
        say(f"sharded POD:  predict(5.0) -> field of {tuple(field.shape)}")

        tp = np.linspace(0, 10, 30)
        useq = np.exp(0.2 * tp)[None, :].astype(np.float32)
        dm_snaps = (np.sin(np.linspace(0, 10, 160)[:, None]
                           + 0.2 * tp[None, :]) * useq).astype(np.float32)
        dmd = DMDc(torch.as_tensor(dm_snaps, device=dev),
                   torch.as_tensor(useq, device=dev), 8, 20, mesh=mesh)
        lam_max = float(np.abs(h.host(dmd.lambdas)).max())
        say(f"sharded DMDc: dominant |lambda| = {lam_max:.4f}")

        # 3) chain-sharded MCMC — heads all_gather per generation over
        # "chains"
        cmesh = pm.make_mesh(world, axis_name=pm.CHAINS_AXIS,
                             device_type=device_type)
        lnp = ln_like_sum(
            lambda x: -0.5 * torch.sum(((x - 2.0) / 3.0) ** 2),
            ln_prior_uniform(np.array([[-20.0, 20.0]])),
        )
        heads0 = torch.zeros((64, 1), dtype=torch.float32, device=dev)
        hist, heads, ar = demc_run_sharded(heads0, lnp, 500, gamma=0.8,
                                           var_epsilon=1e-10, key=0,
                                           mesh=cmesh)
        demc_mean = float(torch.mean(pm._full(hist)[-200:]))
        say(f"sharded DEMC:  64 chains x 500 gens, accept {ar:.2f}, "
            f"mean {demc_mean:.2f}")
        spread = torch.linspace(-1, 1, 64, device=dev)[:, None]
        hist_d, _, ar_d = dream_run_sharded(heads0 + spread, lnp, 500, key=1,
                                            n_adapt=200, mesh=cmesh)
        dream_mean = float(torch.mean(pm._full(hist_d)[-200:]))
        say(f"sharded DREAM: accept {ar_d:.2f}, mean {dream_mean:.2f}")

        # 4) sample-sharded active subspaces
        x = rng.uniform(-1, 1, (320, 3))
        y = 0.1 * x[:, 0] + 5.0 * x[:, 1] + 0.3 * x[:, 2] + 2.0 * x[:, 1] ** 2
        xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
        ge = PolyGradientEstimator(
            xt, torch.as_tensor(y, dtype=torch.float32, device=dev), 2, 16)
        fitted = ActiveSsRsvd(ge, 2).fit(xt, mesh=mesh)
        dominant = int(np.abs(h.host(pm._full(fitted.components))[:, 0])
                       .argmax())
        say(f"sharded active-ss: dominant dir {dominant} (want 1)")

        # 5) data-parallel stats on row-sharded data
        x_sh = pm.shard_rows(torch.as_tensor(rng.standard_normal((8000, 6)),
                                             dtype=torch.float32,
                                             device=dev), mesh)
        corr = h.host(pm._full(pearson_corr(x_sh)))
        diag = np.diagonal(corr)
        say(f"pearson on row-sharded data: diag = {diag.round(6)}")

        ok = (dominant == 1 and np.allclose(diag, 1.0, atol=1e-6)
              and np.isfinite([lam_max, demc_mean, dream_mean]).all())
        result = {"ok": bool(ok), "launches": h.launches(),
                  "checks": h.CHECKS,
                  "metrics": {"s0": float(s[0]), "dmdc_lambda_max": lam_max,
                               "demc_accept": float(ar),
                               "dream_accept": float(ar_d),
                               "active_ss_dominant": dominant}}
        dist.destroy_process_group()
        queue.put((rank, "ok", result))
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
        raise


def main(argv=None):
    ap = h.parser(__doc__)
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: every card for NCCL; 2 on the CPU)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default nccl on cuda, gloo on the CPU")
    args = ap.parse_args(argv)
    dev = h.start(args, "demo_multichip")
    device_type = dev.type
    backend = args.backend or ("nccl" if device_type == "cuda" else "gloo")
    if backend == "nccl" and device_type != "cuda":
        print("demo_multichip: NCCL needs --device cuda", file=sys.stderr)
        raise SystemExit(2)
    n_cards = torch.cuda.device_count() if device_type == "cuda" else 0
    world = args.world or (n_cards if device_type == "cuda" else 2)
    if backend == "nccl" and world > n_cards:
        print(f"demo_multichip: a world of {world} NCCL ranks needs {world} "
              f"cards, this machine has {n_cards}; pass --world or "
              "--backend gloo", file=sys.stderr)
        raise SystemExit(2)

    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as folder:
        store = os.path.join(folder, "store")
        procs = [ctx.Process(target=rank_main, daemon=True, args=(
            r, world, backend, device_type, store, results,
            args.check_kernels))
            for r in range(world)]
        for p in procs:
            p.start()
        got, errors = {}, []
        try:
            while len(got) + len(errors) < world:
                try:
                    rank, status, payload = results.get(timeout=600)
                except queue_mod.Empty:
                    errors.append("no answer from a rank in 600 s")
                    break
                if status == "ok":
                    got[rank] = payload
                else:
                    errors.append(f"rank {rank}:\n{payload}")
            for p in procs:
                p.join(60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
    if errors:
        print("\n".join(errors), file=sys.stderr)
        raise SystemExit(1)
    counts = {k: sum(r["launches"][k] for r in got.values())
              for k in got[0]["launches"]}
    ok = all(r["ok"] for r in got.values())
    print("multichip demo OK" if ok else "multichip demo FAILED")
    metrics = got[0]["metrics"]
    h.finish("demo_multichip", dev, ok,
             f"{backend} world of {world}: " + ", ".join(
                 f"{k} {v:.4g}" for k, v in metrics.items()),
             metrics, counts=counts,
             checks=h.merge_checks(*(r["checks"] for r in got.values())),
             backend=backend, world=world)
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
