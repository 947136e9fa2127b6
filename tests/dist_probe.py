"""Which collectives the port's sharded paths need work on CUDA tensors, per
backend: NCCL at world size 1 and gloo with two ranks on the same card
(NCCL refuses two ranks on one device).

Run on a machine with a CUDA card, from the repo root:

    python3 tests/dist_probe.py [--log-dir DIR]

For each backend it spawns the world, runs an all-reduce (on a CUDA and on
a CPU tensor, on the default group), builds the mesh, an all-reduce, an
all-gather
along dim 0 (the one ``parallel.mesh._all_gather`` makes), a DTensor
``full_tensor()``, an uneven all-to-all and a resample's row gather
(``_all_to_all``, ``_take_rows``) and the port's sharded randomized SVD on
the card, and
prints one line each with the outcome; then the torch and CUDA versions and
the card's name and power limit. Each rank logs every step as it starts and
ends to ``DIR/dist_probe_<backend><world>_rank<r>.log`` (default DIR
``build/dist_probe``); a collective that hangs raises after 60 s.
"""
from __future__ import annotations

import argparse
import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import subprocess
import sys
import time
import traceback

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _probe(rank, world, backend, store, log_dir, queue):
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    from corrla_rs_tpu_torch.parallel import mesh as pm
    from corrla_rs_tpu_torch.parallel.sharded_rsvd import sharded_random_svd

    dev = torch.device("cuda", 0)
    out = {}

    log = open(os.path.join(log_dir, f"dist_probe_{backend}{world}"
                            f"_rank{rank}.log"), "w")

    def attempt(name, fn):
        # each step is logged before and after, so a hang shows where
        print(f"{time.time():.1f} {name} ...", file=log, flush=True)
        try:
            out[name] = f"ok {fn()}"
        except Exception as e:      # the probe reports, it does not stop
            out[name] = f"refused: {type(e).__name__}: {str(e)[:160]}"
            traceback.print_exc(file=log)
        print(f"{time.time():.1f} {name}: {out[name]}", file=log, flush=True)

    attempt("all_reduce (no mesh)", lambda: dist.all_reduce(
        torch.ones(4, device=dev)))
    attempt("all_reduce cpu tensor (no mesh)", lambda: dist.all_reduce(
        torch.ones(4)))
    mesh = None

    def make():
        nonlocal mesh
        mesh = pm.make_mesh(device_type="cuda")
        return mesh

    attempt("make_mesh", make)
    attempt("all_reduce", lambda: pm._psum(
        torch.full((4,), rank + 1.0, device=dev), mesh, "rows").tolist())
    attempt("all_gather", lambda: pm._all_gather(
        torch.full((2, 2), float(rank), device=dev), mesh,
        "rows")[:, 0].tolist())
    # the row moves of the member-sharded paths, before full_tensor (which
    # hangs under gloo): an uneven all-to-all (rank r sends r + 1 rows to
    # every rank) and a resample's gather
    attempt("all_to_all", lambda: pm._all_to_all(
        torch.full(((rank + 1) * world, 2), float(rank), device=dev),
        [rank + 1] * world, [r + 1 for r in range(world)], mesh,
        "rows")[:, 0].tolist())
    attempt("take_rows", lambda: pm._take_rows(
        torch.arange(4.0, device=dev)[:, None] + 4 * rank,
        torch.zeros(world, 4, dtype=torch.int64), mesh,
        "rows")[:, 0].tolist())
    attempt("full_tensor", lambda: pm.shard_rows(
        torch.arange(4.0 * world, device=dev).reshape(2 * world, 2),
        mesh).full_tensor().sum().item())
    a = torch.randn(4096, 256, generator=torch.Generator(device=dev)
                    .manual_seed(0), device=dev)
    attempt("sharded_random_svd", lambda: sharded_random_svd(
        a, 8, 4, 8, key=1, mesh=mesh)[1][:3].tolist())
    queue.put((rank, out))
    dist.destroy_process_group()


def _world(backend, n, log_dir):
    """{rank: outcomes}; a rank that gives no answer in 240 s (a collective
    that hangs past its 60 s timeout) is reported, and every rank ends."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    folder = os.path.join("build", "dist_probe")
    os.makedirs(folder, exist_ok=True)
    store = os.path.join(folder, f"store_{backend}{n}")
    if os.path.exists(store):
        os.remove(store)
    procs = [ctx.Process(target=_probe, daemon=True,
                         args=(r, n, backend, store, log_dir, queue))
             for r in range(n)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, out = queue.get(timeout=240)
            results[rank] = out
    except queue_mod.Empty:
        results[-1] = {"world": f"no answer from {n - len(results)} rank(s)"}
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("dist_probe: needs a CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log-dir", default=os.path.join("build",
                                                          "dist_probe"))
    log_dir = parser.parse_args().log_dir
    os.makedirs(log_dir, exist_ok=True)
    for backend, n in (("nccl", 1), ("gloo", 2)):
        for rank, out in sorted(_world(backend, n, log_dir).items()):
            for name, what in out.items():
                print(f"[{backend} world {n} rank {rank}] {name}: {what}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
