"""Spawned gloo worlds for the port's multi-device tests.

``World(n, tmpdir)`` starts n processes (the spawn start method, so the
test process keeps no process group), each with a gloo process group over
a ``FileStore`` under ``tmpdir`` (no TCP port: several pytest workers start
worlds at once), one torch thread and the port's default device set to the
CPU (``backend``/``device`` give other worlds, such as NCCL on the card).
``world.run(case, *args)`` sends every rank the name of a case of this
module and its (picklable) arguments, runs it on every rank, and returns
the ranks' results in rank order; a rank that raises fails the call with
its traceback.

This module imports only torch and the port: the JAX side of a test is
computed in the test process and handed in as numpy arrays, its random
draws included (``_inject`` puts them behind the port's seams).
"""
from __future__ import annotations

import datetime
import os
import traceback

import numpy as np
import torch

_TIMEOUT_S = 240


class World:
    def __init__(self, n: int, tmpdir: str, backend: str = "gloo",
                 device: str = "cpu"):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.n = n
        self.conns, self.procs = [], []
        store = os.path.join(tmpdir, "store")
        for rank in range(n):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_serve, daemon=True,
                               args=(rank, n, store, child, backend, device))
            proc.start()
            child.close()
            self.conns.append(parent)
            self.procs.append(proc)

    def run(self, case: str, *args):
        for conn in self.conns:
            conn.send((case, args))
        results, errors = [], []
        for rank, conn in enumerate(self.conns):
            if not conn.poll(_TIMEOUT_S):
                self.close()
                raise TimeoutError(f"rank {rank} gave no answer to {case} in "
                                   f"{_TIMEOUT_S} s")
            ok, value = conn.recv()
            results.append(value)
            if not ok:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise AssertionError("\n".join(errors))
        return results

    def close(self):
        for conn in self.conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for proc in self.procs:
            proc.join(10)
            if proc.is_alive():
                proc.terminate()


def _serve(rank: int, n: int, store: str, conn, backend: str,
           device: str) -> None:
    import torch.distributed as dist

    from corrla_rs_tpu_torch.parallel.mesh import init_distributed
    from corrla_rs_tpu_torch.utils.device import set_default_device

    torch.set_num_threads(1)
    set_default_device(device)
    _DEVICE[0] = device
    # on CUDA every rank works on the card of its rank (one card: card 0)
    init_distributed(
        backend=backend, device_type=device, store=dist.FileStore(store, n),
        rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=_TIMEOUT_S // 2))
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            case, args = msg
            try:
                conn.send((True, CASES[case](*args)))
            except Exception:
                conn.send((False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# helpers of the cases


# the device type of this rank's world
_DEVICE = ["cpu"]


def _mesh(n=None, axis="rows"):
    from corrla_rs_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n, axis_name=axis, device_type=_DEVICE[0])


def _np(x):
    """numpy of a tensor, a DTensor (gathered: every rank calls) or a
    nested tuple/list/dict of them."""
    from corrla_rs_tpu_torch.parallel.mesh import _full

    x = _full(x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x


class _inject:
    """Patch ``module.name`` with ``value`` inside a ``with`` block."""

    def __init__(self, *patches):
        self.patches = patches

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.patches]
        for m, n, v in self.patches:
            setattr(m, n, v)

    def __exit__(self, *exc):
        for m, n, v in self.saved:
            setattr(m, n, v)


def _sketches(table):
    """``_draw_sketch`` and ``_split_seed`` seams that hand out the JAX
    draws of ``table`` ({seed, placeholder or (seed, shape): array});
    ``_split_seed(key, n)`` returns the placeholders ``f"{key}/{i}"``."""
    from corrla_rs_tpu_torch.models import dmd
    from corrla_rs_tpu_torch.ops import random_svd

    def draw(seed, shape, dtype, device):
        arr = table.get((seed, tuple(shape)))
        arr = table[seed] if arr is None else arr
        assert tuple(arr.shape) == tuple(shape), (seed, arr.shape, shape)
        return torch.as_tensor(arr, dtype=dtype, device=device)

    def split(seed, n, device="cpu"):
        return [f"{seed}/{i}" for i in range(int(n))]

    return _inject((random_svd, "_draw_sketch", draw),
                   (random_svd, "_split_seed", split),
                   (dmd, "_split_seed", split))


def _table_seam(table):
    """A chunked draw seam popping successive generations of ``table`` (a
    tuple of arrays with a leading generation axis)."""
    pos = [0]

    def draw(gen, n_gen, *args, **kwargs):
        lo, hi = pos[0], pos[0] + n_gen
        pos[0] = hi
        return tuple(torch.as_tensor(t[lo:hi]) for t in table)

    return draw


# ---------------------------------------------------------------------------
# the cases: each runs on every rank


def case_mesh(n):
    from corrla_rs_tpu_torch.parallel import mesh as pm
    from corrla_rs_tpu_torch.utils.config import MeshConfig

    mesh = _mesh(n)
    a = torch.arange(2 * n * 4, dtype=torch.float64).reshape(2 * n, 4)
    sh = pm.shard_rows(a, mesh)
    out = {"size": mesh.size(), "names": mesh.mesh_dim_names,
           "placements_ok": tuple(sh.placements) == pm.row_sharding(mesh),
           "local_rows": sh.to_local().shape[0],
           "full_ok": bool(torch.equal(sh.full_tensor(), a)),
           "replicated": [str(p) for p in pm.replicated_sharding(mesh)]}
    m2 = pm.make_mesh_2d(MeshConfig(rows=n // 2, chains=2),
                         device_type="cpu")
    out["mesh2d"] = (tuple(m2.mesh.shape), m2.mesh_dim_names)
    # more ranks than the world: the mesh over all of them (JAX: devs[:n])
    out["over"] = pm.make_mesh(n + 1, device_type="cpu").size()
    errors = []
    for fn in (lambda: pm.make_mesh_2d(rows=n, chains=2, device_type="cpu"),
               lambda: pm.shard_rows(torch.ones(2 * n + 1, 2), mesh)):
        try:
            fn()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


def case_rsvd(a, omega_rank, n_iter, n_oversamples, table, stabilize):
    from corrla_rs_tpu_torch.ops.random_svd import random_svd
    from corrla_rs_tpu_torch.parallel.sharded_rsvd import sharded_random_svd

    mesh = _mesh()
    with _sketches(table):
        u, s, vt = sharded_random_svd(a, omega_rank, n_iter, n_oversamples,
                                      key=0, mesh=mesh)
        local = tuple(u.to_local().shape)
        placements = [str(p) for p in u.placements]
        single = random_svd(torch.as_tensor(a, device=_DEVICE[0]),
                            omega_rank, n_iter,
                            n_oversamples, key=0, stabilize=stabilize)
    return {"usv": _np((u, s, vt)), "local": local,
            "placements": placements, "single": _np(single)}


def case_rsvd_dtensor(a, table):
    """A DTensor input (each rank holds only its rows) gives the same."""
    from corrla_rs_tpu_torch.parallel.mesh import _dtensor, _rows_of
    from corrla_rs_tpu_torch.parallel.sharded_rsvd import sharded_random_svd

    mesh = _mesh()
    a = torch.as_tensor(a)
    dt = _dtensor(_rows_of(a, mesh, "rows", 0).clone(), mesh, "rows", 0,
                  a.shape)
    with _sketches(table):
        return _np(sharded_random_svd(dt, 5, 10, 8, key=0, mesh=mesh))


def case_rsvd_2d(a, table):
    """Rows sharded over a 2 x 2 mesh's "rows" axis, replicated over its
    "chains" axis: the same result as the 1-D mesh of the rows."""
    from corrla_rs_tpu_torch.parallel.mesh import make_mesh_2d
    from corrla_rs_tpu_torch.parallel.sharded_rsvd import sharded_random_svd

    mesh = make_mesh_2d(rows=2, chains=2, device_type=_DEVICE[0])
    with _sketches(table):
        u, s, vt = sharded_random_svd(a, 5, 10, 8, key=0, mesh=mesh,
                                      axis_name="rows")
    return {"usv": _np((u, s, vt)), "local": tuple(u.to_local().shape),
            "placements": [str(p) for p in u.placements]}


def case_rsvd_validates():
    from corrla_rs_tpu_torch.parallel.sharded_rsvd import sharded_random_svd

    mesh = _mesh()
    n = mesh.size()
    out = []
    for shape in ((10, 20), (4 * n + 1, 4)):
        try:
            sharded_random_svd(torch.ones(shape), 2, 4, 4, mesh=mesh)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def case_power_iter_qr(a, omega):
    """The exported range finder on each rank's own rows."""
    from corrla_rs_tpu_torch.parallel.mesh import _all_gather, _rows_of
    from corrla_rs_tpu_torch.parallel.sharded_rsvd import \
        sharded_power_iter_qr

    mesh = _mesh()
    a_l = _rows_of(torch.as_tensor(a), mesh, "rows", 0)
    q_l = sharded_power_iter_qr(a_l, torch.as_tensor(omega), 6, "always",
                                "rows", mesh)
    return _np(_all_gather(q_l, mesh, "rows"))


def case_pca(x, rank, table):
    from corrla_rs_tpu_torch.models.pca import PcaRsvd

    mesh = _mesh()
    with _sketches(table):
        p = PcaRsvd(x, rank, mesh=mesh)
    xq = torch.as_tensor(x[:7])
    return _np({"s": p.singular_values, "comps": p.components,
                "means": p.means, "ev": p.explained_var(),
                "tr": p.apply_tr(xq)})


def case_pod(p, t, n_modes, table, tq):
    from corrla_rs_tpu_torch.models.pod import PodI

    from corrla_rs_tpu_torch.ops import rbf_kernels as rk

    mesh = _mesh()
    before = (rk.pairwise_kernel_matrix.launches, rk.rbf_matvec.launches)
    with _sketches(table):
        pod = PodI(p, t, n_modes, mesh=mesh)
    y = pod.predict(tq)
    launches = (rk.pairwise_kernel_matrix.launches - before[0],
                rk.rbf_matvec.launches - before[1])
    return _np({"pred": y, "modes": pod.modes, "weights": pod.mode_weights,
                "modes_local": tuple(pod.modes.to_local().shape),
                "pred_placements": [str(q) for q in y.placements],
                "launches": launches})


def case_active_ss(x, y, table, boot_idx):
    from corrla_rs_tpu_torch.models import active_subspaces as asm

    mesh = _mesh()
    ge = asm.PolyGradientEstimator(x, y, 2, 16)
    est = asm.ActiveSsRsvd(ge, 2)
    f = est.fit(x, mesh=mesh)
    with _sketches(table):
        fs = est.fit_svd(x, key=2, mesh=mesh)
    with _inject((asm, "_bootstrap_indices",
                  lambda key, n_boot, n, device: torch.as_tensor(boot_idx))):
        boot = est.fit_bootstrap(x, n_boot=boot_idx.shape[0], key=1,
                                 mesh=mesh)
    try:
        est.fit(x[:x.shape[0] - 1], mesh=mesh)
        err = None
    except ValueError as e:
        err = str(e)
    return _np({"vals": f.singular_vals, "comps": f.components,
                "sensi": f.var_diag_evd_sensi(),
                "svd_vals": fs.singular_vals_, "svd_comps": fs.components_,
                "boot": boot, "error": err})


def case_dmdc(snaps, u, n_modes, n_iters, table, mid):
    from corrla_rs_tpu_torch.models.dmd import DMDc

    mesh = _mesh()
    with _sketches(table):
        m = DMDc(snaps, u, n_modes, n_iters, key=3, mesh=mesh)
    v, w = snaps[:, mid:mid + 1], u[:, mid:mid + 1]
    x0 = snaps[:, 0:1]
    out = {"lambdas": m.lambdas, "one": m.predict(v, w),
           "b": m.est_b_til(), "a": m.est_a_til()}
    for method in ("dense", "modes", "reduced"):
        out[method] = m.predict_multiple(x0, u, method=method)
    # a state given as a DTensor steps the same
    from corrla_rs_tpu_torch.parallel.mesh import shard_rows

    out["reduced_dt"] = m.predict_multiple(
        shard_rows(torch.as_tensor(x0), mesh), u, method="reduced")
    out["placements"] = [str(p) for p in m.modes_re.placements]
    return _np(out)


def case_dmdc_rejects(snaps, u):
    from corrla_rs_tpu_torch.models.dmd import DMDc

    try:
        DMDc(snaps, u, 4, 8, mesh=_mesh())
    except ValueError as e:
        return str(e)
    return None


def case_hosvd(t, ranks, table):
    from corrla_rs_tpu_torch.ops.hosvd import tucker_reconstruct
    from corrla_rs_tpu_torch.parallel.sharded_hosvd import sharded_hosvd

    with _sketches(table):
        core, factors = sharded_hosvd(t, ranks, mesh=_mesh())
    local = tuple(factors[0].to_local().shape)
    from corrla_rs_tpu_torch.parallel.mesh import _full

    factors = [_full(f) for f in factors]
    return _np({"core": core, "factors": factors, "local": local,
                "rec": tucker_reconstruct(core, factors)})


def case_hosvd_validates(cases):
    from corrla_rs_tpu_torch.parallel.sharded_hosvd import sharded_hosvd

    out = []
    for shape, ranks in cases:
        try:
            sharded_hosvd(np.ones(shape), ranks, mesh=_mesh())
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def _gauss_1d(mu, std):
    def lnp(x):
        return -0.5 * ((x[0] - mu) / std) ** 2 - np.log(std)
    return lnp


def case_demc(heads0, n_steps, draws, n_mesh):
    """DEMC with the JAX package's sharded draws fed to the seam."""
    from corrla_rs_tpu_torch.ops import samplers
    from corrla_rs_tpu_torch.parallel.sharded_samplers import \
        demc_run_sharded

    lnp = samplers.ln_like_sum(
        _gauss_1d(2.0, 3.0), samplers.ln_prior_uniform(np.array([[-20.0,
                                                                  20.0]])))
    with _inject((samplers, "_draw_demc", _table_seam(draws))):
        hist, heads, ar = demc_run_sharded(
            heads0, lnp, n_steps, gamma=0.8, var_epsilon=1e-10, key=0,
            mesh=_mesh(n_mesh, "chains"))
    return _np({"hist": hist, "heads": heads, "ar": ar,
                "placements": [str(p) for p in hist.placements]})


def case_demc_same_draws(heads0, n_steps, seed):
    """The sharded run against the single-device run on the same torch
    draws (each rank draws the whole table from the same seed)."""
    from corrla_rs_tpu_torch.ops import samplers
    from corrla_rs_tpu_torch.parallel.sharded_samplers import \
        demc_run_sharded

    lnp = _gauss_1d(0.5, 1.5)
    hist, heads, ar = demc_run_sharded(heads0, lnp, n_steps, 0.8, 1e-10,
                                       key=seed, mesh=_mesh(None, "chains"))
    h1, st = samplers.demc_run(torch.as_tensor(heads0), lnp, n_steps, 0.8,
                               1e-10, seed)
    return _np({"hist": hist, "single": h1, "ar": ar,
                "ar_single": int(st.n_accept) / (n_steps * heads0.shape[0])})


def case_dream(heads0, n_steps, seed, n_adapt):
    from corrla_rs_tpu_torch.ops.dream import dream_run
    from corrla_rs_tpu_torch.parallel.sharded_samplers import \
        dream_run_sharded

    lnp = _gauss_1d(2.0, 3.0)
    hist, heads, ar = dream_run_sharded(heads0, lnp, n_steps, key=seed,
                                        n_adapt=n_adapt,
                                        mesh=_mesh(None, "chains"))
    h1, st = dream_run(torch.as_tensor(heads0), lnp, n_steps, key=seed,
                       n_adapt=n_adapt)
    return _np({"hist": hist, "single": h1, "ar": ar,
                "ar_single": int(st.n_accept) / (n_steps * heads0.shape[0]),
                "errors": _dream_errors()})


def _dream_errors():
    from corrla_rs_tpu_torch.parallel.sharded_samplers import \
        dream_run_sharded

    try:
        dream_run_sharded(np.zeros((9, 1)), _gauss_1d(0.0, 1.0), 2,
                          mesh=_mesh(None, "chains"))
    except ValueError as e:
        return str(e)
    return None


def _iso(x):
    return -0.5 * torch.sum(x ** 2)


def _skew(y):
    return -0.5 * torch.sum((y * torch.tensor([0.25, 2.0],
                                              dtype=y.dtype)) ** 2)


def case_stretch(w0, n_steps, draws):
    """The stretch move with the JAX package's sharded draws, its exact
    affine equivariance, and the divisibility error."""
    from corrla_rs_tpu_torch.ops import ensemble_mcmc
    from corrla_rs_tpu_torch.parallel.sharded_samplers import \
        stretch_run_sharded

    mesh = _mesh(None, "chains")
    scale = np.array([4.0, 0.5])
    runs = {}
    for name, w, lnp in (("iso", w0, _iso), ("skew", w0 * scale, _skew)):
        with _inject((ensemble_mcmc, "_draw_stretch", _table_seam(draws))):
            runs[name] = stretch_run_sharded(w, lnp, n_steps, key=2,
                                             mesh=mesh)
    try:
        stretch_run_sharded(np.zeros((6, 2)), _iso, 3, mesh=mesh)
        err = None
    except ValueError as e:
        err = str(e)
    return _np({"iso": runs["iso"], "skew": runs["skew"], "error": err})


def case_stretch_same_draws(w0, n_steps, seed):
    from corrla_rs_tpu_torch.ops.ensemble_mcmc import stretch_run
    from corrla_rs_tpu_torch.parallel.sharded_samplers import \
        stretch_run_sharded

    hist, heads, ar = stretch_run_sharded(w0, _iso, n_steps, key=seed,
                                          mesh=_mesh(None, "chains"))
    h1, st = stretch_run(torch.as_tensor(w0), _iso, n_steps, key=seed)
    return _np({"hist": hist, "heads": heads, "single": h1, "ar": ar,
                "ar_single": int(st.n_accept) / (n_steps * w0.shape[0])})


def case_checkpoint(path_prefix, x, p, t, snaps, u, table):
    """Sharded PcaRsvd, PodI and DMDc saved by every rank (the first rank
    writes); the test process loads the files single-device."""
    import torch.distributed as dist

    from corrla_rs_tpu_torch.models.dmd import DMDc
    from corrla_rs_tpu_torch.models.pca import PcaRsvd
    from corrla_rs_tpu_torch.models.pod import PodI
    from corrla_rs_tpu_torch.utils.checkpoint import save_model
    from corrla_rs_tpu_torch.utils.convert import from_jax_state

    mesh = _mesh()
    with _sketches(table):
        models = {"pca": PcaRsvd(x, 3, mesh=mesh),
                  "pod": PodI(p, t, 3, mesh=mesh),
                  "dmdc": DMDc(snaps, u, 4, 10, key=3, mesh=mesh)}
    for name, model in models.items():
        save_model(f"{path_prefix}_{name}.npz", model)
    dist.barrier()
    # convert's from_jax_state takes the sharded attributes too
    pod = from_jax_state("PodI", vars(models["pod"]), "cpu")
    return _np({"pca_tr": models["pca"].apply_tr(torch.as_tensor(x[:5])),
                "pod_pred": models["pod"].predict(torch.as_tensor(t[:3])),
                "pod_conv_pred": pod.predict(torch.as_tensor(t[:3])),
                "pod_conv_mesh": pod._mesh,
                "dmdc_roll": models["dmdc"].predict_multiple(
                    snaps[:, :1], u[:, :6], method="modes"),
                "wrote": os.path.exists(f"{path_prefix}_pca.npz")})


# ---------------------------------------------------------------------------
# row-sharded data (tests/test_torch_parallel_rows.py)


def _same_on_ranks(x):
    """A digest of a (nested) result that the test compares across ranks:
    the bytes of every tensor, so equal means bitwise equal."""
    import hashlib

    h = hashlib.sha256()

    def add(v):
        if isinstance(v, torch.Tensor):
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
        elif isinstance(v, (tuple, list)):
            for w in v:
                add(w)
        elif isinstance(v, dict):
            for k in sorted(v):
                add(v[k])
        else:
            h.update(repr(v).encode())

    add(x)
    return h.hexdigest()


def _replicated(out, *names):
    """``out`` with "digest": the digest of its entries ``names`` (taken
    before any gathering, so they are each rank's own tensors)."""
    out["digest"] = _same_on_ranks([out[k] for k in names])
    return out


def _shard(a):
    from corrla_rs_tpu_torch.parallel.mesh import shard_rows

    return shard_rows(torch.as_tensor(a), _mesh())


def case_mesh_faults():
    """The mesh helpers' three faults, each now an answer."""
    from corrla_rs_tpu_torch.parallel import mesh as pm

    mesh = _mesh()
    out = {"big": pm.make_mesh(9, device_type=_DEVICE[0]).size()}
    for name, fn in (("row_sharding", lambda: pm.row_sharding(mesh,
                                                              "bogus")),
                     ("axis", lambda: pm._axis(mesh, "bogus"))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def case_stats_rows(x):
    from torch.distributed.tensor import DTensor, Replicate

    from corrla_rs_tpu_torch.ops.stats_corr import mat_cov_centered, \
        pearson_corr

    dt = _shard(x)
    out = _replicated({"pearson": pearson_corr(dt),
                       "cov": mat_cov_centered(dt)}, "pearson", "cov")
    rep = DTensor.from_local(torch.as_tensor(x), _mesh(), (Replicate(),))
    try:
        pearson_corr(rep)
        out["error"] = None
    except ValueError as e:
        out["error"] = str(e)
    return _np(out)


def case_nll_rows(x, kde_support):
    from corrla_rs_tpu_torch.ops.univariate_rv import BetaRv, ExponentialRv, \
        KdeRv, NormalRv

    dt = _shard(x)
    xt = torch.as_tensor(x)
    rvs = {"normal": NormalRv(2.0, 3.0), "exponential": ExponentialRv(0.5),
           "beta": BetaRv(2.0, 3.0, -20.0, 20.0),
           "kde": KdeRv(0.7, kde_support)}
    # the exponential's support is x >= 0
    data = {name: (np.abs(x) if name == "exponential" else x)
            for name in rvs}
    out = {name: rv.nll(_shard(data[name])) for name, rv in rvs.items()}
    out["single"] = {name: rv.nll(torch.as_tensor(data[name]))
                     for name, rv in rvs.items()}
    # the gradient through the psum is the single-device one
    p = torch.tensor([2.5, 2.0], dtype=torch.float64)
    out["grad"] = torch.func.grad(lambda q: rvs["normal"].nll(dt, q))(p)
    out["grad_single"] = torch.func.grad(
        lambda q: rvs["normal"].nll(xt, q))(p)
    return _np(_replicated(out, "normal", "kde", "grad"))


def case_single_pass_rows(a, table):
    from corrla_rs_tpu_torch.ops.random_svd import single_pass_svd

    with _sketches(table):
        u, s, vt = single_pass_svd(_shard(a), 9, 8, key=5)
        single = single_pass_svd(torch.as_tensor(a), 9, 8, key=5)
    out = {"s": s, "vt": vt, "u": u, "single": single,
           "placements": [str(p) for p in u.placements],
           "local": tuple(u.to_local().shape)}
    return _np(_replicated(out, "s", "vt"))


def _inducing_seam(idx):
    from corrla_rs_tpu_torch.ops import gp

    return _inject((gp, "_draw_inducing",
                    lambda key, n, m, device: torch.as_tensor(
                        idx, device=device)))


def case_sparse_gp_rows(x, y, xq, idx, fixed):
    """The sharded fit (hyperparameters optimized, and at ``fixed`` ones)
    against the single-device fit, its predictions and its ELBO's gradient
    at a few log-parameters."""
    from corrla_rs_tpu_torch.ops import gp
    from corrla_rs_tpu_torch.ops.interp import pairwise_dists
    from corrla_rs_tpu_torch.parallel.mesh import _all_gather

    xs, ys = _shard(x), _shard(y)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    out = {}
    with _inducing_seam(idx):
        for name, kw in (("opt", {}), ("fixed", dict(fixed))):
            opt = not kw
            sh = gp.SparseGpRegressor("rbf", inducing=24, key=3, **kw).fit(
                xs, ys, optimize_hypers=opt)
            one = gp.SparseGpRegressor("rbf", inducing=24, key=3, **kw).fit(
                xt, yt, optimize_hypers=opt)
            out[name] = {"pred": sh.predict(torch.as_tensor(xq)),
                         "single": one.predict(torch.as_tensor(xq)),
                         "hypers": (sh.length_scale, sh.signal_var,
                                    sh.noise_var),
                         "elbo": sh.elbo(), "elbo_single": one.elbo()}
        # the ELBO's gradient: the replicated loss through the psums
        x_ind = sh.x_ind
        r_mm = pairwise_dists(x_ind, x_ind)
        r_mn = pairwise_dists(x_ind, xs.to_local())
        yc = sh._yc
        r_mn1 = pairwise_dists(x_ind, xt)
        yc1 = _all_gather(yc, _mesh(), "rows")
        grads, grads1 = [], []
        for lp in ([0.0, 0.0, -4.0], [-0.7, 0.3, -2.0], [0.4, -0.5, -6.0]):
            p = torch.tensor(lp, dtype=torch.float64)
            grads.append(torch.func.grad(lambda q: gp._sgpr_neg_elbo(
                q, r_mm, r_mn, yc, "rbf", sh._sharded))(p))
            grads1.append(torch.func.grad(lambda q: gp._sgpr_neg_elbo(
                q, r_mm, r_mn1, yc1, "rbf"))(p))
    out["grad"] = torch.stack(grads)
    out["grad_single"] = torch.stack(grads1)
    out["x_ind"] = x_ind
    return _np(_replicated(out, "grad", "x_ind"))


def case_lstsq_rows(a, b, table):
    from corrla_rs_tpu_torch.ops.sketch_solve import sketched_lstsq

    with _sketches(table):
        x, hist = sketched_lstsq(a, b, key=7, mesh=_mesh())
        x_dt, _ = sketched_lstsq(_shard(a), _shard(b), key=7, mesh=_mesh())
    return _np(_replicated({"x": x, "hist": hist, "x_dt": x_dt}, "x",
                           "hist"))


def case_completion_rows(m_in, mask, n_sweeps, table):
    from corrla_rs_tpu_torch.ops.completion import matrix_complete

    with _sketches(table):
        m_hat, u, v, hist = matrix_complete(m_in, mask, 4, n_sweeps=n_sweeps,
                                            key=2, mesh=_mesh())
        single = matrix_complete(torch.as_tensor(m_in), torch.as_tensor(mask),
                                 4, n_sweeps=n_sweeps, key=2)
    out = {"m_hat": m_hat, "v": v, "hist": hist, "single": single[0],
           "placements": [str(p) for p in m_hat.placements]}
    return _np(_replicated(out, "v", "hist"))


def case_spod_rows(x, weights):
    from corrla_rs_tpu_torch.models.spod import spod

    out = {}
    for name, w in (("plain", None), ("weighted", weights)):
        f = spod(x, n_fft=128, overlap=0.5, n_modes=4, weights=w,
                 mesh=_mesh())
        g = spod(torch.as_tensor(x), n_fft=128, overlap=0.5, n_modes=4,
                 weights=w)
        out[name] = {"energies": f.energies, "re": f.modes_re,
                     "im": f.modes_im, "single_energies": g.energies,
                     "single_re": g.modes_re, "single_im": g.modes_im,
                     "placements": [str(p) for p in f.modes_re.placements]}
    out["digest"] = _same_on_ranks([out["plain"]["energies"],
                                    out["weighted"]["energies"]])
    return _np(out)


def case_cp_rows(t, table, init):
    from corrla_rs_tpu_torch.ops.cp import cp_als, cp_reconstruct
    from corrla_rs_tpu_torch.parallel.mesh import _full

    with _sketches(table):
        w, f, fits = cp_als(t, 3, n_sweeps=30, key=1, init=init,
                            mesh=_mesh())
        w1, f1, fits1 = cp_als(torch.as_tensor(t), 3, n_sweeps=30, key=1,
                               init=init)
    out = _replicated({"w": w, "fits": fits, "f1": f[1]}, "w", "fits", "f1")
    rec = cp_reconstruct(w, [_full(f[0])] + f[1:])
    out.update(rec=rec, rec1=cp_reconstruct(w1, f1), w1=w1,
               placements=[str(p) for p in f[0].placements])
    return _np(out)


def case_nmf_rows(x, table):
    from corrla_rs_tpu_torch.ops.nmf import nmf
    from corrla_rs_tpu_torch.parallel.mesh import _full

    with _sketches(table):
        w, h, errs = nmf(x, 4, n_sweeps=100, key=2, mesh=_mesh())
        w1, h1, _ = nmf(torch.as_tensor(x), 4, n_sweeps=100, key=2)
    out = _replicated({"h": h, "errs": errs}, "h", "errs")
    out.update(wh=_full(w) @ h, wh1=w1 @ h1, w=w)
    return _np(out)


def case_rpca_rows(m):
    from corrla_rs_tpu_torch.ops.robust_pca import robust_pca

    l_mat, s, info = robust_pca(m, max_iter=120, mesh=_mesh())
    out = {"l": l_mat, "s": s, "info": info,
           "placements": [str(p) for p in l_mat.placements],
           "digest": _same_on_ranks(info)}
    return _np(out)


def case_gmm_rows(x, first, gumbel):
    from corrla_rs_tpu_torch.ops import gmm

    seam = _inject((gmm, "_draw_kmeanspp",
                    lambda key, n, k, dtype, device: (
                        first, torch.as_tensor(gumbel, dtype=dtype))))
    with seam:
        f = gmm.gmm_fit(x, 3, key=2, n_iter=60, mesh=_mesh())
        f1 = gmm.gmm_fit(torch.as_tensor(x), 3, key=2, n_iter=60)
    n = _mesh().size()
    try:
        gmm.gmm_fit(x[:n + 1], 2, mesh=_mesh())
        err = None
    except ValueError as e:
        err = str(e)
    out = {"fit": tuple(f[:5]), "single": tuple(f1[:5]),
           "resp": f.responsibilities, "bic": f.bic(), "error": err}
    out["digest"] = _same_on_ranks(out["fit"])
    return _np(out)


def case_traffic(a, t, x, m, k):
    """The bytes of every collective of the sharded factorizations: the
    largest, and what the matrix's shard on one rank holds."""
    from corrla_rs_tpu_torch.models.pca import PcaRsvd
    from corrla_rs_tpu_torch.ops.cp import cp_als
    from corrla_rs_tpu_torch.ops.nmf import nmf
    from corrla_rs_tpu_torch.ops.robust_pca import robust_pca
    from corrla_rs_tpu_torch.parallel.mesh import record_traffic
    from corrla_rs_tpu_torch.parallel.sharded_rsvd import sharded_random_svd

    mesh = _mesh()
    runs = {"rsvd": lambda: sharded_random_svd(a, k, 4, 4, key=0, mesh=mesh),
            "pca": lambda: PcaRsvd(a, k, mesh=mesh),
            "cp": lambda: cp_als(t, 3, n_sweeps=5, key=1, mesh=mesh),
            "nmf": lambda: nmf(x, 4, n_sweeps=5, key=2, mesh=mesh),
            "robust_pca": lambda: robust_pca(m, max_iter=10, mesh=mesh)}
    out = {}
    for name, fn in runs.items():
        with record_traffic() as log:
            fn()
        out[name] = max(nbytes for _op, nbytes in log), len(log)
    return out


# ---------------------------------------------------------------------------
# member- and chain-sharded inference (tests/test_torch_parallel_members.py)


def _error(fn):
    """The message of the ``ValueError`` ``fn()`` raises (None if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _placements(x):
    return [str(p) for p in x.placements]


def _normals_seam(z_state, z_obs):
    """``enkf._draw_normals`` handing out the given tables."""
    from corrla_rs_tpu_torch.ops import enkf

    def draw(key, n_steps, n_ens, n_state, p, dtype, device):
        zs = None if z_state is None else torch.as_tensor(z_state,
                                                          dtype=dtype)
        return zs, torch.as_tensor(z_obs, dtype=dtype)

    return _inject((enkf, "_draw_normals", draw))


def case_enkf_analysis_members(setups):
    """Both analyses on the member-sharded ensemble of each setup (a dict
    of x, y, h, r and JAX's perturbations z), the first also from a
    DTensor, with the single-device port on the same draws."""
    from corrla_rs_tpu_torch.ops import enkf

    mesh = _mesh()
    out = []
    for st in setups:
        x, y, h, r = st["x"], st["y"], st["h"], st["r"]
        with _normals_seam(None, st["z"][None]):
            sto = enkf.enkf_analysis(x, y, h, r, 5, mesh=mesh)
            dt = enkf.enkf_analysis(_shard(x), y, h, r, 5, mesh=mesh)
            single = enkf.enkf_analysis(torch.as_tensor(x), y, h, r, 5)
        etkf = enkf.etkf_analysis(x, y, h, r, inflation=1.05, mesh=mesh)
        out.append({"enkf": sto, "dtensor": dt, "single": single,
                    "etkf": etkf, "local": tuple(sto.to_local().shape),
                    "etkf_single": enkf.etkf_analysis(
                        torch.as_tensor(x), y, h, r, inflation=1.05),
                    "placements": _placements(sto) + _placements(etkf)})
    x, y, h, r = (setups[0][k] for k in "xyhr")
    n = x.shape[0]
    errors = [_error(lambda: enkf.enkf_analysis(x[:n - 1], y, h, r, 5,
                                                mesh=mesh)),
              _error(lambda: enkf.etkf_analysis(x, y, h, r, mesh=mesh,
                                                axis_name="bogus"))]
    return _np({"runs": out, "errors": errors})


def case_enkf_filter_members(x0, ys, a, h, r, q, method, z_q, z_r):
    from corrla_rs_tpu_torch.ops import enkf

    a_t = torch.as_tensor(a)

    def prop(v):
        return torch.tanh(a_t @ v)

    with _normals_seam(z_q, z_r):
        res = enkf.enkf_filter(x0, ys, prop, h, r, 9, method=method,
                               inflation=1.02, q=q, mesh=_mesh())
        single = enkf.enkf_filter(torch.as_tensor(x0), ys, prop, h, r, 9,
                                  method=method, inflation=1.02, q=q)
    out = _replicated({"means": res["means"], "spread": res["spread"],
                       "ensemble": res["ensemble"], "single": single,
                       "placements": _placements(res["ensemble"])},
                      "means", "spread")
    return _np(out)


def case_esmda_members(x0, g, y, r, z):
    from corrla_rs_tpu_torch.ops import enkf

    g_t = torch.as_tensor(g)

    def fwd(th):
        return g_t @ th + 0.1 * th[0] ** 2

    with _normals_seam(None, z):
        res = enkf.esmda(x0, fwd, y, r, 11, n_mda=4, mesh=_mesh())
        single = enkf.esmda(torch.as_tensor(x0), fwd, y, r, 11, n_mda=4)
    out = _replicated({"ensemble": res["ensemble"], "mean": res["mean"],
                       "predicted": res["predicted"],
                       "misfit": torch.as_tensor(res["data_misfit"]),
                       "single": single,
                       "placements": _placements(res["ensemble"])
                       + _placements(res["predicted"])}, "mean", "misfit")
    return _np(out)


def _smc_fns(mu):
    mu = torch.as_tensor(mu)

    def ln_like(x):
        return -0.5 * torch.sum((x - mu) ** 2) / 0.3 ** 2

    def ln_prior(x):
        return -0.5 * torch.sum(x ** 2 / 4.0)

    return ln_like, ln_prior


def case_smc_members(init, mu, stages):
    """smc_sample on JAX's stage tables (``stages``: one (u_res, pairs,
    eps, u_acc) a stage), the single-device port on the same tables, and
    the divisibility error."""
    from corrla_rs_tpu_torch.ops import smc

    tables = [smc._StageRand(*(torch.as_tensor(t) for t in st))
              for st in stages]

    def seam():
        pending = list(tables)
        return _inject((smc, "_draw_smc", lambda *a: pending.pop(0)))

    fns = _smc_fns(mu)
    with seam():
        res = smc.smc_sample(*fns, init, n_mcmc=3, key=7,
                             mesh=_mesh(None, "chains"))
    with seam():
        single = smc.smc_sample(*fns, torch.as_tensor(init), n_mcmc=3, key=7)
    out = {"particles": res.particles, "betas": res.betas,
           "log_z": res.log_evidence, "ess": res.ess,
           "ar": res.accept_ratios, "n_stages": res.n_stages,
           "single": {"particles": single.particles, "betas": single.betas,
                      "log_z": single.log_evidence},
           "placements": _placements(res.particles),
           "error": _error(lambda: smc.smc_sample(
               *fns, init[:init.shape[0] - 1], key=7,
               mesh=_mesh(None, "chains")))}
    return _np(_replicated(out, "betas", "log_z", "ess", "ar"))


def _lnp_sig(sig):
    sig = torch.as_tensor(sig)

    def lnp(x):
        return -0.5 * torch.sum((x / sig) ** 2)

    return lnp


def case_chains_members(x0, sig, n_steps, n_warmup, seed, sampler,
                        jax_tables):
    """hmc_run or nuts_run on chain-sharded chains, on the JAX package's
    draws (``jax_tables``: {phase: the columns of the sampler's draw table
    for every generation}; HMC's trajectory lengths a list); and 100
    generations without warmup against the single-device port on the same
    torch draws."""
    from corrla_rs_tpu_torch.ops import hmc, nuts

    mod = {"hmc": hmc, "nuts": nuts}[sampler]
    run = {"hmc": hmc.hmc_run, "nuts": nuts.nuts_run}[sampler]
    lnp = _lnp_sig(sig)
    mesh = _mesh(None, "chains")

    def draw(gen, phase, start, n_gens, *args):
        stop = start + n_gens
        return mod._GenRand(*(
            list(col[start:stop]) if isinstance(col, list)
            else torch.as_tensor(col[start:stop])
            for col in jax_tables[phase]))

    with _inject((mod, "_draw_" + sampler, draw)):
        res = run(x0, lnp, n_steps, n_warmup, key=seed, mesh=mesh)
    # without warmup no cross-chain sum reaches the dynamics (a step size
    # near the adapted ones keeps NUTS's trees shallow, and HMC's
    # trajectories short)
    kw = {"init_step_size": 0.8, "key": seed}
    if sampler == "hmc":
        kw["n_leapfrog"] = 8
    cold = (run(x0, lnp, 100, 0, mesh=mesh, **kw).history,
            run(torch.as_tensor(x0), lnp, 100, 0, **kw).history)
    out = {"history": res.history, "step": res.step_size,
           "inv_mass": res.inv_mass, "accept": res.accept_ratio,
           "n_div": res.n_divergent, "cold": cold,
           "placements": _placements(res.history) + _placements(res.final),
           "error": _error(lambda: run(x0[:x0.shape[0] - 1], lnp, 5,
                                       mesh=mesh))}
    return _np(_replicated(out, "step", "inv_mass", "accept", "n_div"))


def case_chain_reductions(warm_hist, a_stat):
    """The warmup's cross-chain reductions on a fixed warm history (n1, C,
    d) and acceptance vector (C,): ``hmc._mass_from`` and the mean of the
    dual-averaging statistic on the rank's chains, summed over the ranks,
    and on all chains without a mesh."""
    from corrla_rs_tpu_torch.ops.hmc import _mass_from
    from corrla_rs_tpu_torch.parallel.mesh import _member_view

    hist, acc = torch.as_tensor(warm_hist), torch.as_tensor(a_stat)
    sh = _member_view(hist[0], _mesh(None, "chains"), None, "n_chains")
    whole = _member_view(hist[0], None, None, "n_chains")
    return _np(_replicated({
        "inv_mass": _mass_from(hist[:, sh.rows], sh),
        "a_mean": sh.mean(acc[sh.rows]),
        "single": (_mass_from(hist, whole), whole.mean(acc))},
        "inv_mass", "a_mean"))


def case_warmup_trace(x0, sig, n_steps, n_warmup, seed, sampler,
                      nudged=True):
    """Every warmup generation's step size and acceptance statistic, and
    the adapted inverse mass and step size, of the chain-sharded run, of
    the single-device one on the same torch draws and, with ``nudged``, of
    the single-device one with its first acceptance statistic moved up by
    one ulp."""
    from corrla_rs_tpu_torch.ops import hmc, nuts

    run = {"hmc": hmc.hmc_run, "nuts": nuts.nuts_run}[sampler]
    dual_averaging = hmc._dual_averaging

    def traced(x, nudge=False):
        trace = []

        def recording(advance, n_gens, eps0, target_accept):
            def step(i, eps):
                a_stat = advance(i, eps)
                if nudge and not trace:
                    a_stat = torch.nextafter(a_stat, a_stat + 1.0)
                trace.append((eps.item(), a_stat.item()))
                return a_stat

            return dual_averaging(step, n_gens, eps0, target_accept)

        with _inject((hmc, "_dual_averaging", recording),
                     (nuts, "_dual_averaging", recording)):
            res = run(x, _lnp_sig(sig), n_steps, n_warmup, key=seed,
                      **({"mesh": _mesh(None, "chains")}
                         if not isinstance(x, torch.Tensor) else {}))
        return {"trace": np.array(trace), "inv_mass": res.inv_mass,
                "step": res.step_size, "history": res.history}

    out = {"sharded": traced(x0), "single": traced(torch.as_tensor(x0))}
    if nudged:
        out["nudged"] = traced(torch.as_tensor(x0), nudge=True)
    return _np(out)


def case_particle_members(x0, ys, noise, offsets):
    """particle_filter on a particle-sharded cloud: each rank's propagate
    pops its rows of JAX's per-particle noise; the offsets are JAX's."""
    import torch.distributed as dist

    from corrla_rs_tpu_torch.ops import particle

    mesh = _mesh()
    n_local = x0.shape[0] // mesh.size()
    rows = slice(dist.get_rank() * n_local, (dist.get_rank() + 1) * n_local)

    def propagator(rows):
        pending = [torch.as_tensor(z[rows]) for z in noise]

        def prop(gen, cloud):
            assert isinstance(gen, torch.Generator)
            return 0.8 * cloud + 0.3 * pending.pop(0)

        return prop

    def loglik(x, y):
        return -0.5 * torch.sum((y - x) ** 2) / 0.25

    seam = _inject((particle, "_draw_offsets",
                    lambda gen, n_steps, dtype: torch.as_tensor(
                        offsets, dtype=dtype)))
    out = {}
    with seam:
        for thresh in (0.5, 1.0):
            res = particle.particle_filter(x0, ys, propagator(rows), loglik,
                                           3, resample_threshold=thresh,
                                           mesh=mesh)
            single = particle.particle_filter(
                torch.as_tensor(x0), ys, propagator(slice(None)), loglik, 3,
                resample_threshold=thresh)
            out[thresh] = _replicated(
                {"means": res["means"], "loglik": res["loglik"],
                 "ess": res["ess"], "particles": res["particles"],
                 "log_weights": res["log_weights"], "single": single,
                 "placements": _placements(res["particles"])},
                "means", "loglik", "ess")
    out["error"] = _error(lambda: particle.particle_filter(
        x0[:x0.shape[0] - 1], ys, propagator(rows), loglik, 3, mesh=mesh))
    return _np(out)


def case_particle_generator(x0, ys):
    """The generator each rank's propagate draws from: coordinate 0 the
    run's, so a world of one is the single-device run; the others their
    own."""
    from corrla_rs_tpu_torch.ops.particle import particle_filter

    def prop(gen, cloud):
        return 0.8 * cloud + 0.3 * torch.randn(cloud.shape, generator=gen,
                                               dtype=cloud.dtype)

    def loglik(x, y):
        return -0.5 * torch.sum((y - x) ** 2) / 0.25

    res = particle_filter(x0, ys, prop, loglik, 3, mesh=_mesh())
    single = particle_filter(torch.as_tensor(x0), ys, prop, loglik, 3)
    return _np({"particles": res["particles"], "means": res["means"],
                "single": single["particles"],
                "single_means": single["means"]})


def _canonical_eigh(a):
    """``torch.linalg.eigh`` with each eigenvector's largest entry made
    positive: the sign rule the CMA-ES parity test gives both packages."""
    w, v = _EIGH(a)
    idx = torch.argmax(v.abs(), dim=-2, keepdim=True)
    return w, v * torch.sign(torch.gather(v, -2, idx))


_EIGH = torch.linalg.eigh


def case_cma_members(x0, draws, n_gens, pop):
    from corrla_rs_tpu_torch.ops import cma

    def rosen(x):
        return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                         + (1.0 - x[:-1]) ** 2)

    mesh = _mesh()
    seam = _inject((cma, "_draw_normals",
                    lambda key, n, p, d, dtype, device: torch.as_tensor(
                        draws, dtype=dtype)),
                   (torch.linalg, "eigh", _canonical_eigh))
    with seam:
        res = cma.cma_es(rosen, x0, sigma0=0.4, n_gens=n_gens, pop_size=pop,
                         key=5, mesh=mesh)
        single = cma.cma_es(rosen, x0, sigma0=0.4, n_gens=n_gens,
                            pop_size=pop, key=5, device="cpu")
    out = {"x_best": res.x_best, "f_best": res.f_best, "mean": res.mean,
           "sigma": res.sigma, "history": res.history,
           "single": (single.x_best, single.f_best, single.history),
           "errors": [
               _error(lambda: cma.cma_es(rosen, x0, n_gens=2,
                                         pop_size=2 * mesh.size() + 1,
                                         mesh=mesh)),
               _error(lambda: cma.cma_es(
                   lambda p: (p ** 2).sum().item(), x0, n_gens=2,
                   pop_size=2 * mesh.size(), mesh=mesh))]}
    return _np(_replicated(out, "x_best", "f_best", "history"))


def case_ensemble_members(x, u, table):
    """dmdc_fit_ensemble and rollout_ensemble on a member-sharded DTensor
    (JAX's sketches in the seam), with the single-device port."""
    from corrla_rs_tpu_torch.models.dmd import dmdc_fit_ensemble, \
        rollout_ensemble

    x_dt, u_dt = _shard(x), _shard(u)
    with _sketches(table):
        fit = dmdc_fit_ensemble(x_dt, u_dt, 6, 15, key=4)
        single = dmdc_fit_ensemble(torch.as_tensor(x), torch.as_tensor(u), 6,
                                   15, key=4)
    out = {"placements": {k: _placements(v) for k, v in fit.items()},
           "lambdas_re": fit["lambdas_re"], "single": single["lambdas_re"]}
    x0 = x[:, :, :1]
    for method in ("reduced", "modes"):
        roll = rollout_ensemble(fit, _shard(x0), u_dt, method)
        out[method] = roll
        out[method + "_placements"] = _placements(roll)
        out[method + "_single"] = rollout_ensemble(single, x0, u, method)
        # shared controls and a full x0 every rank holds
        out[method + "_shared"] = rollout_ensemble(fit, x0, u[0], method)
    return _np(out)


def case_traffic_members(enkf_args, pf_args, cma_args, chains_args):
    """The bytes of every collective of the member- and chain-sharded
    paths: (op, bytes) for each."""
    from corrla_rs_tpu_torch.ops import cma, enkf, particle
    from corrla_rs_tpu_torch.ops.hmc import hmc_run
    from corrla_rs_tpu_torch.ops.nuts import nuts_run
    from corrla_rs_tpu_torch.parallel.mesh import record_traffic

    mesh = _mesh()
    x, y, h = enkf_args
    x0, ys = pf_args

    def prop(gen, cloud):
        return 0.8 * cloud + 0.3 * torch.randn(cloud.shape, generator=gen,
                                               dtype=cloud.dtype)

    def loglik(v, obs):
        return -0.5 * torch.sum((obs - v) ** 2) / 0.25

    def sphere(v):
        return torch.sum(v ** 2)

    c0, sig = chains_args
    runs = {"enkf": lambda: enkf.enkf_analysis(x, y, h, 0.3, 5, mesh=mesh),
            "etkf": lambda: enkf.etkf_analysis(x, y, h, 0.3, mesh=mesh),
            "particle": lambda: particle.particle_filter(
                x0, ys, prop, loglik, 3, resample_threshold=1.0, mesh=mesh),
            "cma": lambda: cma.cma_es(sphere, cma_args, n_gens=5,
                                      pop_size=4 * mesh.size(), mesh=mesh),
            "hmc": lambda: hmc_run(c0, _lnp_sig(sig), 10, 30, n_leapfrog=4,
                                   mesh=mesh),
            "nuts": lambda: nuts_run(c0, _lnp_sig(sig), 10, 30, max_depth=4,
                                     mesh=mesh)}
    out = {}
    for name, fn in runs.items():
        with record_traffic() as log:
            fn()
        out[name] = list(log)
    return out


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}
