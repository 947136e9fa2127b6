"""Device-mesh construction and sharding vocabulary on ``torch.distributed``.

Counterpart of ``corrla_rs_tpu/parallel/mesh.py``. A JAX mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names
(``"rows"`` for the tall/sample axis of data matrices, ``"chains"`` for MCMC
chain populations, ``MeshConfig.axis_names`` for the 2-D mesh), and a
``NamedSharding`` is a tuple of DTensor placements: ``row_sharding`` is
``Shard(0)`` on the axis, ``replicated_sharding`` is ``Replicate()``.

JAX is single-controller; torch is SPMD. Every rank of the mesh makes the
same call with the same arguments:

- a sharded entry point takes a ``DTensor`` already sharded on the mesh
  (the out-of-core case: each rank only ever holds its rows), or a full
  tensor or numpy array that every rank holds, of which each rank keeps its
  own rows, with no communication;
- what JAX returns row-sharded comes back as a ``DTensor`` with
  ``Shard(0)`` on the axis; replicated results are plain tensors, equal on
  every rank.

The process group comes first: ``torchrun`` and ``init_distributed()``, or
``init_distributed(init_method=..., world_size=..., rank=...)``. A mesh on
the card is a CUDA mesh (NCCL) unless the caller asks for ``"cpu"`` (gloo);
nothing here moves to the CPU or to one process because it found no GPU or
no process group: it raises.

A function without ``mesh=`` whose JAX counterpart GSPMD partitions when
its data arrives row-sharded (``pearson_corr``, ``mat_cov_centered``, the
``nll`` of the univariate variables, ``single_pass_svd``,
``SparseGpRegressor.fit``) takes the sharded path when it is handed a
``DTensor`` with ``Shard(0)`` on a 1-D mesh (``rows_of_dtensor``); any other
placement raises a ``ValueError`` that names it.

Collectives of the sharded bodies (JAX name -> here): ``psum`` ->
``_psum`` (all-reduce sum; ``_psum_grad`` and ``_to_local`` where
autograd runs through it),
``pmax`` -> ``_pmax``, ``all_gather(tiled=True)`` -> ``_all_gather``
(all-gather along dim 0), ``axis_index`` -> ``_coord`` (the rank's
coordinate on the axis). ``_full`` gathers a DTensor whole through
``_all_gather``. ``record_traffic()`` records the bytes each of them
moves.
"""
from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from corrla_rs_tpu_torch.utils.device import as_tensor

ROWS_AXIS = "rows"
CHAINS_AXIS = "chains"

__all__ = [
    "ROWS_AXIS",
    "CHAINS_AXIS",
    "init_distributed",
    "make_mesh",
    "make_mesh_2d",
    "row_sharding",
    "replicated_sharding",
    "shard_rows",
    "record_traffic",
]


def init_distributed(**kwargs) -> None:
    """Start this process's default process group: a passthrough to
    ``torch.distributed.init_process_group``. Call once on every rank
    before building meshes.

    ``device_type`` (default ``"cuda"``) picks the backend unless
    ``backend`` is given: NCCL for CUDA, gloo for the CPU. On CUDA the rank
    then works on ``cuda:LOCAL_RANK`` (``torchrun`` sets it; else the rank
    modulo the device count). Without ``init_method`` or ``store`` the
    group reads ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``
    from the environment, as ``torchrun`` sets them.
    """
    device_type = kwargs.pop("device_type", "cuda")
    kwargs.setdefault("backend", "nccl" if device_type == "cuda" else "gloo")
    dist.init_process_group(**kwargs)
    if device_type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        index = (int(local) if local is not None
                 else dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(index)


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call parallel.mesh.init_distributed() (or "
            "run under torchrun) on every rank before building a mesh")
    return dist.get_world_size()


def _build(device_type: str, shape: tuple, names: tuple) -> DeviceMesh:
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))


def make_mesh(n_devices: int | None = None, axis_name: str = ROWS_AXIS,
              device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the first ``n_devices`` ranks (default, or more than
    the world holds: all of them, as the JAX package's ``devs[:n]``).
    Every rank of the world calls it."""
    world = _world()
    n = world if n_devices is None else min(int(n_devices), world)
    return _build(device_type, (n,), (axis_name,))


def make_mesh_2d(config=None, rows: int | None = None,
                 chains: int | None = None,
                 device_type: str = "cuda") -> DeviceMesh:
    """2-D ("rows", "chains") mesh from a utils.config.MeshConfig (or
    explicit axis sizes). rows * chains must not exceed the world size;
    axis names follow config.axis_names."""
    from corrla_rs_tpu_torch.utils.config import MeshConfig

    cfg = config or MeshConfig(rows=rows or 1, chains=chains or 1)
    rows = rows if rows is not None else cfg.rows
    chains = chains if chains is not None else cfg.chains
    world = _world()
    if rows * chains > world:
        raise ValueError(
            f"mesh {rows}x{chains} needs {rows * chains} devices, "
            f"have {world}"
        )
    return _build(device_type, (rows, chains), tuple(cfg.axis_names))


def row_sharding(mesh: DeviceMesh, axis_name: str | None = None) -> tuple:
    """Placements that split axis 0 of a matrix across the mesh axis (an
    axis the mesh does not have raises ``ValueError``)."""
    axis_name = _axis(mesh, axis_name)
    return tuple(Shard(0) if name == axis_name else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated_sharding(mesh: DeviceMesh) -> tuple:
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def shard_rows(a, mesh: DeviceMesh):
    """``a`` row-sharded on the mesh as a ``DTensor``: each rank keeps its
    own rows of the full ``a`` it holds, with no communication (a DTensor
    is returned as it is)."""
    if isinstance(a, DTensor):
        return a
    axis = mesh.mesh_dim_names[0]
    a = a if isinstance(a, torch.Tensor) else as_tensor(a, device="cpu")
    n_dev = _size(mesh, axis)
    if a.shape[0] % n_dev:
        raise ValueError(
            f"rows ({a.shape[0]}) must divide the mesh axis size ({n_dev})")
    local, shape = _local(a, mesh, axis)
    return _dtensor(local, mesh, axis, 0, shape)


# ---------------------------------------------------------------------------
# what the sharded bodies share


def _axis(mesh: DeviceMesh, axis_name: str | None) -> str:
    """The axis a sharded call works on (default: the mesh's first)."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(parallel.mesh.make_mesh), got {type(mesh)}")
    names = mesh.mesh_dim_names
    if axis_name is None:
        return names[0]
    if axis_name not in names:
        raise ValueError(f"mesh has no axis {axis_name!r}; its axes are "
                         f"{names}")
    return axis_name


def _size(mesh: DeviceMesh, axis_name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def _coord(mesh: DeviceMesh, axis_name: str) -> int:
    """This rank's coordinate on the axis (JAX ``axis_index``)."""
    return mesh.get_local_rank(axis_name)


def _group(mesh: DeviceMesh, axis_name: str):
    return mesh.get_group(axis_name)


def _device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _rows_of(a: torch.Tensor, mesh, axis_name: str, dim: int):
    """This rank's block of ``a`` along ``dim`` (a view, no copy)."""
    n_local = a.shape[dim] // _size(mesh, axis_name)
    return a.narrow(dim, _coord(mesh, axis_name) * n_local, n_local)


def _local(a, mesh, axis_name: str, dim: int = 0, device=None, dtype=None):
    """(this rank's block of ``a`` along ``dim``, ``a``'s global shape).

    ``a`` is a DTensor sharded along ``dim`` on the axis, or a full array
    every rank holds (taken to the mesh's device, or ``device``). The
    caller has checked that the axis size divides ``a.shape[dim]``."""
    if isinstance(a, DTensor):
        placement = a.placements[a.device_mesh.mesh_dim_names.index(
            axis_name)]
        if placement != Shard(dim):
            raise ValueError(f"expected a DTensor sharded along dim {dim} on "
                             f"axis {axis_name!r}, got {a.placements}")
        local = a.to_local()
        if dtype is not None:
            local = local.to(dtype)
        return local.contiguous(), tuple(a.shape)
    # narrowed where it lies, so only this rank's block is copied over; a
    # dense block, so the products do not depend on how ``a`` was laid out
    a = a if isinstance(a, torch.Tensor) else as_tensor(a, device="cpu")
    block = _rows_of(a, mesh, axis_name, dim)
    return (block.to(device=device or _device(mesh), dtype=dtype)
            .contiguous(), tuple(a.shape))


def _dtensor(local: torch.Tensor, mesh, axis_name: str, dim: int,
             shape) -> DTensor:
    """``local`` as this rank's block of a DTensor of global ``shape``,
    sharded along ``dim`` on the axis and replicated on the others."""
    shape = torch.Size(shape)
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    placements = tuple(Shard(dim) if name == axis_name else Replicate()
                       for name in mesh.mesh_dim_names)
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=shape,
                              stride=tuple(stride))


def _placement(dt: DTensor):
    """(mesh, axis name, tensor dim) of a DTensor sharded on one axis."""
    mesh = dt.device_mesh
    for name, p in zip(mesh.mesh_dim_names, dt.placements):
        if isinstance(p, Shard):
            return mesh, name, p.dim
    raise ValueError(f"DTensor is not sharded: {dt.placements}")


def rows_of_dtensor(x):
    """(this rank's rows, global shape, mesh, axis name) of a DTensor with
    ``Shard(0)`` on a 1-D mesh, the sharded path of the functions without
    ``mesh=``; None for anything that is not a DTensor. Any other placement
    raises ``ValueError`` naming it."""
    if not isinstance(x, DTensor):
        return None
    mesh = x.device_mesh
    if mesh.ndim != 1 or tuple(x.placements) != (Shard(0),):
        raise ValueError(
            f"a DTensor argument must be row-sharded (Shard(0)) on a 1-D "
            f"mesh, got placements {tuple(x.placements)} on a mesh of "
            f"shape {tuple(mesh.mesh.shape)}")
    # the local tensor itself: ``to_local()`` is an autograd.Function that
    # torch.func's transforms refuse, and a loss differentiated with them
    # (an MLE's BFGS) may read its data here
    return (x._local_tensor.contiguous(), tuple(x.shape), mesh,
            mesh.mesh_dim_names[0])


def _full(x):
    """The whole of a DTensor (every rank of its mesh calls), gathered
    along its sharded dim by ``_all_gather``; anything else comes back as
    it is. ``DTensor.full_tensor()``'s functional all-gather hangs under
    gloo with CUDA tensors (two ranks on one card), where
    ``all_gather_into_tensor`` works."""
    if not isinstance(x, DTensor):
        return x
    if not any(isinstance(p, Shard) for p in x.placements):
        return x.to_local()
    mesh, axis, dim = _placement(x)
    local = x.to_local().movedim(dim, 0)
    return _all_gather(local, mesh, axis).movedim(0, dim)


# where record_traffic() collects (op, bytes) of every collective
_TRAFFIC: list | None = None


@contextlib.contextmanager
def record_traffic():
    """Collect ``(op, bytes)`` for every ``_psum``/``_pmax``/
    ``_all_gather`` of this process inside the block: the bytes of each
    collective's result, as the JAX package's never-gathers tests read
    them off the compiled program."""
    global _TRAFFIC
    prev, _TRAFFIC = _TRAFFIC, []
    try:
        yield _TRAFFIC
    finally:
        _TRAFFIC = prev


def _note(op: str, t: torch.Tensor) -> None:
    if _TRAFFIC is not None:
        _TRAFFIC.append((op, t.numel() * t.element_size()))


def _reduce(t: torch.Tensor, mesh, axis_name: str, op, name: str):
    """All-reduce over the axis, in place on ``t`` (a fresh temporary);
    complex tensors go as their real view."""
    t = t.contiguous()
    _note(name, t)
    flat = torch.view_as_real(t) if t.is_complex() else t
    dist.all_reduce(flat, op=op, group=_group(mesh, axis_name))
    return t


def _psum(t: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """All-reduce sum over the axis, in place on ``t`` (a fresh
    temporary); returns it."""
    return _reduce(t, mesh, axis_name, dist.ReduceOp.SUM, "psum")


def _pmax(t: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """All-reduce max over the axis, in place on ``t``; returns it."""
    return _reduce(t, mesh, axis_name, dist.ReduceOp.MAX, "pmax")


# Gradients of a loss that every rank computes alike (replicated) from
# rank-local work joined by collectives, as a Megatron-style pair:
# ``_psum_grad`` leaves the local work with the identity as its backward,
# since every rank already holds the gradient of the sum; ``_to_local``
# marks a replicated tensor entering the local work, and its backward sums
# the ranks' shares of the gradient, so what flows on into the replicated
# part is the whole gradient, equal on every rank.
# (``torch.distributed.nn.functional.all_reduce`` all-reduces the gradient
# on the way back, which multiplies it by the world size here.)


class _PsumReplicated(torch.autograd.Function):
    """``_psum`` whose backward passes the gradient through."""

    @staticmethod
    def forward(t, mesh, axis_name):
        return _psum(t.clone(), mesh, axis_name)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def _psum_grad(t: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """``_psum`` with the pass-through gradient of ``_PsumReplicated``."""
    return _PsumReplicated.apply(t, mesh, axis_name)


class _ToLocal(torch.autograd.Function):
    """The identity, whose backward is ``_psum`` of the gradient."""

    @staticmethod
    def forward(t, mesh, axis_name):
        return t.view_as(t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.where = inputs[1:]

    @staticmethod
    def backward(ctx, grad):
        return _psum(grad.clone(), *ctx.where), None, None


def _to_local(t: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """A replicated tensor entering rank-local work (see above)."""
    return _ToLocal.apply(t, mesh, axis_name)


# all_gather_into_tensor was renamed; take the name this torch has
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _all_gather(t: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """Every rank's ``t`` stacked along dim 0 in axis order (JAX
    ``all_gather(tiled=True)``)."""
    t = t.contiguous()
    out = t.new_empty((_size(mesh, axis_name) * t.shape[0],) + t.shape[1:])
    _note("all_gather", out)
    _gather_into(out, t, group=_group(mesh, axis_name))
    return out

