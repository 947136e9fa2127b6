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
``_all_gather``. What GSPMD does for a gather of rows by index or a
change of layout is explicit here: ``_take_rows`` moves the rows a
resample or a proposal needs between ranks through ``_all_to_all``
(uneven all-to-all along dim 0), and ``_rows_to_cols``/``_cols_to_rows``
turn a row-sharded matrix into a column-sharded one and back.
``record_traffic()`` records the bytes each of them moves. A member-,
chain- or particle-parallel loop sees its rows through ``_member_view``:
a ``_Members`` on a mesh, a ``_Whole`` (every reduction the identity)
without one, so that it writes each reduction once.
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


def _members(mesh: DeviceMesh, axis_name: str | None, n: int,
              what: str):
    """(axis, this rank's slice of the ``n`` members, chains or particles)
    of a member-sharded call, after the check that the axis size divides
    ``n``."""
    axis = _axis(mesh, axis_name)
    n_dev = _size(mesh, axis)
    if n % n_dev:
        raise ValueError(f"mesh axis size ({n_dev}) must divide {what} "
                         f"({n})")
    n_local = n // n_dev
    coord = _coord(mesh, axis)
    return axis, slice(coord * n_local, (coord + 1) * n_local)


class _Whole:
    """A member-, chain- or particle-parallel call's view of its rows
    without a mesh: all ``n`` rows here, every reduction the identity. It
    has ``_Members``'s methods, so each reduction is written once (sum
    the local rows, then ``sum``, then divide by ``n``) and a world of one
    is the single-device run bit for bit."""

    coord = 0
    rows = slice(None)

    def __init__(self, x):
        self.local = x
        self.shape = tuple(x.shape)
        self.n = self.shape[0]

    def sum(self, t):
        return t

    def max(self, t):
        return t

    def mean(self, x):
        """The mean over all members of ``x``, the rank's rows."""
        return self.sum(torch.sum(x, dim=0)) / self.n

    def gather(self, x):
        return x

    def to_cols(self, x):
        return x, None

    def to_rows(self, x, cols):
        return x

    def take(self, x, want):
        return x[want]

    def dtensor(self, local, dim: int = 0):
        return local


class _Members(_Whole):
    """A member-sharded call's view of its members, chains or particles
    (the rows of ``x``, a DTensor sharded along them or the full array
    every rank holds): the mesh, the axis, this rank's ``rows`` of the
    ``n`` and its block ``local``; the reductions over all of them and
    the way back to a DTensor."""

    def __init__(self, x, mesh, axis_name, what: str):
        self.mesh = mesh
        self.axis, self.rows = _members(mesh, axis_name, int(x.shape[0]),
                                        what)
        self.local, self.shape = _local(x, mesh, self.axis)
        self.n = self.shape[0]
        self.coord = _coord(mesh, self.axis)

    def sum(self, t):
        return _psum(t, self.mesh, self.axis)

    def max(self, t):
        return _pmax(t, self.mesh, self.axis)

    def gather(self, x):
        return _all_gather(x, self.mesh, self.axis)

    def to_cols(self, x):
        return _rows_to_cols(x, self.mesh, self.axis)

    def to_rows(self, x, cols):
        return _cols_to_rows(x, cols, self.mesh, self.axis)

    def take(self, x, want):
        return _take_rows(x, want.reshape(_size(self.mesh, self.axis), -1),
                          self.mesh, self.axis)

    def dtensor(self, local, dim: int = 0):
        """``local``, the rank's block along ``dim`` (its members), as a
        DTensor sharded so."""
        shape = list(local.shape)
        shape[dim] = self.n
        return _dtensor(local, self.mesh, self.axis, dim, shape)


def _member_view(x, mesh, axis_name, what: str):
    """The ``_Members`` of ``x`` on ``mesh``, or without one the
    ``_Whole`` of ``as_tensor(x)``."""
    if mesh is None:
        return _Whole(as_tensor(x))
    return _Members(x, mesh, axis_name, what)


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


def _all_to_all(t: torch.Tensor, send: list, recv: list, mesh,
                axis_name: str) -> torch.Tensor:
    """Uneven all-to-all along dim 0: the first ``send[0]`` rows of ``t``
    go to coordinate 0, the next ``send[1]`` to coordinate 1, and so on;
    returns the rows received, ``recv[c]`` from coordinate c, in axis
    order."""
    t = t.contiguous()
    out = t.new_empty((sum(recv),) + t.shape[1:])
    _note("all_to_all", out)
    dist.all_to_all_single(out, t, recv, send,
                           group=_group(mesh, axis_name))
    return out


def _take_rows(local: torch.Tensor, want: torch.Tensor, mesh,
               axis_name: str) -> torch.Tensor:
    """``full[want[c]]`` on coordinate c, where ``full`` is the row-sharded
    array whose block on this rank is ``local`` (every block has the same
    rows) and ``want`` (W, k) holds global row indices, the same on every
    rank. Only distinct rows that another rank holds move, each once to
    each rank that needs it, through one ``_all_to_all``; ``want`` is read
    to the host once. A resample's ancestors or a proposal's partners
    reach their rank this way, and the whole array is never gathered."""
    n_dev, me = _size(mesh, axis_name), _coord(mesh, axis_name)
    m = local.shape[0]
    want = want.cpu()
    # uniq[c]: the sorted distinct rows coordinate c wants; counts[c][s]:
    # how many of them coordinate s holds
    uniq = [torch.unique(w) for w in want]
    counts = [torch.bincount(u // m, minlength=n_dev).tolist()
              for u in uniq]
    send = [0 if c == me else counts[c][me] for c in range(n_dev)]
    recv = [0 if s == me else counts[me][s] for s in range(n_dev)]
    mine = uniq[me]
    owner = mine // m
    own = local[(mine[owner == me] - me * m).to(local.device)]
    if any(counts[c][s] for c in range(n_dev) for s in range(n_dev)
           if s != c):
        out = [uniq[c][uniq[c] // m == me] - me * m
               for c in range(n_dev) if c != me]
        got = _all_to_all(local[torch.cat(out).to(local.device)], send,
                          recv, mesh, axis_name)
        # the rows of ``mine`` in its order: the owners' blocks ascend
        pieces = list(torch.split(got, recv))
        pieces[me] = own
        own = torch.cat(pieces)
    return own[torch.searchsorted(mine, want[me]).to(local.device)]


def _rows_to_cols(local: torch.Tensor, mesh, axis_name: str):
    """A row-sharded (N, n) matrix, this rank's (N/W, n) block ``local``,
    as a column-sharded one: returns (the rank's columns of all N rows,
    (N, n_c), and the column counts of the ranks, which
    ``_cols_to_rows`` takes back). The columns are split as evenly as
    they go; each rank sends and receives (W - 1)/W of its block."""
    n_dev = _size(mesh, axis_name)
    m, n = local.shape
    cols = [n // n_dev + (c < n % n_dev) for c in range(n_dev)]
    me = _coord(mesh, axis_name)
    got = _all_to_all(local.mT, cols, [cols[me]] * n_dev, mesh, axis_name)
    # (W * n_c, m): coordinate s's rows of my columns, in axis order
    return got.reshape(n_dev, cols[me], m).permute(0, 2, 1).reshape(
        n_dev * m, cols[me]), cols


def _cols_to_rows(cols_block: torch.Tensor, cols: list, mesh,
                  axis_name: str) -> torch.Tensor:
    """The inverse of ``_rows_to_cols``: this rank's (N/W, n) rows from
    its (N, n_c) columns of all rows."""
    n_dev = _size(mesh, axis_name)
    me = _coord(mesh, axis_name)
    n_rows, n_c = cols_block.shape
    m = n_rows // n_dev
    # to coordinate c: my columns of its rows, as (n_c, m)
    blocks = cols_block.reshape(n_dev, m, n_c).permute(0, 2, 1)
    got = _all_to_all(blocks.reshape(n_dev * n_c, m), [n_c] * n_dev, cols,
                      mesh, axis_name)
    return got.mT.contiguous()
