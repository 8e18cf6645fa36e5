"""Shared collectives vocabulary: the rank grid, axis resolution and the
reductions over its process groups (counterpart of
``repro.dist.collectives``).

The reference phrases its collectives inside ``shard_map`` bodies over a
jax device mesh.  Here every process is one rank of a ``torch.distributed``
process group and runs the body on its own blocks, so the mesh is the grid
of ranks: :func:`make_mesh` lays the world out row-major over named axes
and makes one process group per row axis set, per column axis and for the
whole grid (a group that spans the whole world is the default group); the
reductions are functions on tensors that call ``all_reduce``,
``reduce_scatter`` and ``all_gather`` on an axis's group.

Conventions (the reference's):

  * ``"model"`` is always the *column* axis of the CP-ALS grid;
  * every other axis, ``("data",)`` or ``("pod", "data")``, is a *row*
    axis: the pod axis joins the row partition.

A rank's coordinate on an axis set (``shard_map``'s ``axis_index``) is its
row-major index over those axes; ``torch.distributed.new_group`` sorts a
group's ranks, so the group rank IS that coordinate, and a reduce-scatter
over ``(row, col)`` leaves block ``r * n_col + c`` on rank ``(r, c)``, the
reference's layout.

The grid made by :func:`make_mesh` also holds its
``torch.distributed.device_mesh.DeviceMesh``: the same axis names in the
same row-major layout on the same world, so DTensor placements
(``repro_torch.launch.mesh``) and these reductions name one grid.

One card holds one NCCL rank (NCCL refuses two ranks on one GPU): a grid
of several ranks runs on the CPU with gloo, or on as many cards.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Mapping, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

AxisName = Union[str, tuple]

MODEL_AXIS = "model"
DATA_AXIS = "data"
POD_AXIS = "pod"


# ---------------------------------------------------------------------------
# the rank grid
# ---------------------------------------------------------------------------

def _as_axes(axes: AxisName) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The rank grid: ``axis_names`` over ``sizes``, this process's
    ``rank`` in it, the ``device`` its blocks live on, the process group
    of each axis set and the ``DeviceMesh`` that :func:`make_mesh` made
    (neither for a grid built by hand for the host-side axis rules)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    rank: int = 0
    device: torch.device = torch.device("cpu")
    groups: Mapping[tuple[str, ...], object] = dataclasses.field(
        default_factory=dict)
    device_mesh: object = None

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> extent, in mesh order (``jax`` mesh ``shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    def _key(self, axes: AxisName) -> tuple[str, ...]:
        names = set(_as_axes(axes))
        unknown = names - set(self.axis_names)
        if unknown:
            raise ValueError(f"mesh {self.axis_names} has no axes "
                             f"{sorted(unknown)}")
        return tuple(a for a in self.axis_names if a in names)

    def coords(self) -> dict[str, int]:
        """Axis name -> this rank's coordinate, row-major over
        ``axis_names``."""
        idx = np.unravel_index(self.rank, self.sizes)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def axis_index(self, axes: AxisName) -> int:
        """This rank's row-major index over ``axes``: ``shard_map``'s
        ``axis_index``."""
        key = self._key(axes)
        c = self.coords()
        return int(np.ravel_multi_index(
            tuple(c[a] for a in key), tuple(self.shape[a] for a in key))) \
            if key else 0

    def axis_size(self, axes: AxisName) -> int:
        """Number of ranks along ``axes``."""
        return math.prod(self.shape[a] for a in self._key(axes))

    def group(self, axes: AxisName):
        """The process group of this rank's peers along ``axes``."""
        key = self._key(axes)
        try:
            return self.groups[key]
        except KeyError:
            raise ValueError(
                f"mesh has no process group over {key}; make_mesh builds "
                f"{sorted(self.groups)}") from None


def _group_keys(axes: tuple[str, ...]) -> list[tuple[str, ...]]:
    """The axis sets that get a process group: the row axes, the column
    axis, and the whole grid."""
    row = tuple(a for a in axes if a != MODEL_AXIS)
    keys = [row, (MODEL_AXIS,) if MODEL_AXIS in axes else (), axes]
    out = []
    for k in keys:
        if k and k not in out:
            out.append(k)
    return out


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device=None) -> Mesh:
    """The rank grid of ``shape`` over ``axes`` on the current process
    group (whose world size must be the grid's size), with one process
    group per axis set every CP-ALS reduction uses.  Every rank calls
    ``new_group`` for every group, in the same order, including groups it
    is not in, as ``torch.distributed`` requires.

    ``device``: where this rank's blocks live; by default the card of
    ``LOCAL_RANK`` under NCCL, the CPU otherwise."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed process "
                           "group: init_process_group first (see "
                           "init_process_group_for)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} has "
                         f"{math.prod(shape)} ranks, the process group "
                         f"{world}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    grid = np.arange(world).reshape(shape)
    groups = {}
    for key in _group_keys(axes):
        # the axes outside the key index the groups; each group's ranks
        # run over the key's axes, row-major
        inner = [axes.index(a) for a in key]
        outer = [i for i in range(len(axes)) if i not in inner]
        blocks = np.transpose(grid, outer + inner).reshape(
            -1, math.prod(shape[i] for i in inner))
        if blocks.shape[0] == 1:
            # the group is the whole world: its default group, so no
            # second communicator is set up (every rank decides the same)
            groups[key] = dist.group.WORLD
            continue
        for ranks in blocks:
            g = dist.new_group(ranks=[int(r) for r in ranks])
            if dist.get_rank() in ranks:
                groups[key] = g
    device = torch.device(device)
    from torch.distributed.device_mesh import DeviceMesh

    dmesh = DeviceMesh(device.type, torch.as_tensor(grid),
                       mesh_dim_names=axes)
    return Mesh(axis_names=axes, sizes=shape, rank=dist.get_rank(),
                device=device, groups=groups, device_mesh=dmesh)


def init_process_group_for(device: torch.device) -> bool:
    """Make sure a process group exists for a run on ``device``: the one
    that exists; else, under ``torchrun`` (``WORLD_SIZE`` and
    ``MASTER_ADDR`` set), one from the environment; else a one-rank group.
    NCCL for a CUDA device (its rank on ``cuda:LOCAL_RANK``), gloo for the
    CPU.  A CUDA run on a group of another backend, or where NCCL cannot
    start, raises.  Returns whether this call started the group."""
    want = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        have = dist.get_backend()
        if device.type == "cuda" and have != "nccl":
            raise RuntimeError(
                f"a CUDA run needs an NCCL process group; the one that "
                f"exists is {have!r}")
        return False
    kw = {}
    if device.type == "cuda":
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)
        # bound to its card, NCCL sets its communicators up here, not at
        # the first collective of the fit
        kw["device_id"] = local
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(want, init_method="env://", **kw)
    else:
        # one rank: an in-process store, so no port is ever bound
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    return True


# ---------------------------------------------------------------------------
# host-side axis resolution
# ---------------------------------------------------------------------------

def axis_product(mesh: Mesh, axes: Sequence[str]) -> int:
    """Number of ranks along ``axes`` (product of mesh extents)."""
    return int(np.prod([mesh.shape[a] for a in axes], dtype=np.int64)) \
        if axes else 1


def batch_axes(multi_pod: bool = False) -> AxisName:
    """The pod-aware batch/data-parallel rule: across pods the batch is
    purely data-parallel, so the pod axis prepends the data axis."""
    return (POD_AXIS, DATA_AXIS) if multi_pod else DATA_AXIS


@dataclasses.dataclass(frozen=True)
class CPAxes:
    """Resolved CP-ALS grid axes for a mesh.

    ``row`` partitions mode-0 factor rows (and the non-zero blocks' first
    grid dim); ``col`` partitions mode-1; ``all_axes`` is the whole grid
    (mode-2 reduce scope).  The ``*_spec()`` helpers phrase the matching
    :func:`shard_map` specs."""

    row: tuple
    col: str
    n_row: int
    n_col: int

    @property
    def all_axes(self) -> tuple:
        return self.row + (self.col,)

    @property
    def n_all(self) -> int:
        return self.n_row * self.n_col

    def grid_spec(self) -> tuple:
        """Spec of the (n_row, n_col, ...) partitioned non-zero blocks."""
        return (self.row, self.col)

    def row_spec(self) -> tuple:
        return (self.row,)

    def col_spec(self) -> tuple:
        return (self.col,)

    def all_spec(self) -> tuple:
        return (self.all_axes,)


def cpals_axes(mesh: Mesh) -> CPAxes:
    """Resolve the CP-ALS row/column axes of ``mesh``: ``"model"`` is the
    column axis, everything else (``data``, optionally led by ``pod``)
    partitions rows."""
    if MODEL_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no {MODEL_AXIS!r} axis")
    row = tuple(a for a in mesh.axis_names if a != MODEL_AXIS)
    return CPAxes(row=row, col=MODEL_AXIS,
                  n_row=axis_product(mesh, row),
                  n_col=mesh.shape[MODEL_AXIS])


# ---------------------------------------------------------------------------
# shard_map: a body on this rank's blocks of global arrays
# ---------------------------------------------------------------------------

def _block(x: torch.Tensor, mesh: Mesh, spec: tuple) -> torch.Tensor:
    for dim, axes in enumerate(spec):
        if axes is None or axes == ():
            continue
        size = x.shape[dim] // mesh.axis_size(axes)
        x = x.narrow(dim, mesh.axis_index(axes) * size, size)
    return x


def placements(mesh: Mesh, spec: tuple) -> tuple:
    """The DTensor placements of a spec on ``mesh``'s ``DeviceMesh``, one a
    mesh axis: ``Shard(d)`` on every axis that dim ``d``'s entry names
    (a name or a tuple of names, or None), ``Replicate()`` elsewhere.  A
    dim split over several axes is split in mesh order, outermost first,
    as DTensor splits it (JAX's pod-major order for ``("pod", "data")``);
    another order raises."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.axis_names)
    for dim, entry in enumerate(spec):
        if entry is None or entry == ():
            continue
        axes = _as_axes(entry)
        idx = [mesh.axis_names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} splits dim {dim} out of "
                             f"the mesh's order {mesh.axis_names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec} uses mesh axis "
                                 f"{mesh.axis_names[i]!r} twice")
            out[i] = Shard(dim)
    return tuple(out)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _local(x, mesh: Mesh, spec: tuple) -> torch.Tensor:
    """This rank's block of the DTensor ``x`` under ``spec``: ``x``
    redistributed to the spec's placements, its local shard.  The gradient
    of the block is a partial sum over the axes the spec leaves out (each
    rank's body used the whole of ``x`` there), as the transpose of a
    ``shard_map`` input sums over them."""
    from torch.distributed.tensor import Partial, Replicate

    pl = placements(mesh, spec)
    grad = tuple(Partial() if p == Replicate() else p for p in pl)
    return x.redistribute(mesh.device_mesh, pl).to_local(grad_placements=grad)


def shard_map(f: Callable, *, mesh: Mesh, in_specs, out_specs) -> Callable:
    """``f`` run on this rank's blocks: each input is cut along every dim
    its spec names axes for (``()`` or None: replicated), ``f`` runs on
    the blocks, and each output is all-gathered back along the dims its
    spec names.  Every rank must call the result, as every device runs a
    ``shard_map`` body; outputs come back as the global arrays.

    When an input is a DTensor (on ``mesh.device_mesh``), the blocks are
    the DTensors' local shards, redistributed to the specs' placements
    (nothing is gathered), gradients flow through the boundary as through
    the reference's ``shard_map``, and each output comes back as the
    DTensor its spec places, on the shards the body made.  A plain input
    there is a global tensor every rank holds."""

    def mapped(*args):
        if any(_is_dtensor(x) for x in args):
            return _mapped_dtensor(f, mesh, in_specs, out_specs, args)
        blocks = [_block(x, mesh, spec) for x, spec in zip(args, in_specs)]
        outs = f(*blocks)
        single = not isinstance(outs, tuple)
        outs = (outs,) if single else outs
        specs = (out_specs,) if single else out_specs
        full = []
        for y, spec in zip(outs, specs):
            for dim in reversed(range(len(spec))):
                if spec[dim] is not None and spec[dim] != ():
                    y = _all_gather_dim(y, mesh, spec[dim], dim)
            full.append(y)
        return full[0] if single else tuple(full)

    return mapped


def _mapped_dtensor(f, mesh: Mesh, in_specs, out_specs, args):
    from torch.distributed.tensor import DTensor

    if mesh.device_mesh is None:
        raise ValueError("shard_map over DTensors needs a mesh from "
                         "make_mesh (it holds the DeviceMesh)")
    blocks = [_local(x, mesh, spec) if _is_dtensor(x)
              else _block(x, mesh, spec)
              for x, spec in zip(args, in_specs)]
    outs = f(*blocks)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    specs = (out_specs,) if single else out_specs
    placed = tuple(DTensor.from_local(y, mesh.device_mesh,
                                      placements(mesh, spec))
                   for y, spec in zip(outs, specs))
    return placed[0] if single else placed


# ---------------------------------------------------------------------------
# the reductions, on an axis's process group
# ---------------------------------------------------------------------------

def _reduce_scatter(out: torch.Tensor, x: torch.Tensor, group) -> None:
    # torch >= 2.13 names it reduce_scatter_single (reduce_scatter_tensor
    # warns there); earlier releases have only the older name
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, x, group=group)


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _all_gather_dim(x: torch.Tensor, mesh: Mesh, axes: AxisName,
                    dim: int) -> torch.Tensor:
    x = x.movedim(dim, 0).contiguous()
    x = gather_rows(x, mesh, (axes,))
    return x.movedim(0, dim).contiguous()


def psum(x: torch.Tensor, mesh: Mesh, axes: AxisName) -> torch.Tensor:
    """Sum of ``x`` over the ranks along ``axes`` (in place: pass a tensor
    of its own)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group(axes))
    return x


def pmax(x: torch.Tensor, mesh: Mesh, axes: AxisName) -> torch.Tensor:
    """Elementwise max of ``x`` over the ranks along ``axes`` (in place)."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group(axes))
    return x


def pgram(mat: torch.Tensor, mesh: Mesh, axes: AxisName) -> torch.Tensor:
    """Gram matrix of a row-sharded factor: the sum of the local A^T A."""
    return psum(mat.T @ mat, mesh, axes)


def pnormalize_columns(mat: torch.Tensor, mesh: Mesh, axes: AxisName, *,
                       kind: str = "2"):
    """Column-normalize a row-sharded matrix; returns ``(mat, lam)``.

    ``kind="2"``: lam = global column 2-norms (sum of squares over the
    ranks); ``kind="max"``: lam = max(1, global column max-abs), SPLATT's
    first-iteration norm.  Zero columns are left untouched (unit lam)."""
    if kind == "max":
        lam = pmax(torch.amax(torch.abs(mat), dim=0), mesh, axes)
        lam = torch.clamp(lam, min=1.0)
    else:
        lam = torch.sqrt(psum(torch.sum(mat * mat, dim=0), mesh, axes))
    safe = torch.where(lam == 0.0, torch.ones_like(lam), lam)
    return mat / safe[None, :], lam


def scatter_rows(x: torch.Tensor, mesh: Mesh,
                 axes: Sequence[AxisName]) -> torch.Tensor:
    """Reduce-scatter ``x`` along dim 0 over each axis group in order:
    half the wire of psum + slice.  Block layout after scattering over
    ``(row, col)`` is row-major in the grid (block id = r * n_col + c)."""
    for a in axes:
        g = mesh.group(a)
        n = dist.get_world_size(g)
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        _reduce_scatter(out, x.contiguous(), g)
        x = out
    return x


def gather_rows(x: torch.Tensor, mesh: Mesh,
                axes: Sequence[AxisName]) -> torch.Tensor:
    """Inverse of :func:`scatter_rows`: all-gather dim 0 over the same
    axis groups, applied in reverse order so the row-major block layout
    is reassembled exactly."""
    for a in reversed(tuple(axes)):
        g = mesh.group(a)
        n = dist.get_world_size(g)
        out = x.new_empty((x.shape[0] * n,) + tuple(x.shape[1:]))
        _all_gather(out, x.contiguous(), g)
        x = out
    return x
