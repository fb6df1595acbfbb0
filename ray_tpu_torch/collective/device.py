"""Device-plane collectives over the axes of a mesh: the counterpart of
``ray_tpu/collective/ici.py`` ("device-plane collectives").

The JAX module runs inside ``shard_map``, where an axis name stands for
the devices along it and XLA emits the collective. Here each rank holds
its local shard as a plain tensor, and an axis name (or a tuple of them)
resolves to the process group of that axis on a :class:`Mesh`
(``parallel.mesh``): the ``mesh=`` argument, else the mesh entered with
``with mesh:``. The backend is the group's: NCCL on the card, gloo on the
CPU. Where an axis is asked for, a process group may be given instead.

- name-stable wrappers (``allreduce``, ``allgather``, ``reducescatter``,
  ``all_to_all``, ``ppermute``, ``ring_shift``, ``broadcast``,
  ``barrier``, ``axis_index``, ``axis_size``), with the JAX semantics:
  out of place, ``broadcast`` returns root's value on every rank and
  ``barrier`` returns a value to thread through;
- compositions: the two-phase ``hierarchical_allreduce``, a
  reduced-precision wire (``allreduce_lowprec``), ``tree_allreduce`` and
  ``global_norm`` with one scalar collective;
- :class:`DeviceCollectiveGroup`, the group-object API.

Where JAX differentiates through a collective, so does the port:
``allreduce`` (sum and mean), ``allgather``, ``reducescatter``,
``all_to_all``, ``ppermute`` and ``ring_shift`` are autograd functions
whose backward is the transposed collective. The gradient of a
replicated value is then the sum over the ranks that used it, which is
what a step that averages parameter gradients over the data ranks
expects (``train.step``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import Mesh, current_mesh

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _mesh(mesh: Mesh | None) -> Mesh:
    return mesh if mesh is not None else current_mesh()


def _group(axis, mesh: Mesh | None) -> dist.ProcessGroup:
    """The process group of an axis name or a tuple of them on the mesh;
    a process group passes through (for callers that hold one)."""
    if isinstance(axis, dist.ProcessGroup):
        return axis
    return _mesh(mesh).group(axis)


def _size(group) -> int:
    return dist.get_world_size(group)


# ---------------------------------------------------------------------------
# raw collectives on one group (out of place, not differentiated)
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenation of every rank's ``x`` along ``dim``, in rank order."""
    n = _size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over ranks of ``x``, this rank's 1/n block along ``dim``."""
    n = _size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reducescatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide over {n} ranks")
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _all_to_all(x: torch.Tensor, group, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    """Block i of ``x`` along ``split_axis`` goes to rank i; the blocks
    received are concatenated along ``concat_axis`` in rank order (the
    tiled ``lax.all_to_all``)."""
    n = _size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of "
                         f"{tuple(x.shape)} does not split over {n} ranks")
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


def _permute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """``lax.ppermute``: for each ``(src, dst)`` of ``perm`` (indices in
    the group), rank src's ``x`` lands on rank dst; a rank that receives
    nothing gets zeros."""
    me = dist.get_rank(group)
    out = torch.zeros_like(x)
    x = x.contiguous()
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


# ---------------------------------------------------------------------------
# differentiable forms
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (_all_to_all(g.contiguous(), ctx.group, concat_axis,
                            split_axis), None, None, None)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(dst, src) for src, dst in ctx.perm]
        return _permute(g, ctx.group, inverse), None, None


# ---------------------------------------------------------------------------
# primitives (name-stable wrappers)
# ---------------------------------------------------------------------------

def allreduce(x: torch.Tensor, axis="dp", op: str = "sum",
              mesh: Mesh | None = None) -> torch.Tensor:
    """Allreduce over one axis name or a tuple of axis names; ``sum`` and
    ``mean`` are differentiable."""
    group = _group(axis, mesh)
    if op == "sum":
        return _AllReduceSum.apply(x, group)
    if op == "mean":
        return _AllReduceSum.apply(x, group) / _size(group)
    if op in _OPS:
        return _all_reduce(x, group, _OPS[op])
    raise ValueError(f"unsupported op {op!r}")


def allgather(x: torch.Tensor, axis: str = "dp", tiled: bool = False,
              mesh: Mesh | None = None) -> torch.Tensor:
    """Every rank's ``x``: stacked on a new leading axis, or with
    ``tiled`` concatenated along axis 0."""
    group = _group(axis, mesh)
    if tiled:
        return _AllGather.apply(x, group, 0)
    return _AllGather.apply(x.unsqueeze(0), group, 0)


def reducescatter(x: torch.Tensor, axis: str = "dp",
                  scatter_dimension: int = 0,
                  mesh: Mesh | None = None) -> torch.Tensor:
    """The sum over the axis, this rank's block of ``scatter_dimension``
    (``lax.psum_scatter(tiled=True)``)."""
    return _ReduceScatter.apply(x, _group(axis, mesh), scatter_dimension)


def all_to_all(x: torch.Tensor, axis: str = "sp", split_axis: int = 0,
               concat_axis: int = 0, mesh: Mesh | None = None
               ) -> torch.Tensor:
    """The tiled ``lax.all_to_all``: ``x`` split along ``split_axis``,
    block i to rank i, the blocks received concatenated along
    ``concat_axis``."""
    return _AllToAll.apply(x, _group(axis, mesh), split_axis, concat_axis)


def ppermute(x: torch.Tensor, axis: str, perm: list[tuple[int, int]],
             mesh: Mesh | None = None) -> torch.Tensor:
    return _Permute.apply(x, _group(axis, mesh),
                          tuple(tuple(p) for p in perm))


def ring_shift(x: torch.Tensor, axis: str, shift: int = 1,
               mesh: Mesh | None = None) -> torch.Tensor:
    """Rotate shards around the ring by ``shift``: rank i's ``x`` lands on
    rank i + shift (the ring-attention and pipeline building block)."""
    n = axis_size(axis, mesh)
    return ppermute(x, axis, [(i, (i + shift) % n) for i in range(n)], mesh)


def broadcast(x: torch.Tensor, axis: str, root: int = 0,
              mesh: Mesh | None = None) -> torch.Tensor:
    """Every rank gets ``root``'s value (``root`` indexes the axis)."""
    group = _group(axis, mesh)
    out = x.clone()
    dist.broadcast(out, dist.get_global_rank(group, root), group=group)
    return out


def barrier(axis, x: Any = None, mesh: Mesh | None = None):
    """Synchronization point with the JAX function's contract: it returns
    a value to consume. Without ``x``, the int32 count of the ranks on
    the axes (the collective's result); with ``x``, ``x`` (a tensor or a
    tree of them) made to depend on that result."""
    mesh = _mesh(mesh)
    token = _all_reduce(torch.ones((), dtype=torch.int32,
                                   device=mesh.device), mesh.group(axis))
    if x is None:
        return token
    return _tree_map(lambda a: torch.where(token > 0, a, torch.zeros_like(a)),
                     x)


def axis_index(axis, mesh: Mesh | None = None) -> int:
    return _mesh(mesh).axis_index(axis)


def axis_size(axis, mesh: Mesh | None = None) -> int:
    return _mesh(mesh).axis_size(axis)


# ---------------------------------------------------------------------------
# compositions
# ---------------------------------------------------------------------------

def hierarchical_allreduce(x: torch.Tensor, fast_axis: str, slow_axis: str,
                           scatter_dimension: int = 0,
                           mesh: Mesh | None = None) -> torch.Tensor:
    """Bandwidth-optimal allreduce over a fast × slow axis pair (NVLink
    within a node × the network across nodes): reduce-scatter over the
    fast axis, allreduce the 1/N shard over the slow axis, all-gather
    over the fast axis. The slow hop moves size/N bytes instead of size.
    Requires ``scatter_dimension`` divisible by the fast axis's size; the
    result equals ``allreduce(x, (fast_axis, slow_axis))``."""
    shard = reducescatter(x, fast_axis, scatter_dimension, mesh)
    shard = allreduce(shard, slow_axis, mesh=mesh)
    fast = _group(fast_axis, mesh)
    return _AllGather.apply(shard, fast, scatter_dimension)


def allreduce_lowprec(x: torch.Tensor, axis,
                      wire_dtype: torch.dtype = torch.bfloat16,
                      mesh: Mesh | None = None) -> torch.Tensor:
    """Allreduce with a reduced-precision wire: cast down, reduce, cast
    back to ``x``'s type. Halves the bytes of float32 operands at the
    cost of bf16 rounding: for gradients, never for optimizer state."""
    return allreduce(x.to(wire_dtype), axis, mesh=mesh).to(x.dtype)


def tree_allreduce(tree: Any, axis, op: str = "sum",
                   wire_dtype: torch.dtype | None = None,
                   mesh: Mesh | None = None) -> Any:
    """Allreduce every tensor of a tree (dicts, lists, tuples), one
    collective per leaf."""
    if wire_dtype is not None:
        if op not in ("sum", "mean"):
            raise ValueError(
                f"wire_dtype supports op 'sum'/'mean', not {op!r}")
        n = axis_size(axis, mesh)

        def reduce_leaf(g):
            out = allreduce_lowprec(g, axis, wire_dtype, mesh)
            return out / n if op == "mean" else out

        return _tree_map(reduce_leaf, tree)
    return _tree_map(lambda g: allreduce(g, axis, op, mesh), tree)


def global_norm(tree: Any, axis, mesh: Mesh | None = None) -> torch.Tensor:
    """L2 norm of a tree of shards with ONE scalar collective: the sum of
    the local squares, allreduced over ``axis``, then the square root (the
    gradient-clipping prologue of sharded training)."""
    leaves = [t for t in _leaves(tree) if t is not None]
    mesh = _mesh(mesh)
    local = (sum(torch.sum(torch.square(g.float())) for g in leaves)
             if leaves else torch.zeros((), device=mesh.device))
    return torch.sqrt(_all_reduce(local, mesh.group(axis)))


# ---------------------------------------------------------------------------
# group API
# ---------------------------------------------------------------------------

class DeviceCollectiveGroup:
    """Validated handle over a set of mesh axes (the counterpart of
    ``ray.util.collective``'s group object on the device plane): the axes
    are checked against the mesh when the group is made."""

    def __init__(self, mesh: Mesh, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        missing = [a for a in axes if a not in mesh.shape]
        if missing:
            raise ValueError(
                f"axes {missing} not in mesh {tuple(mesh.shape)}")
        self.mesh = mesh
        self.axes = axes

    @property
    def size(self) -> int:
        return self.mesh.axis_size(self.axes)

    def _one(self, name: str) -> str:
        if len(self.axes) != 1:
            raise ValueError(
                f"{name} needs a single-axis group, got {self.axes}")
        return self.axes[0]

    def allreduce(self, x, op: str = "sum"):
        return allreduce(x, self.axes, op, self.mesh)

    def allgather(self, x, tiled: bool = False):
        return allgather(x, self._one("allgather"), tiled, self.mesh)

    def reducescatter(self, x, scatter_dimension: int = 0):
        return reducescatter(x, self._one("reducescatter"),
                             scatter_dimension, self.mesh)

    def broadcast(self, x, root: int = 0):
        return broadcast(x, self._one("broadcast"), root, self.mesh)

    def barrier(self, x=None):
        return barrier(self.axes, x, self.mesh)

    def hierarchical_allreduce(self, x, scatter_dimension: int = 0):
        if len(self.axes) != 2:
            raise ValueError(
                "hierarchical_allreduce needs (fast, slow) axes, "
                f"got {self.axes}")
        fast, slow = self.axes
        return hierarchical_allreduce(x, fast, slow, scatter_dimension,
                                      self.mesh)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)
