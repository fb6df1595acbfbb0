"""Logical-axis sharding rules: the counterpart of
``ray_tpu/parallel/sharding.py``.

Models name the axes of their tensors with *logical* names ("batch",
"embed", "mlp", "heads", "seq", "vocab", "experts"); a rule table maps each
logical axis to a mesh axis. The JAX package turns that into a
``PartitionSpec`` for XLA's sharding propagation. The port turns it into
one DTensor placement per mesh dimension (:func:`logical_to_mesh`), and
:func:`place_params` applies it to a module:

- a parameter that the table splits over ``tp`` or ``ep`` is cut to this
  rank's block along that dimension (a plain tensor); the model's layers
  run on those blocks with explicit collectives (Megatron's column and
  row products, the vocab-parallel embedding and cross-entropy, the
  experts of this rank);
- a parameter that the table shards over ``fsdp`` is sharded by FSDP2
  (``fully_shard``, per block and on the whole model) along the tensor
  dimension the table names, so ``wte.weight`` ``[vocab, embed]`` is
  split on ``embed`` as the JAX package splits it; where ``tp`` splits it
  too, FSDP2 shards this rank's ``tp`` block;
- every other parameter is replicated.

Each parameter's :class:`Placement` (``model.placements[name]``, and
``param.placement``) records which mesh axes split it and which hold
equal copies of it; the train step, ``load_jax_params`` and the
checkpoint read it. ``pp`` is not in
the table: a pipeline's stages are placed by ``parallel.pipeline``.

The JAX pattern table matches flax paths and layouts; the port's
(:data:`DEFAULT_PARAM_PATTERNS`) matches its own ``named_parameters()``
names and layouts: ``nn.Linear.weight`` is ``[out, in]``, the transpose of
flax's ``Dense`` kernel, so the port's ``mlp.fc.weight`` is ``("mlp",
"embed")`` where flax's kernel is ``("embed", "mlp")``; a convolution's
weight is OIHW where flax's is HWIO. Each rule gives a parameter the mesh
axes JAX's table gives its flax counterpart.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from ray_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_EP,
    AXIS_FSDP,
    AXIS_SP,
    AXIS_TP,
    DATA_AXES,
)


@dataclass
class LogicalAxisRules:
    """Ordered map logical-axis -> mesh axes (empty = replicated).

    A logical axis may list several mesh axes in preference order; the
    first one present in the mesh with size > 1 is used.
    """

    rules: dict[str, tuple[str, ...]] = field(default_factory=dict)

    def mesh_axis(self, logical: str, mesh) -> str | None:
        for candidate in self.rules.get(logical, ()):  # pref order
            if candidate in mesh.shape and mesh.shape[candidate] > 1:
                return candidate
        return None


DEFAULT_RULES = LogicalAxisRules(rules={
    # activations
    "batch": (AXIS_DP, AXIS_FSDP),
    "seq": (AXIS_SP,),
    "act_embed": (AXIS_TP,),
    # params
    "embed": (AXIS_FSDP,),
    "mlp": (AXIS_TP,),
    "heads": (AXIS_TP,),
    "kv": (),
    "vocab": (AXIS_TP,),
    "experts": (AXIS_EP,),
    # conv / vision
    "conv_out": (AXIS_TP,),
    "conv_in": (),
})


def mesh_axes(logical_axes: tuple[str | None, ...], mesh,
              rules: LogicalAxisRules = DEFAULT_RULES
              ) -> tuple[str | None, ...]:
    """The mesh axis of each tensor dimension (None = not split), the
    entries of the JAX package's ``PartitionSpec`` with trailing Nones
    dropped. A mesh axis shards one dimension only: a later dimension that
    asks for an axis already used is not split. ``mesh`` is anything with
    a ``shape`` dict."""
    used: set[str] = set()
    out: list[str | None] = []
    for name in logical_axes:
        axis = rules.mesh_axis(name, mesh) if name else None
        if axis is not None and axis not in used:
            used.add(axis)
            out.append(axis)
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def logical_to_mesh(logical_axes: tuple[str | None, ...], mesh,
                    rules: LogicalAxisRules = DEFAULT_RULES) -> tuple:
    """One DTensor placement per mesh dimension, in the mesh's order:
    ``Shard(d)`` for the mesh axis that splits tensor dimension ``d``,
    ``Replicate()`` for the others."""
    axes = mesh_axes(logical_axes, mesh, rules)
    return tuple(Shard(axes.index(a)) if a in axes else Replicate()
                 for a in mesh.shape)


def constrain(x: torch.Tensor, mesh, *logical_axes,
              rules: LogicalAxisRules = DEFAULT_RULES) -> torch.Tensor:
    """The JAX function is a sharding hint inside ``jit``. The port's
    tensors are already local shards, split by ``shard_batch`` and the
    collectives, so there is nothing to move: this returns ``x``. It
    checks that ``x`` has a dimension for each logical axis named and
    that each dimension a mesh axis splits is a whole, non-empty local
    block; ValueError otherwise."""
    axes = mesh_axes(logical_axes, mesh, rules)
    if len(logical_axes) > x.dim():
        raise ValueError(f"{len(logical_axes)} logical axes for a tensor of "
                         f"rank {x.dim()}")
    for dim, axis in enumerate(axes):
        if axis is not None and x.shape[dim] < 1:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} holds no "
                             f"element of its {axis} block")
    return x


# --------------------------------------------------------------------------
# Parameter sharding by name pattern
# --------------------------------------------------------------------------

# Regex over the port's parameter name -> logical axes per dimension of
# the port's layout. Matched FIRST wins. Each row gives a parameter the
# mesh axes that ``ray_tpu.parallel.sharding.DEFAULT_PARAM_PATTERNS``
# gives its flax counterpart (loaded by the model's ``load_jax_params``),
# including where the JAX table replicates a kernel that it matches by a
# later, generic rule (ViT's q, k, v, proj and fc kernels, whose flax
# paths carry neither "attn" nor "mlp").
DEFAULT_PARAM_PATTERNS: list[tuple[str, tuple[str | None, ...]]] = [
    (r"(^|\.)pos_embed$", (None, None, "embed")),    # ViT [1, P, E]
    (r"(^|\.)wpe\.weight$", (None, "embed")),
    (r"(^|\.)wte\.weight$", ("vocab", "embed")),
    # MoE experts: the expert dim -> ep
    (r"moe\.router$", ("embed", None)),
    (r"moe\.w_up$", ("experts", "embed", "mlp")),
    (r"moe\.w_down$", ("experts", "mlp", "embed")),
    # GPT-2's head-structured projections keep the flax layout.
    (r"attn\.qkv_kernel$", ("embed", None, "heads", None)),
    (r"attn\.qkv_bias$", (None, "heads", None)),
    (r"attn\.proj_kernel$", ("heads", None, "embed")),
    # nn.Linear weights are [out, in]: flax's (in, out) axes reversed.
    (r"attn\.(q|k|v)\.weight$", ("heads", "embed")),
    (r"attn\.proj\.weight$", ("embed", "heads")),
    (r"mlp\.(fc|up|gate)\.weight$", ("mlp", "embed")),
    (r"mlp\.(down|proj)\.weight$", ("embed", "mlp")),
    (r"mlp_proj\.weight$", ("embed", "mlp")),        # ViT's second dense
    (r"lm_head\.weight$", ("vocab", "embed")),
    # convolutions, OIHW (flax: HWIO)
    (r"conv[^.]*\.weight$", ("conv_out", "conv_in", None, None)),
    # norms, biases, scales, the rest: replicated
    (r".*", ()),
]


def logical_axes_for(name: str, ndim: int, patterns=None
                     ) -> tuple[str | None, ...]:
    """The logical axes the first matching pattern gives parameter
    ``name``; ``()`` (replicated) when its rank differs from the rule's."""
    for pattern, logical in patterns or DEFAULT_PARAM_PATTERNS:
        if re.search(pattern, name):
            return logical if len(logical) == ndim else ()
    return ()


def spec_for_path(name: str, ndim: int, mesh, patterns=None,
                  rules: LogicalAxisRules = DEFAULT_RULES) -> tuple:
    """The placements (:func:`logical_to_mesh`) of parameter ``name``."""
    return logical_to_mesh(logical_axes_for(name, ndim, patterns), mesh,
                           rules)


def shard_params(model: nn.Module, mesh, patterns=None,
                 rules: LogicalAxisRules = DEFAULT_RULES) -> dict:
    """``{parameter name: placements}`` for every parameter of ``model``."""
    return {name: spec_for_path(name, p.dim(), mesh, patterns, rules)
            for name, p in model.named_parameters()}


# The mesh axes whose splits the port carries out by cutting the tensor.
_CUT_AXES = (AXIS_TP, AXIS_EP)


@dataclass(frozen=True)
class Placement:
    """Where one parameter lives on a mesh.

    ``split``: ``(dim, axis, index, size)`` for each mesh axis that cuts
    the tensor (this rank holds block ``index`` of ``size`` along
    ``dim``); ``fsdp``: the dimension FSDP2 shards, or None;
    ``replicated``: the axes of more than one rank that hold equal
    copies."""

    split: tuple[tuple[int, str, int, int], ...] = ()
    fsdp: int | None = None
    replicated: tuple[str, ...] = ()

    @property
    def split_axes(self) -> tuple[str, ...]:
        return tuple(axis for _, axis, _, _ in self.split)

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``full``."""
        for dim, _, index, size in self.split:
            n = full.shape[dim] // size
            full = full.narrow(dim, index * n, n)
        return full

    def whole_shape(self, local_shape) -> tuple[int, ...]:
        shape = list(local_shape)
        for dim, _, _, size in self.split:
            shape[dim] *= size
        return tuple(shape)


@dataclass(frozen=True)
class Split:
    """The ranks of a mesh over which a layer's weights are cut: the
    layer runs its collectives over ``mesh.group(axes)``."""

    mesh: object
    axes: tuple[str, ...]

    @property
    def group(self):
        return self.mesh.group(self.axes)

    @property
    def index(self) -> int:
        return self.mesh.axis_index(self.axes)

    @property
    def size(self) -> int:
        return self.mesh.axis_size(self.axes)


@dataclass
class _Shape:
    """A mesh as the rule functions read it: its ``shape`` alone."""
    shape: dict[str, int]


def _blocks(model: nn.Module) -> list[nn.Module]:
    """The model's repeated blocks, each its own FSDP2 group: the ``h``
    list of the transformers, the named blocks of ResNet."""
    if isinstance(getattr(model, "h", None), nn.ModuleList):
        return list(model.h)
    return [getattr(model, n) for n in getattr(model, "block_names", ())]


def _fsdp_mesh(mesh):
    """The DeviceMesh FSDP2 shards over: the ``fsdp`` axis alone, or,
    when the other data axes (``dp``, ``sp``) hold more than one rank,
    those ranks as a leading replicate dimension (HSDP), so that FSDP2's
    gradient reduction spans every data rank. The ranks along ``tp``,
    ``ep`` and ``pp``, which hold other blocks of a parameter, are
    separate meshes."""
    from torch.distributed.device_mesh import DeviceMesh

    f = mesh.shape[AXIS_FSDP]
    names = tuple(mesh.shape)
    rep = [a for a in DATA_AXES if a != AXIS_FSDP]
    n_rep = mesh.axis_size(rep)
    if n_rep == 1 and f == mesh.size:
        return mesh.device_mesh[AXIS_FSDP]
    other = [i for i, a in enumerate(names) if a not in DATA_AXES]
    dims = other + [names.index(a) for a in rep] + [names.index(AXIS_FSDP)]
    grid = torch.arange(mesh.size).reshape(tuple(mesh.shape.values())) \
        .permute(*dims).reshape(mesh.size // (n_rep * f), n_rep, f)
    dm = DeviceMesh(mesh.device.type, grid,
                    mesh_dim_names=("model", "replicate", AXIS_FSDP))
    return dm["replicate", AXIS_FSDP] if n_rep > 1 else dm[AXIS_FSDP]


def place_params(model: nn.Module, mesh, patterns=None,
                 rules: LogicalAxisRules = DEFAULT_RULES) -> nn.Module:
    """Place ``model``'s parameters on ``mesh`` by the rule table, in place,
    and return it.

    Every parameter and buffer is first broadcast from rank 0, so that
    replicas start equal. A parameter the table splits over ``tp`` or
    ``ep`` is then cut to this rank's block, and every layer that declares
    a ``tp`` or ``ep`` attribute gets the :class:`Split` it runs its
    collectives over; a model that does not declare ``tensor_parallel``
    raises NotImplementedError for a cut over ``tp`` (ViT and ResNet,
    ROADMAP §1). Where the ``fsdp`` axis holds more than one rank, the
    parameters that the table shards over it are then sharded by FSDP2
    along that dimension: ``fully_shard`` on each block and on the model,
    with ``shard_placement_fn`` from the table and the other parameters
    left to the train step (``ignored_params``). Each parameter's
    :class:`Placement` goes to ``model.placements``. A placed model is
    returned as it is."""
    return _place(model, mesh, patterns, rules, ())


def _place_forced(model: nn.Module, mesh, axes, patterns=None,
                  rules: LogicalAxisRules = DEFAULT_RULES) -> nn.Module:
    """:func:`place_params` that places over each of ``axes`` whatever
    its size: on a size-1 axis it does what the table would do were the
    axis larger (FSDP2 shards, a ``tp`` or ``ep`` route whose collectives
    run over one rank). For checks that hold such a route's step against
    the plain one on one card."""
    return _place(model, mesh, patterns, rules, tuple(axes))


def _place(model: nn.Module, mesh, patterns, rules, forced) -> nn.Module:
    if getattr(model, "placements", None) is not None:
        return model
    table_mesh = _Shape({**mesh.shape, **{a: 2 for a in forced
                                          if mesh.shape[a] == 1}})
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if mesh.size > 1:
                dist.broadcast(t.data, 0)
    placements = {}
    for name, p in model.named_parameters():
        axes = mesh_axes(logical_axes_for(name, p.dim(), patterns),
                         table_mesh, rules)
        split = tuple((dim, a, mesh.axis_index(a), mesh.shape[a])
                      for dim, a in enumerate(axes) if a in _CUT_AXES)
        if split and AXIS_TP in axes and not getattr(
                model, "tensor_parallel", False):
            raise NotImplementedError(
                f"{type(model).__name__} under tp: {name} would be split "
                f"over {AXIS_TP}, and its layers have no tensor-parallel "
                "route in the port yet (ROADMAP §1)")
        fsdp = (axes.index(AXIS_FSDP) if AXIS_FSDP in axes
                and (mesh.shape[AXIS_FSDP] > 1 or AXIS_FSDP in forced)
                else None)
        cut = {a for _, a, _, _ in split}
        placements[name] = Placement(
            split=split, fsdp=fsdp,
            replicated=tuple(a for a, n in mesh.shape.items()
                             if n > 1 and a not in cut
                             and not (a == AXIS_FSDP and fsdp is not None)))
        if split:
            with torch.no_grad():
                p.data = placements[name].block(p.data).clone()
        p.placement = placements[name]
    for axis in _CUT_AXES:
        if any(axis in pl.split_axes for pl in placements.values()):
            for m in model.modules():
                if hasattr(type(m), axis):
                    setattr(m, axis, Split(mesh, (axis,)))
    model.placements = placements
    if all(pl.fsdp is None for pl in placements.values()):
        return model
    from torch.distributed.fsdp import fully_shard

    fsdp_mesh = _fsdp_mesh(mesh)
    names = {id(p): n for n, p in model.named_parameters()}
    ignored = {p for p in model.parameters()
               if placements[names[id(p)]].fsdp is None}

    def placement(p: nn.Parameter):
        return Shard(placements[names[id(p)]].fsdp)

    for block in _blocks(model):
        fully_shard(block, mesh=fsdp_mesh, shard_placement_fn=placement,
                    ignored_params={p for p in block.parameters()
                                    if p in ignored})
    fully_shard(model, mesh=fsdp_mesh, shard_placement_fn=placement,
                ignored_params=ignored)
    return model


def is_sharded(p: torch.Tensor) -> bool:
    """True for a parameter or gradient that FSDP2 holds as a DTensor."""
    from torch.distributed.tensor import DTensor
    return isinstance(p, DTensor)


def local(t: torch.Tensor | None) -> torch.Tensor | None:
    """A DTensor's local shard (a view of its storage), any other tensor,
    or None, itself."""
    return t.to_local() if is_sharded(t) else t
