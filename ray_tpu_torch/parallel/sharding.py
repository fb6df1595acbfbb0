"""Logical-axis sharding rules: the counterpart of
``ray_tpu/parallel/sharding.py``.

Models name the axes of their tensors with *logical* names ("batch",
"embed", "mlp", "heads", "seq", "vocab", "experts"); a rule table maps each
logical axis to a mesh axis. The JAX package turns that into a
``PartitionSpec`` for XLA's sharding propagation. The port turns it into
one DTensor placement per mesh dimension (:func:`logical_to_mesh`), and
:func:`place_params` applies it to a module:

- a parameter that the table shards over ``fsdp`` is sharded by FSDP2
  (``fully_shard``, per block and on the whole model) along the tensor
  dimension the table names, so ``wte.weight`` ``[vocab, embed]`` is
  split on ``embed`` as the JAX package splits it;
- every other parameter is replicated: broadcast from rank 0 at
  placement, its gradient averaged over every rank by the train step
  (``train.step``).

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
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
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
    when other axes hold more than one rank, those ranks as a leading
    replicate dimension (HSDP), so that FSDP2's gradient reduction spans
    every rank."""
    from torch.distributed.device_mesh import DeviceMesh

    f = mesh.shape[AXIS_FSDP]
    if f == mesh.size:
        return mesh.device_mesh[AXIS_FSDP]
    names = tuple(mesh.shape)
    grid = torch.arange(mesh.size).reshape(tuple(mesh.shape.values()))
    dim = names.index(AXIS_FSDP)
    rest = [i for i in range(len(names)) if i != dim]
    grid = grid.permute(*rest, dim).reshape(mesh.size // f, f)
    return DeviceMesh(mesh.device.type, grid,
                      mesh_dim_names=("replicate", AXIS_FSDP))


def place_params(model: nn.Module, mesh, patterns=None,
                 rules: LogicalAxisRules = DEFAULT_RULES) -> nn.Module:
    """Place ``model``'s parameters on ``mesh`` by the rule table, in place,
    and return it.

    Every parameter and buffer is first broadcast from rank 0, so that
    replicas start equal. Where the ``fsdp`` axis holds more than one
    rank, the parameters that the table shards over it are then sharded by
    FSDP2 along that dimension: ``fully_shard`` on each block and on the
    model, with ``shard_placement_fn`` from the table and the other
    parameters left to the train step (``ignored_params``). A model whose
    parameters FSDP2 already holds is returned as it is. Tensor, expert
    and pipeline placements of parameters are not in the port yet
    (ROADMAP §1): a table entry that would split a parameter over ``tp``,
    ``ep`` or ``pp`` raises NotImplementedError."""
    return _place(model, mesh, patterns, rules,
                  fsdp2=mesh.shape.get(AXIS_FSDP, 1) > 1)


def _place_fsdp2(model: nn.Module, mesh, patterns=None,
                 rules: LogicalAxisRules = DEFAULT_RULES) -> nn.Module:
    """:func:`place_params` with FSDP2 on whatever the size of the
    ``fsdp`` axis: on a size-1 axis it splits the dimension the table
    would put on ``fsdp`` were it larger. For checks that hold FSDP2's
    step against plain data parallelism on one card or beside ``dp``."""
    return _place(model, mesh, patterns, rules, fsdp2=True,
                  table_mesh=_Shape({**mesh.shape, AXIS_FSDP: 2}))


def _place(model: nn.Module, mesh, patterns, rules, fsdp2: bool,
           table_mesh=None) -> nn.Module:
    if any(is_sharded(p) for p in model.parameters()):
        return model
    for axis in (AXIS_TP, AXIS_PP):
        if mesh.shape.get(axis, 1) > 1:
            raise NotImplementedError(
                f"a mesh with {axis}={mesh.shape[axis]} is not in the port "
                "yet (ROADMAP §1)")
    names = {id(p): n for n, p in model.named_parameters()}
    spec = {}
    for name, p in model.named_parameters():
        axes = mesh_axes(logical_axes_for(name, p.dim(), patterns),
                         table_mesh or mesh, rules)
        other = [a for a in axes if a not in (None, AXIS_FSDP)]
        if other:
            raise NotImplementedError(
                f"{name}: a parameter split over {other} is not in the port "
                "yet (ROADMAP §1)")
        spec[name] = axes.index(AXIS_FSDP) if AXIS_FSDP in axes else None
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if mesh.size > 1:
                dist.broadcast(t.data, 0)
    if not fsdp2:
        return model
    from torch.distributed.fsdp import fully_shard

    fsdp_mesh = _fsdp_mesh(mesh)
    ignored = {p for p in model.parameters() if spec[names[id(p)]] is None}

    def placement(p: nn.Parameter):
        return Shard(spec[names[id(p)]])

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
