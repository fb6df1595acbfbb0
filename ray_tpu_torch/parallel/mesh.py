"""Device mesh construction: the counterpart of ``ray_tpu/parallel/mesh.py``.

A ``MeshSpec`` names the parallel axes with their sizes; :func:`make_mesh`
lays the ranks of the process group out on them in the canonical order,
outermost (``pp``) to innermost (``tp``), as the JAX package orders its
device mesh. The mesh is a :class:`Mesh`: a ``torch.distributed``
``DeviceMesh`` over every axis, size-1 axes kept, with ``shape`` as a
``{axis: size}`` dict as JAX's mesh exposes it, and the process group of
any axis or tuple of axes (:meth:`Mesh.group`), which the port's
collectives run over (``collective.device``).

Where the JAX package gets its processes from ``jax.distributed.initialize``
(``ray_tpu/train/worker_group.py``), the port's ranks come from
:func:`initialize`: NCCL on the card, one rank per GPU, rendezvous through
torchrun's environment; gloo only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import datetime
import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ray_tpu_torch.core.accelerator import resolve_device

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_EP = "ep"
AXIS_PP = "pp"

# Canonical order, outermost (slowest link) to innermost (fastest): the
# pipeline and data axes cross nodes fine; tensor wants the tightest
# links (NVLink within a node).
CANONICAL_ORDER = (AXIS_PP, AXIS_DP, AXIS_FSDP, AXIS_EP, AXIS_SP, AXIS_TP)

# How long a collective, the rendezvous included, may wait before the
# process group gives up on it: a lost rank fails the run instead of
# hanging it.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


@dataclass
class MeshSpec:
    """Named parallelism axes, e.g. ``MeshSpec(dp=2, sp=4)``.

    One axis may be -1, meaning "all remaining ranks". Axes of size 1 are
    kept in the mesh (so placements naming them are always valid) unless
    ``squeeze=True``.
    """

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1
    squeeze: bool = False

    def axes(self) -> dict[str, int]:
        return {AXIS_PP: self.pp, AXIS_DP: self.dp, AXIS_FSDP: self.fsdp,
                AXIS_EP: self.ep, AXIS_SP: self.sp, AXIS_TP: self.tp}

    def resolve(self, n_devices: int) -> dict[str, int]:
        axes = self.axes()
        unknown = [k for k, v in axes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError("at most one axis may be -1")
        known = 1
        for k, v in axes.items():
            if v != -1:
                if v <= 0:
                    raise ValueError(f"axis {k} must be positive or -1")
                known *= v
        if unknown:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {known}")
            axes[unknown[0]] = n_devices // known
        elif known > n_devices:
            raise ValueError(
                f"mesh axes {axes} need {known} devices, have {n_devices}")
        if self.squeeze:
            axes = {k: v for k, v in axes.items() if v > 1} or {AXIS_DP: 1}
        return axes


_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _local_rank() -> int:
    """This process's rank on its node, from torchrun's ``LOCAL_RANK``
    (0 in a one-process world). Required when ``WORLD_SIZE`` is above 1:
    the global ``RANK`` names no card on a second node."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if int(os.environ.get("WORLD_SIZE", 1)) > 1:
        raise ValueError("WORLD_SIZE > 1 but LOCAL_RANK is not set: the "
                         "card of this rank is unknown (start the ranks "
                         "with torchrun, or set LOCAL_RANK)")
    return 0


def _group_backend(device_type: str) -> str | None:
    """The backend of the default group for ``device_type`` tensors:
    ``get_backend()`` names one (``"nccl"``) or one per device type
    (``"cpu:gloo,cuda:nccl"``)."""
    backend = dist.get_backend()
    if ":" not in backend:
        return backend
    return dict(part.split(":", 1)
                for part in backend.split(",")).get(device_type)


def initialize(device=None, timeout: datetime.timedelta = DEFAULT_TIMEOUT
               ) -> torch.device:
    """Join this process to the default process group and return its
    device: the counterpart of ``jax.distributed.initialize``.

    The device defaults to the card (``core.accelerator.resolve_device``,
    which raises without one): rank ``LOCAL_RANK`` takes ``cuda:LOCAL_RANK``,
    set as the current device before the NCCL group is made. Only an
    explicit ``device="cpu"`` makes a gloo group. The ranks rendezvous
    through torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``, and ``LOCAL_RANK`` for the card);
    without it the group has one rank. A process already in a group keeps
    it and gets its device back; ValueError when that group's backend is
    not the device's (a gloo group would carry CUDA tensors through host
    memory without a word)."""
    device = resolve_device(device)
    backend = _BACKENDS.get(device.type)
    if backend is None:
        raise ValueError(f"no process group backend for {device}")
    if device.type == "cuda" and device.index in (None, 0):
        device = torch.device("cuda", _local_rank())
    if dist.is_initialized():
        have = _group_backend(device.type)
        if have != backend:
            raise ValueError(
                f"this process is already in a {dist.get_backend()} "
                f"process group, which does not carry {device} tensors by "
                f"{backend}; destroy it first or ask for its device")
        return device
    kwargs = {"timeout": timeout, "backend": backend}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(init_method="env://", **kwargs)
    else:
        dist.init_process_group(store=dist.HashStore(), rank=0,
                                world_size=1, **kwargs)
    return device


class Mesh:
    """The ranks of the default process group laid out on named axes.

    ``shape`` is ``{axis: size}`` in the canonical order, size-1 axes
    included; ``device`` is this rank's device; ``device_mesh`` the
    ``DeviceMesh`` over every axis. Used as a context manager it is the
    mesh that axis names resolve on (``collective.device``), as a JAX
    mesh is under ``with mesh:``."""

    def __init__(self, axes: dict[str, int], device: torch.device):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.device = device
        self.device_mesh = init_device_mesh(
            device.type, tuple(axes.values()), mesh_dim_names=self.axis_names)
        self._groups: dict[tuple[str, ...], dist.ProcessGroup] = {}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def _axes(self, axes) -> tuple[str, ...]:
        """``axes`` as a tuple in the mesh's order (a group's ranks, and a
        coordinate along several axes, are taken in that order)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        missing = [a for a in axes if a not in self.shape]
        if missing:
            raise ValueError(f"axes {missing} not in mesh "
                             f"{tuple(self.shape)}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's coordinate along ``axes``, the outermost axis
        first, as ``lax.axis_index`` gives it."""
        index = 0
        for a in self._axes(axes):
            index = (index * self.shape[a]
                     + self.device_mesh.get_local_rank(a))
        return index

    def group(self, axes) -> dist.ProcessGroup:
        """The process group of the ranks that differ only along ``axes``
        (one name or a tuple), its ranks in the order of
        :meth:`axis_index`.
        The first request for a tuple of axes makes its groups, which
        every rank must do together."""
        axes = self._axes(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if len(axes) == len(self.axis_names):
            return dist.group.WORLD
        if axes not in self._groups:
            dims = [self.axis_names.index(a) for a in axes]
            rest = [i for i in range(len(self.axis_names)) if i not in dims]
            grid = torch.arange(self.size).reshape(
                tuple(self.shape.values())).permute(*rest, *dims)
            me = dist.get_rank()
            for ranks in grid.reshape(-1, self.axis_size(axes)).tolist():
                g = dist.new_group(ranks)
                if me in ranks:
                    self._groups[axes] = g
        return self._groups[axes]

    def __enter__(self) -> "Mesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


_ACTIVE: list[Mesh] = []


def current_mesh() -> Mesh:
    """The innermost mesh entered with ``with mesh:``."""
    if not _ACTIVE:
        raise ValueError("no mesh is active: pass mesh= or enter one with "
                         "`with mesh:`")
    return _ACTIVE[-1]


def loss_group(mesh) -> dist.ProcessGroup | None:
    """The group over which a loss's mean is taken: every rank of a mesh
    of more than one (ranks along ``ep`` that see the same tokens count
    them once each, as their gradients are equal), None off a mesh or on
    one rank."""
    if mesh is None or mesh.size == 1:
        return None
    return mesh.group(mesh.axis_names)


def make_mesh(spec: MeshSpec | dict[str, int] | None = None,
              device=None) -> Mesh:
    """Build a :class:`Mesh` over every rank of the default process group,
    joining one (:func:`initialize` with ``device``) when this process has
    none. ``spec`` defaults to ``dp`` over every rank. The axes must cover
    the group exactly: a rank outside the mesh would have no part in its
    collectives."""
    device = initialize(device)
    n = dist.get_world_size()
    if spec is None:
        spec = MeshSpec(dp=-1)
    if isinstance(spec, dict):
        ms = MeshSpec()
        for k, v in spec.items():
            if not hasattr(ms, k):
                raise ValueError(f"unknown mesh axis {k!r}")
            setattr(ms, k, v)
        spec = ms
    axes = spec.resolve(n)
    if math.prod(axes.values()) != n:
        raise ValueError(f"mesh axes {axes} cover "
                         f"{math.prod(axes.values())} of the {n} ranks of "
                         "the process group; a mesh takes every rank")
    return Mesh(axes, device)


def local_mesh(**axes) -> Mesh:
    """Convenience: ``local_mesh(dp=2, sp=4)`` over the process group."""
    return make_mesh(axes or None)


def mesh_size(mesh) -> int:
    return math.prod(mesh.shape.values())
