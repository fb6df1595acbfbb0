"""Sharding-aware checkpoints: the counterpart of
``ray_tpu/train/checkpoint.py``.

The JAX module saves a sharded pytree with orbax, each host writing its
shards, and restores it to a target's shardings. The port uses
``torch.distributed.checkpoint`` the same way: a tree (nested dicts of
tensors and plain values) is saved with each rank writing the blocks it
holds, a block that several ranks hold written once; a restore reads into
a target tree in place, each rank the blocks of its own placement, so a
checkpoint taken on one mesh reloads on another. Outside a process group
it saves and loads whole tensors.

:func:`state_tree` gives a train state's tree: every parameter and
optimizer-state tensor as one tensor of the whole model, a DTensor over
the mesh where this rank holds a block of it (cut over ``tp`` or ``ep``,
sharded by FSDP2, or both), views of the state's own storage, so that
restoring into the tree restores the state.

Remote destinations, as in the JAX module: a ``scheme://`` directory
routes through ``util.storage``. The save is staged in a local temporary
directory (``core.config.temp_path``), then the tree uploads through the
scheme's byte-copy backend; a restore downloads it into one first. Under
a process group each rank stages and uploads the files it wrote, which
together are the checkpoint.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
from typing import Any

import torch

from ray_tpu_torch.core.config import temp_path
from ray_tpu_torch.parallel.mesh import AXIS_FSDP
from ray_tpu_torch.parallel.sharding import Placement, is_sharded, local
from ray_tpu_torch.util.storage import is_uri, storage_for_uri


@contextlib.contextmanager
def _staging(prefix: str):
    """A local temporary directory for a remote checkpoint, removed
    after."""
    base = temp_path("ray_tpu_torch_ckpt_staging")
    os.makedirs(base, exist_ok=True)
    staging = tempfile.mkdtemp(prefix=prefix, dir=base)
    try:
        yield staging
    finally:
        shutil.rmtree(staging, ignore_errors=True)


def save_pytree(tree: Any, directory: str) -> str:
    """Save ``tree`` to ``directory`` (a path or a ``scheme://`` URI);
    every rank of the process group calls it together. Returns the
    directory."""
    if is_uri(directory):
        with _staging("up_") as staging:
            _save_local(tree, staging)
            storage_for_uri(directory).upload_dir(staging, directory)
        return directory
    return _save_local(tree, directory)


def _save_local(tree: Any, directory: str) -> str:
    import torch.distributed.checkpoint as dcp

    os.makedirs(directory, exist_ok=True)
    dcp.save(tree, checkpoint_id=directory)
    return directory


def restore_pytree(directory: str, target: Any = None) -> Any:
    """The tree saved in ``directory`` (a path or a ``scheme://`` URI).
    With ``target`` (a tree of the same keys), read in place into its
    tensors, each rank the blocks its tensors hold, and return it;
    without, whole tensors on the CPU."""
    if is_uri(directory):
        with _staging("down_") as staging:
            storage_for_uri(directory).download_dir(directory, staging)
            return _restore_local(staging, target)
    return _restore_local(directory, target)


def _restore_local(directory: str, target: Any = None) -> Any:
    if target is None:
        target = _whole_tree(directory)
    import torch.distributed.checkpoint as dcp

    dcp.load(target, checkpoint_id=directory)
    return target


def _whole_tree(directory: str) -> dict:
    """An empty tree of whole CPU tensors shaped as the checkpoint's."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    meta = dcp.FileSystemReader(directory).read_metadata()
    tree: dict = {}
    for key, item in meta.state_dict_metadata.items():
        path = (meta.planner_data or {}).get(key, (key,))
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = (torch.empty(item.size,
                                      dtype=item.properties.dtype)
                          if isinstance(item, TensorStorageMetadata)
                          else None)
    return tree


def state_tree(state) -> dict:
    """``{"step", "params", "opt_state", "extra"}`` of a
    ``train.step.TrainState``: the parameters and each optimizer-state
    list by parameter name, as views of the state's tensors (see the
    module docstring)."""
    named = list(state.params.named_parameters())
    placed = getattr(state.params, "placements", None) or {}
    views = [(name, p, placed.get(name, Placement())) for name, p in named]

    def whole(t, p, pl):
        return _whole_view(t, p, pl, state.mesh)

    tree = {"step": state.step,
            "params": {n: whole(local(p), p, pl) for n, p, pl in views}}
    opt = {}
    for f in dataclasses.fields(state.opt_state):
        value = getattr(state.opt_state, f.name)
        if isinstance(value, torch.Tensor):
            opt[f.name] = value
        elif isinstance(value, list):
            opt[f.name] = {n: whole(t, p, pl)
                           for (n, p, pl), t in zip(views, value)}
    tree["opt_state"] = opt
    if state.extra:
        tree["extra"] = dict(state.extra)
    return tree


def save_train_state(state, directory: str) -> str:
    """:func:`save_pytree` of :func:`state_tree`."""
    return save_pytree(state_tree(state), directory)


def restore_train_state(directory: str, state) -> None:
    """Restore a saved train state into ``state`` in place, whatever the
    mesh either was placed on: its parameters, optimizer state, extra and
    step."""
    tree = restore_pytree(directory, state_tree(state))
    state.step = int(tree["step"])


def _whole_view(t: torch.Tensor, p: torch.Tensor, pl: Placement, mesh
                ) -> torch.Tensor:
    """``t`` (this rank's part of parameter ``p``, or of a tensor shaped
    as it) as a tensor of the whole: itself where the rank holds the
    whole, else a DTensor over ``mesh`` with ``t``'s storage as its local
    block."""
    t = t.detach()
    if not pl.split and not is_sharded(p):
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard

    names = list(mesh.shape)
    placements = [Replicate()] * len(names)
    for dim, axis, _, _ in pl.split:
        placements[names.index(axis)] = Shard(dim)
    if is_sharded(p):
        placements[names.index(AXIS_FSDP)] = Shard(pl.fsdp)
    shape = pl.whole_shape(p.shape)
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(t, mesh.device_mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))
