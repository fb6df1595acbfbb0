"""Host-plane collective groups: ring algorithms over a direct
rank-to-rank TCP mesh, with a named store actor used only for
rendezvous.

Counterpart of ``ray_tpu/collective/host.py`` on the port's runtime, with
the same group API (``init_collective_group``, ``allreduce`` (sum, max,
min), ``allgather``, ``reducescatter``,
``broadcast``, ``barrier``, ``send``, ``recv``). Reference analog:
``ray.util.collective`` — ring collectives as in the gloo backend
(gloo_collective_group.py), rendezvous-via-named-store as in the NCCL
unique-id pattern (nccl_collective_group.py). The data path is
event-driven peer sockets (collective.mesh); the store actor never
carries payload bytes.

Inputs are what ``np.asarray`` takes, and ``torch.Tensor``s on any
device, read through one ``.detach().cpu()`` copy; results are numpy, as
the JAX package's are. The store actor's name keeps the JAX package's
prefix with this package's name in it, so groups of both packages can
live in one process.

This plane is for host arrays (control tensors, gradients of small
models between learner processes, parameter broadcast between gangs) —
NOT the training hot path, whose collectives run on the card
(collective.device, NCCL).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.collective.mesh import (
    PeerMesh,
    ring_allgather,
    ring_allreduce,
    ring_broadcast,
    ring_reducescatter,
)

_GROUP_PREFIX = "ray_tpu_torch_collective:"
_local = {}  # group_name -> _GroupState


@ray_tpu_torch.remote
class _GroupStore:
    """Rendezvous only (token + address exchange): no payload byte
    ever reaches this actor."""

    def __init__(self, world_size: int, token: bytes):
        self.world_size = world_size
        self.token = token
        self.addrs: dict[int, tuple] = {}

    def meta(self):
        return self.token, self.world_size

    def register_addr(self, rank: int, addr: tuple):
        self.addrs[int(rank)] = tuple(addr)

    def addresses(self):
        if len(self.addrs) == self.world_size:
            return self.addrs
        return None

    def num_registered(self) -> int:
        return len(self.addrs)


class _GroupState:
    def __init__(self, handle, rank: int, world_size: int,
                 mesh: PeerMesh | None):
        self.handle = handle
        self.rank = rank
        self.world_size = world_size
        self.mesh = mesh
        self.seq: dict[str, int] = {}
        self.p2p_seq: dict[tuple, int] = {}

    def next_seq(self, op: str) -> int:
        s = self.seq.get(op, 0)
        self.seq[op] = s + 1
        return s


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default") -> None:
    """Join (rank 0 creates) the named group; establish the p2p
    rank-to-rank mesh."""
    name = _GROUP_PREFIX + group_name
    if rank == 0:
        token = os.urandom(16)
        handle = _GroupStore.options(name=name, num_cpus=0).remote(
            world_size, token)
        ray_tpu_torch.get(handle.meta.remote())     # created before others join
    else:
        handle = _wait_for_actor(name)
        token, ws = ray_tpu_torch.get(handle.meta.remote())
        assert ws == world_size, (ws, world_size)

    probe = os.environ.get("RAY_TPU_HEAD_IP", "127.0.0.1")
    mesh = PeerMesh(rank, world_size, bytes(token),
                    probe_host=probe)
    ray_tpu_torch.get(handle.register_addr.remote(rank, mesh.addr))
    # Rendezvous wait (setup only — the data path never polls).
    deadline = time.monotonic() + 60.0
    addrs = None
    while time.monotonic() < deadline:
        addrs = ray_tpu_torch.get(handle.addresses.remote())
        if addrs is not None:
            break
        time.sleep(0.02)
    if addrs is None:
        try:
            n_reg = ray_tpu_torch.get(handle.num_registered.remote())
        except Exception:  # noqa: BLE001
            n_reg = "?"
        mesh.close()
        raise TimeoutError(
            f"collective group {group_name!r}: only {n_reg}/"
            f"{world_size} ranks registered within 60s")
    mesh.set_addresses(addrs)
    _local[group_name] = _GroupState(handle, rank, world_size, mesh)
    try:
        barrier(group_name)
    except BaseException:
        _local.pop(group_name, None)
        if mesh is not None:
            mesh.close()
        raise


def _wait_for_actor(name: str, timeout: float = 60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            return ray_tpu_torch.get_actor(name)
        except ValueError:
            time.sleep(0.05)
    raise TimeoutError(f"collective group actor {name} never appeared")


def destroy_collective_group(group_name: str = "default") -> None:
    st = _local.pop(group_name, None)
    if st is not None:
        if st.mesh is not None:
            st.mesh.close()
        if st.rank == 0:
            try:
                ray_tpu_torch.kill(st.handle)
            except Exception:  # noqa: BLE001
                pass


def _host(tensor) -> np.ndarray:
    """``tensor`` as a host array: a ``torch.Tensor`` (on any device)
    through one ``.detach().cpu()`` copy, anything else through
    ``np.asarray``. torch is not imported for it: a tensor exists only
    where torch already is."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(tensor, torch.Tensor):
        return tensor.detach().cpu().numpy()
    return np.asarray(tensor)


def _group(group_name: str) -> _GroupState:
    if group_name not in _local:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized in this "
            f"process — call init_collective_group first")
    return _local[group_name]


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    st = _group(group_name)
    x = _host(tensor)
    return ring_allreduce(st.mesh, ("ar", st.next_seq("allreduce")),
                          x, op)


def allgather(tensor, group_name: str = "default") -> list:
    st = _group(group_name)
    x = _host(tensor)
    return ring_allgather(st.mesh, ("ag", st.next_seq("allgather")), x)


def reducescatter(tensor, group_name: str = "default"):
    st = _group(group_name)
    x = _host(tensor)
    return ring_reducescatter(
        st.mesh, ("rsc", st.next_seq("reducescatter")), x)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    st = _group(group_name)
    return ring_broadcast(st.mesh, ("bc", st.next_seq("broadcast")),
                          _host(tensor), src_rank)


def barrier(group_name: str = "default") -> None:
    st = _group(group_name)
    # Distinct tag namespace: concurrent barrier/allreduce with
    # mismatched call order across ranks must never share tags.
    ring_allreduce(st.mesh, ("bar", st.next_seq("barrier")),
                   np.zeros(1, np.int8))


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    st = _group(group_name)
    key = (st.rank, dst_rank)
    seq = st.p2p_seq.get(key, 0)
    st.p2p_seq[key] = seq + 1
    st.mesh.send(dst_rank, ("p2p", seq), _host(tensor))


def recv(src_rank: int, group_name: str = "default",
         timeout: float = 120.0):
    st = _group(group_name)
    key = (src_rank, st.rank)
    seq = st.p2p_seq.get(key, 0)
    st.p2p_seq[key] = seq + 1
    return st.mesh.recv(src_rank, ("p2p", seq), timeout)
