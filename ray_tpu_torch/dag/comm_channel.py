"""Communicator-backed compiled-DAG channels (edges between nodes).

Counterpart of ``ray_tpu/dag/comm_channel.py``. Reference analog:
``TorchTensorNcclChannel`` — the reference's typed channel that ships
tensors through a ``GPUCommunicator`` instead of shared memory when
producer and consumer live on different devices
(python/ray/experimental/channel/torch_tensor_nccl_channel.py, ABC at
gpu_communicator.py:17).

Here: when a compiled DAG's stage actors live on DIFFERENT NODES (node
daemons whose processes cannot share a /dev/shm arena), the edge gets a
:class:`CommChannel` riding the port's host
:class:`~ray_tpu_torch.collective.communicator.DcnTcpCommunicator`
instead of a native mutable-shm channel. It carries host values, as
the JAX package's does (a CUDA tensor as host bits, arriving as a CPU
tensor); an NCCL channel between cards is in neither package. Duck-type
matches the native channel surface the DAG loop uses
(``register_reader`` / ``claim_writer`` / ``write`` / ``begin_read`` /
``reader_count`` / ``close``), so ``compiled_dag`` stays
transport-agnostic.
"""

from __future__ import annotations

from typing import Any

from ray_tpu_torch.collective.communicator import DcnTcpCommunicator
from ray_tpu_torch.collective.mesh import PeerDiedError
from ray_tpu_torch.native.channel import (
    ChannelClosedError,
    ChannelTimeoutError,
)

# Process-local joined communicators, keyed by group name: channels
# are pickled into every participant, but each process has its own
# rank — the spec-level join installs the right one here.
_local_comms: dict[str, DcnTcpCommunicator] = {}


def join_comm_group(group_name: str, world_size: int,
                    rank: int) -> DcnTcpCommunicator:
    comm = _local_comms.get(group_name)
    if comm is None:
        comm = DcnTcpCommunicator(group_name, rank,
                                  world_size).ensure()
        _local_comms[group_name] = comm
    return comm


def leave_comm_group(group_name: str) -> None:
    comm = _local_comms.pop(group_name, None)
    if comm is not None:
        try:
            comm.close()
        except Exception:  # noqa: BLE001
            pass


class CommChannel:
    """One DAG edge over the host communicator between nodes.

    Semantics vs the native channel: depth is the kernel socket
    buffer (not strictly 1), every reader receives its own copy (TCP
    cannot zero-copy share), and closure is an in-band poison message
    rather than an shm flag."""

    _CLOSE = "__comm_channel_closed__"

    def __init__(self, group_name: str, name: str, writer_rank: int,
                 reader_ranks: tuple):
        self.name = name
        self._group = group_name
        self._writer = writer_rank
        self._readers = tuple(sorted(reader_ranks))
        self._closed = False

    def _comm(self) -> DcnTcpCommunicator:
        comm = _local_comms.get(self._group)
        if comm is None:
            raise ChannelClosedError(
                f"comm group {self._group!r} not joined/closed")
        return comm

    # -- native-channel duck type -------------------------------------

    def register_reader(self) -> None:
        # Membership is group-level (the loop spec joins before any
        # channel read); the driver registers its output channels
        # BEFORE joining, so this must not require the group yet.
        pass

    def claim_writer(self) -> None:
        pass

    def reader_count(self) -> int:
        """Driver handshake: the group join is a full rendezvous
        barrier, so once THIS process has joined, every endpoint is
        connected."""
        return (len(self._readers)
                if self._group in _local_comms else 0)

    def write(self, value: Any, timeout: float | None = None,
              _is_error: bool = False) -> None:
        if self._closed:
            raise ChannelClosedError(self.name)
        try:
            comm = self._comm()
            for dst in self._readers:
                comm.send(("v", value, _is_error), dst, self.name)
        except PeerDiedError as e:
            raise ChannelClosedError(str(e)) from e
        except OSError as e:
            raise ChannelClosedError(str(e)) from e

    def write_error(self, exc: BaseException,
                    timeout: float | None = None) -> None:
        self.write(exc, timeout, _is_error=True)

    def begin_read(self, timeout: float | None = None, *,
                   copy: bool = False):
        if self._closed:
            raise ChannelClosedError(self.name)
        try:
            out = self._comm().recv(self._writer, self.name,
                                    timeout=timeout)
        except TimeoutError as e:
            raise ChannelTimeoutError(str(e)) from e
        except PeerDiedError as e:
            raise ChannelClosedError(str(e)) from e
        if isinstance(out, tuple) and out and out[0] == self._CLOSE:
            self._closed = True
            raise ChannelClosedError(self.name)
        _tag, value, is_err = out
        return value, bool(is_err)

    def detach(self) -> None:
        # Native channels unmap shm here; nothing to release.
        pass

    def close(self) -> None:
        """Poison every OTHER endpoint (in-band close), then mark this
        side closed."""
        if self._closed:
            return
        self._closed = True
        comm = _local_comms.get(self._group)
        if comm is None:
            return
        for r in set(self._readers) | {self._writer}:
            if r == comm.rank:
                continue
            try:
                comm.send((self._CLOSE,), r, self.name)
            except Exception:  # noqa: BLE001
                pass
