"""Cross-group communicator seam over the host plane.

Counterpart of ``ray_tpu/collective/communicator.py``. Reference analog:
the ``GPUCommunicator`` ABC that the reference's compiled-DAG typed
channels dispatch through
(python/ray/experimental/channel/gpu_communicator.py:17,
torch_tensor_nccl_channel.py): stage actors on DIFFERENT accelerator
groups exchange tensors through a pluggable transport, while the
channel layer stays transport-agnostic.

In the port, collectives inside one group of cards run on the card
(collective.device, NCCL). Between groups — pipeline stages in other
processes, parameter broadcast across gangs — traffic rides the host
network. This module defines that seam:

- :class:`TpuCommunicator` — the interface anything shipping tensors
  between groups programs against;
- :class:`DcnTcpCommunicator` — the implementation over the rank↔rank
  ``PeerMesh`` TCP fabric (collective.mesh).

Both keep the JAX package's names, which name a host ring there (TPU
slices joined by the data-center network, DCN); a program written for
the JAX package finds them here under the same names. Values are host
arrays or picklables; a caller reads a tensor on the card to the host
first.
"""

from __future__ import annotations

import abc
from typing import Any

_COMM_TAG = "__dcn__"


class TpuCommunicator(abc.ABC):
    """Transport between ranks of a cross-slice group.

    One rank per participating process (a stage actor owning one
    slice's mesh; rank 0 is conventionally the driver). Values are
    host arrays / picklables — device arrays are fetched to host by
    the caller (a future device-path implementation may pass device
    buffers straight through)."""

    @property
    @abc.abstractmethod
    def rank(self) -> int: ...

    @property
    @abc.abstractmethod
    def world_size(self) -> int: ...

    @abc.abstractmethod
    def send(self, value: Any, dst_rank: int, tag: str) -> None:
        """Ship one value to ``dst_rank``. Raises PeerDiedError when
        the peer is gone."""

    @abc.abstractmethod
    def recv(self, src_rank: int, tag: str,
             timeout: float | None = None) -> Any:
        """Blocking receive of the next value ``src_rank`` sent under
        ``tag``. Raises TimeoutError / PeerDiedError."""

    @abc.abstractmethod
    def allreduce(self, value, op: str = "sum"):
        """Dense allreduce across the group (cross-slice gradient /
        metric reduction)."""

    @abc.abstractmethod
    def close(self) -> None: ...


class DcnTcpCommunicator(TpuCommunicator):
    """DCN stand-in over the host collective plane's ``PeerMesh``.

    Joins (or creates, for rank 0) the named collective group in THIS
    process and multiplexes communicator traffic over the group's
    peer mesh under namespaced tags — collectives and channels share
    one fabric without interference. Construction is lazy-join:
    building the object is cheap and pickles freely; the group is
    joined on first use (or via :meth:`ensure`)."""

    def __init__(self, group_name: str, rank: int, world_size: int):
        self._group_name = group_name
        self._rank = rank
        self._world = world_size

    # -- lifecycle -----------------------------------------------------

    def ensure(self) -> "DcnTcpCommunicator":
        """Join the group in this process (blocking rendezvous the
        first time; no-op afterwards)."""
        self._mesh()
        return self

    def _mesh(self):
        from ray_tpu_torch.collective import host
        st = host._local.get(self._group_name)
        if st is None:
            host.init_collective_group(self._world, self._rank,
                                       group_name=self._group_name)
            st = host._group(self._group_name)
        return st.mesh

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world_size(self) -> int:
        return self._world

    def joined(self) -> bool:
        from ray_tpu_torch.collective import host
        return self._group_name in host._local

    # -- data path -----------------------------------------------------

    def send(self, value: Any, dst_rank: int, tag: str) -> None:
        self._mesh().send(dst_rank, (_COMM_TAG, tag), value)

    def recv(self, src_rank: int, tag: str,
             timeout: float | None = None) -> Any:
        return self._mesh().recv(src_rank, (_COMM_TAG, tag),
                                 timeout=timeout)

    def allreduce(self, value, op: str = "sum"):
        from ray_tpu_torch.collective import host
        self.ensure()
        return host.allreduce(value, group_name=self._group_name,
                              op=op)

    def close(self) -> None:
        from ray_tpu_torch.collective import host
        if self.joined():
            host.destroy_collective_group(self._group_name)

    def __reduce__(self):
        return (DcnTcpCommunicator,
                (self._group_name, self._rank, self._world))
