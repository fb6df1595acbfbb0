"""ray_tpu_torch.collective — collectives of the port, on two planes.

- ``device``: the device-plane collectives over the axes of a mesh
  (NCCL on the card, gloo on the CPU), the counterpart of
  ``ray_tpu.collective.ici``.
- the host plane (``host``, over the rank-to-rank TCP ``mesh``):
  actor-to-actor collectives on host arrays through a rendezvous store
  actor of the port's runtime — ``init_collective_group`` +
  allreduce/broadcast/allgather/reducescatter/barrier/send/recv with the
  reference's group API, as ``ray_tpu.collective`` exports them. Torch
  tensors are read to the host; results are numpy.

Reference analog: ``ray.util.collective`` (collective.py:120-655, NCCL/
Gloo backends).
"""

from ray_tpu_torch.collective.host import (
    init_collective_group,
    destroy_collective_group,
    allreduce,
    allgather,
    reducescatter,
    broadcast,
    barrier,
    send,
    recv,
)

__all__ = [
    "init_collective_group", "destroy_collective_group",
    "allreduce", "allgather", "reducescatter", "broadcast", "barrier",
    "send", "recv", "device",
]


def __getattr__(name: str):
    """``device`` imports torch; the host plane does not, so a runner or
    store actor that joins a group loads no torch for it."""
    if name == "device":
        import importlib
        mod = importlib.import_module("ray_tpu_torch.collective.device")
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'ray_tpu_torch.collective' has no attribute {name!r}")
