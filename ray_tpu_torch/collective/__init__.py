"""ray_tpu_torch.collective — collectives of the port.

``device``: the device-plane collectives over the axes of a mesh
(NCCL on the card, gloo on the CPU), the counterpart of
``ray_tpu.collective.ici``. The host plane of the JAX package (actor
groups through a rendezvous store) belongs to its runtime, which the
port does not have.
"""

from ray_tpu_torch.collective import device

__all__ = ["device"]
