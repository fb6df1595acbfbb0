"""Public channel surface (reference: python/ray/experimental/channel/
shared_memory_channel.py — mutable-object channels behind compiled
DAGs). Counterpart of ``ray_tpu/experimental/channel.py``. The
implementation lives in ray_tpu_torch.native.channel (C++ shm slot +
ctypes). These channels carry host values only, as the reference's CPU
channels do: a CUDA tensor crosses as host bits and arrives as a CPU
tensor, which the reading stage moves to its own card.
"""

from ray_tpu_torch.native.channel import (  # noqa: F401
    Channel,
    ChannelClosedError,
    ChannelTimeoutError,
    channels_available,
)

__all__ = ["Channel", "ChannelClosedError", "ChannelTimeoutError",
           "channels_available"]
