"""ray_tpu_torch.experimental — unstable APIs (internal KV, pub/sub, the
shared-memory channel of compiled DAGs).

Counterpart of ``ray_tpu/experimental``.
"""

from ray_tpu_torch.experimental import channel, internal_kv, pubsub

__all__ = ["channel", "internal_kv", "pubsub"]
