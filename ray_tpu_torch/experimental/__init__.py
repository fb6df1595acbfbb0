"""ray_tpu_torch.experimental — unstable APIs (internal KV, pub/sub).

Counterpart of ``ray_tpu/experimental``. Its ``channel`` (the
shared-memory channel of compiled DAGs) is not ported yet: it raises
NotImplementedError naming ROADMAP.md §1 item 8.
"""

from ray_tpu_torch.experimental import internal_kv, pubsub

__all__ = ["internal_kv", "pubsub"]

# Modules of the JAX package's ``experimental`` that this package lacks,
# with the ROADMAP.md §1 item that ports each.
_NOT_PORTED = {"channel": "item 8 (DAGs, compiled DAGs and workflows)"}


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"ray_tpu_torch.experimental.{name} is not ported yet "
            f"(ROADMAP.md §1, {_NOT_PORTED[name]})")
    raise AttributeError(
        f"module 'ray_tpu_torch.experimental' has no attribute {name!r}")
