"""ray_tpu_torch.experimental — unstable APIs (internal KV).

Counterpart of ``ray_tpu/experimental``. Its ``pubsub`` (head-side
topics) and ``channel`` (the shared-memory channel of compiled DAGs) are
not ported yet: they raise NotImplementedError naming ROADMAP.md §1
items 6 and 8.
"""

from ray_tpu_torch.experimental import internal_kv

__all__ = ["internal_kv"]

# Modules of the JAX package's ``experimental`` that this package lacks,
# with the ROADMAP.md §1 item that ports each.
_NOT_PORTED = {"pubsub": "item 6 (the util modules and the host "
                         "collective plane)",
               "channel": "item 8 (DAGs, compiled DAGs and workflows)"}


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"ray_tpu_torch.experimental.{name} is not ported yet "
            f"(ROADMAP.md §1, {_NOT_PORTED[name]})")
    raise AttributeError(
        f"module 'ray_tpu_torch.experimental' has no attribute {name!r}")
