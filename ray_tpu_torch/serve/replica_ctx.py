"""Replica-local context holder (reference: serve.get_replica_context).

Its own module on purpose: the Replica actor class is cloudpickled BY
VALUE into replica workers (the decorated module attribute is the
ActorClass wrapper, not the raw class, so cloudpickle treats the raw
class as local) — a ``global`` assignment from its methods would
mutate cloudpickle's recreated globals dict, not any real module.
Methods instead import THIS module at call time, which resolves the
worker's genuine module instance, where user code's own import reads.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ReplicaContext:
    """What user code can learn about the replica it runs in."""

    deployment: str
    replica_tag: str

    @property
    def app_name(self) -> str:
        return self.deployment


_current: ReplicaContext | None = None


def set_current(ctx: ReplicaContext) -> None:
    global _current
    _current = ctx


def get_replica_context() -> ReplicaContext:
    if _current is None:
        raise RuntimeError(
            "get_replica_context() called outside a serve replica")
    return _current
