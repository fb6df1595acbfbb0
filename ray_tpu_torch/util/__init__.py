"""Utility APIs (reference: python/ray/util/__init__.py).

The reference's ``ray.util`` namespace re-exports its utility family;
mirrored here so ``ray_tpu_torch.util.ActorPool`` etc. resolve the
same way. Heavy siblings (state, metrics, tracing, storage) resolve
lazily, and ``collective`` is the port's ``ray_tpu_torch.collective``,
as the JAX package's resolves to its own.
"""

from __future__ import annotations

from ray_tpu_torch.core.serialization import (  # noqa: F401
    deregister_serializer,
    register_serializer,
)
from ray_tpu_torch.util.actor_pool import ActorPool  # noqa: F401
from ray_tpu_torch.util.check_serialize import (  # noqa: F401
    inspect_serializability,
)
from ray_tpu_torch.util.log_once import (  # noqa: F401
    disable_log_once_globally,
    enable_periodic_logging,
    log_once,
)

__all__ = [
    "ActorPool",
    "inspect_serializability",
    "register_serializer",
    "deregister_serializer",
    "log_once",
    "disable_log_once_globally",
    "enable_periodic_logging",
    "get_node_ip_address",
    "list_named_actors",
    "placement_group",
    "remove_placement_group",
    "get_placement_group",
    "get_current_placement_group",
    "placement_group_table",
    "collective",
    "queue",
    "state",
    "metrics",
]


def get_node_ip_address() -> str:
    """(reference: ray.util.get_node_ip_address) This node's
    externally-routable IP, falling back to loopback off-network
    (the shared probe in util.net, used by the collective mesh and
    node daemon)."""
    from ray_tpu_torch.util.net import routable_ip
    return routable_ip("8.8.8.8")


def list_named_actors(all_namespaces: bool = False) -> list[str]:
    """Names of all live named actors (reference:
    ray.util.list_named_actors). Works from the driver and from
    client mode (routes through the state op)."""
    from ray_tpu_torch.core.api import get_runtime
    rt = get_runtime()
    if hasattr(rt, "_actors"):
        from ray_tpu_torch.util import state as state_api
        rows = state_api.list_actors()
    else:  # client: the head evaluates the same listing
        from ray_tpu_torch.core import protocol as P
        rows = rt._call(P.OP_STATE, ("actors", None))
    return [r["name"] for r in rows
            if r.get("name") and r.get("state") != "DEAD"]


def __getattr__(name: str):
    if name in ("placement_group", "remove_placement_group",
                "get_placement_group", "get_current_placement_group",
                "placement_group_table",
                "PlacementGroupSchedulingStrategy"):
        from ray_tpu_torch.core import placement_group as pg_mod
        val = getattr(pg_mod, name)
        globals()[name] = val
        return val
    if name == "collective":
        import importlib
        mod = importlib.import_module("ray_tpu_torch.collective")
        globals()[name] = mod
        return mod
    if name in ("queue", "state", "metrics", "multiprocessing",
                "joblib", "tracing", "scheduling_strategies", "chaos",
                "ha", "storage", "usage", "net", "logdir"):
        import importlib
        mod = importlib.import_module(f"ray_tpu_torch.util.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'ray_tpu_torch.util' has no attribute {name!r}")
