"""Cluster-visible creator registry (reference:
python/ray/tune/registry.py — register_env / register_trainable over
the GCS KV).

Registrations are stored BOTH process-locally and in the cluster KV
(when a runtime is up), so env-runner actors in worker processes
resolve names registered by the driver.
"""

from __future__ import annotations

from typing import Callable

from ray_tpu_torch.core import serialization as ser

_NS = "tune_registry"
_local: dict[str, Callable] = {}
_pending_kv: set[str] = set()   # registered before init: flush later


def _kv():
    from ray_tpu_torch.core.api import get_runtime_or_none
    if get_runtime_or_none() is None:
        return None
    from ray_tpu_torch.experimental import internal_kv
    return internal_kv


def flush_pending() -> None:
    """Push registrations made BEFORE ray_tpu_torch.init() into the cluster
    KV (the reference flushes its pre-init registrations to the GCS on
    connect). Called lazily by register/resolve and by the rllib
    runner-group builder."""
    if not _pending_kv:
        return
    kv = _kv()
    if kv is None:
        return
    for key in list(_pending_kv):
        fn = _local.get(key)
        if fn is not None:
            kv._kv_put(key, ser.dumps(fn), namespace=_NS)
        _pending_kv.discard(key)


def register_env(name: str, env_creator: Callable) -> None:
    """(reference: tune.register_env) Make ``env_creator`` resolvable
    by name in ``AlgorithmConfig.environment(env="name")`` anywhere in
    the cluster. Registration before ray_tpu_torch.init() is fine — it is
    flushed to the cluster KV on first use after init."""
    if not callable(env_creator):
        raise TypeError("env_creator must be callable")
    key = f"env:{name}"
    _local[key] = env_creator
    kv = _kv()
    if kv is None:
        _pending_kv.add(key)
    else:
        flush_pending()
        kv._kv_put(key, ser.dumps(env_creator), namespace=_NS)


def get_registered_env(name: str) -> Callable | None:
    """Resolve a registered env creator (local first, then KV)."""
    flush_pending()
    fn = _local.get(f"env:{name}")
    if fn is not None:
        return fn
    kv = _kv()
    if kv is not None:
        blob = kv._kv_get(f"env:{name}", namespace=_NS)
        if blob:
            fn = ser.loads(blob)
            _local[f"env:{name}"] = fn
            return fn
    return None
