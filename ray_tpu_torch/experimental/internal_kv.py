"""Cluster-wide internal key-value store.

Reference analog: ``ray.experimental.internal_kv`` backed by the GCS
KV service (gcs_kv_manager.cc, InternalKVGcsService
gcs_service.proto:598): small metadata shared by libraries (function
blobs, serve configs, tracing hooks). Keys/values are bytes; a
namespace isolates tenants. Works from the driver and from inside
workers/actors (proxied over the client channel).
"""

from __future__ import annotations


def _rt():
    from ray_tpu_torch.core.api import get_runtime
    return get_runtime()


def _b(x) -> bytes:
    return x.encode() if isinstance(x, str) else bytes(x)


def _kv_put(key, value, overwrite: bool = True,
            namespace: str = "") -> bool:
    # One atomic control-plane op — a check-then-act here would let
    # two concurrent putters both "win" (reference: GCS PutIfAbsent
    # is atomic server-side).
    return _rt().kv_put(_b(key), _b(value), namespace,
                        overwrite=overwrite)


def _kv_get(key, namespace: str = "") -> bytes | None:
    return _rt().kv_get(_b(key), namespace)


def _kv_del(key, namespace: str = "") -> bool:
    return _rt().kv_del(_b(key), namespace)


def _kv_exists(key, namespace: str = "") -> bool:
    return _rt().kv_exists(_b(key), namespace)


def _kv_list(prefix, namespace: str = "") -> list[bytes]:
    return _rt().kv_keys(_b(prefix), namespace)


# reference-style aliases
kv_put = _kv_put
kv_get = _kv_get
kv_del = _kv_del
kv_exists = _kv_exists
kv_list = _kv_list
