"""Model multiplexing: many models time-share one replica pool.

Reference analog: python/ray/serve/multiplex.py +
model-multiplex-aware routing in pow_2_scheduler.py — a replica holds
an LRU cache of loaded models (``@serve.multiplexed``); requests carry
a ``multiplexed_model_id`` and the router prefers replicas that
already have that model resident (on the GPU: model weights already
on the card — avoiding a reload is the difference between µs and
seconds).

Eviction vs in-flight requests: the replica pins a request's model id
for the request's duration (``pin_model``/``unpin_model``). Eviction
skips pinned models when it can; when every candidate is pinned it
frees the LRU slot but DEFERS the ``unload()`` until the last pin
drops, so evicting a model mid-request never yanks weights out from
under the handler. A loader that raises leaves no cache entry behind
(the next request simply retries the load) and surfaces as
``ModelLoadError`` naming the model id.
"""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict

_current_model_id = threading.local()

# Guards the per-object pin counts and deferred-unload lists. Always
# acquired AFTER a @multiplexed method's own lock (never the other
# way), and unloads run outside it.
_pins_lock = threading.Lock()
_PINS_ATTR = "__serve_mux_pins__"
_DEFERRED_ATTR = "__serve_mux_deferred__"


def get_multiplexed_model_id() -> str:
    """The model id of the request being handled (valid inside a
    replica's request path)."""
    return getattr(_current_model_id, "value", "")


def _set_current_model_id(model_id: str) -> None:
    _current_model_id.value = model_id


def _unload(model) -> None:
    unload = getattr(model, "unload", None)
    if callable(unload):
        try:
            unload()
        except Exception:  # noqa: BLE001
            pass


def pin_model(obj, model_id: str) -> None:
    """Mark ``model_id`` as in use by a request on ``obj`` so a
    concurrent eviction defers its unload."""
    if not model_id:
        return
    with _pins_lock:
        pins = getattr(obj, _PINS_ATTR, None)
        if pins is None:
            pins = {}
            setattr(obj, _PINS_ATTR, pins)
        pins[model_id] = pins.get(model_id, 0) + 1


def unpin_model(obj, model_id: str) -> None:
    """Drop one pin; when the last pin for an evicted-but-deferred
    model drops, its unload() runs here (outside all mux locks)."""
    if not model_id:
        return
    to_unload = []
    with _pins_lock:
        pins = getattr(obj, _PINS_ATTR, None)
        if pins is None:
            return
        n = pins.get(model_id, 0) - 1
        if n > 0:
            pins[model_id] = n
        else:
            pins.pop(model_id, None)
            deferred = getattr(obj, _DEFERRED_ATTR, None)
            if deferred:
                keep = []
                for mid, model in deferred:
                    (to_unload if mid == model_id
                     else keep).append((mid, model))
                setattr(obj, _DEFERRED_ATTR, keep)
    for _, model in to_unload:
        _unload(model)


def _pinned_ids(obj) -> dict:
    return getattr(obj, _PINS_ATTR, None) or {}


def _defer_unload(obj, model_id: str, model) -> None:
    """Hand an evicted-but-pinned model to the last unpin for its
    unload. Module-level on purpose: the @multiplexed wrapper is
    pickled by value (it's a dynamic function on a user class), and a
    wrapper-body reference to ``_pins_lock`` would drag the lock into
    the pickle; a reference to this module function pickles by name."""
    with _pins_lock:
        deferred = getattr(obj, _DEFERRED_ATTR, None)
        if deferred is None:
            deferred = []
            setattr(obj, _DEFERRED_ATTR, deferred)
        deferred.append((model_id, model))


def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3):
    """Decorate a replica method ``load_model(self, model_id)`` so
    repeated calls hit a per-instance LRU cache; evicted models call
    ``model.__del__`` naturally (or an ``unload()`` if defined)."""

    def wrap(fn):
        attr = f"__serve_mux_cache_{fn.__name__}"
        lock_attr = f"__serve_mux_lock_{fn.__name__}"
        loading_attr = f"__serve_mux_loading_{fn.__name__}"

        @functools.wraps(fn)
        def inner(self, model_id: str):
            lock = getattr(self, lock_attr, None)
            if lock is None:
                lock = threading.Lock()
                setattr(self, lock_attr, lock)
            while True:
                with lock:
                    cache: OrderedDict = getattr(self, attr, None)
                    if cache is None:
                        cache = OrderedDict()
                        setattr(self, attr, cache)
                    loading: dict = getattr(self, loading_attr, None)
                    if loading is None:
                        loading = {}
                        setattr(self, loading_attr, loading)
                    if model_id in cache:
                        cache.move_to_end(model_id)
                        return cache[model_id]
                    ev = loading.get(model_id)
                    if ev is None:
                        loading[model_id] = threading.Event()
                        break   # we are the loader for this model id
                # Another request is mid-load for the same model: wait
                # instead of loading a duplicate copy (a second
                # multi-GB weight load onto the same chip).
                ev.wait(timeout=600)
            try:
                model = fn(self, model_id)
            except BaseException as e:
                # No poisoned slot: the failed id leaves no cache or
                # loading entry, waiters wake and the NEXT request
                # for this id retries the load cleanly.
                with lock:
                    loading.pop(model_id).set()
                from ray_tpu_torch.serve.exceptions import ModelLoadError
                raise ModelLoadError(
                    f"@multiplexed load of model {model_id!r} via "
                    f"{type(self).__name__}.{fn.__name__} failed: "
                    f"{type(e).__name__}: {e}") from e
            with lock:
                cache[model_id] = model
                cache.move_to_end(model_id)
                while len(cache) > max_num_models_per_replica:
                    pins = _pinned_ids(self)
                    victim = None
                    for mid in cache:       # LRU -> MRU
                        if mid != model_id and not pins.get(mid):
                            victim = mid
                            break
                    if victim is not None:
                        _unload(cache.pop(victim))
                        continue
                    # Every other resident model is mid-request:
                    # free the LRU slot now but hand the unload to
                    # the last unpin (eviction must never fail the
                    # in-flight request using the victim).
                    victim = next((mid for mid in cache
                                   if mid != model_id), None)
                    if victim is None:
                        break
                    _defer_unload(self, victim, cache.pop(victim))
                loading.pop(model_id).set()
            return model

        inner.__serve_is_multiplexed__ = True
        return inner

    if _fn is not None:
        return wrap(_fn)
    return wrap


def resident_model_ids(obj) -> list[str]:
    """All model ids currently cached by any @multiplexed method of
    the replica's user object (reported to the controller so the
    router can do model-locality-aware picks)."""
    out: list[str] = []
    for name in dir(obj):
        if name.startswith("__serve_mux_cache_"):
            cache = getattr(obj, name)
            if isinstance(cache, OrderedDict):
                out.extend(cache.keys())
    return out
