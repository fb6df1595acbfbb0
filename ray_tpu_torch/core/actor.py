"""Actor classes and handles (reference: python/ray/actor.py)."""

from __future__ import annotations

from typing import Any

from ray_tpu_torch.core import serialization as ser
from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.remote_function import make_task_options


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    # Options the backend understands today. Everything else raises
    # instead of being swallowed — a typo like nm_returns=2 used to
    # silently run with num_returns=1 and fail later at unpack time.
    _SUPPORTED_OPTIONS = ("num_returns", "concurrency_group")

    def options(self, num_returns: int | str | None = None,
                concurrency_group: str | None = None,
                **unknown) -> "ActorMethod":
        if unknown:
            raise TypeError(
                f"unsupported actor-method option(s) "
                f"{sorted(unknown)}; this backend supports "
                f"{list(self._SUPPORTED_OPTIONS)}")
        if concurrency_group is not None:
            raise NotImplementedError(
                "concurrency_group is not implemented by this "
                "backend: actor concurrency is governed by "
                "max_concurrency on the actor (one shared budget), "
                "not per-method groups")
        if num_returns is None:
            num_returns = self._num_returns
        return ActorMethod(self._handle, self._name, num_returns)

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.core.api import get_runtime
        from ray_tpu_torch.core.remote_function import _unwrap_duck_refs
        from ray_tpu_torch.util.tracing import get_tracer
        args, kwargs = _unwrap_duck_refs(args, kwargs)
        rt = get_runtime()
        tracer = get_tracer()
        if tracer.enabled:
            with tracer.span(f"submit::{self._name}"):
                refs = rt.submit_actor_task(
                    self._handle._actor_id, self._name, args, kwargs,
                    self._num_returns,
                    trace_ctx=tracer.current_context())
        else:
            refs = rt.submit_actor_task(
                self._handle._actor_id, self._name, args, kwargs,
                self._num_returns)
        if self._num_returns == "streaming":
            return refs            # ObjectRefGenerator
        return refs[0] if self._num_returns == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor method {self._name} cannot be called directly; "
            f"use .remote()")

    def bind(self, *args, **kwargs):
        """Bind this method on a live actor into a DAG."""
        from ray_tpu_torch.dag.dag_node import ClassMethodNode
        return ClassMethodNode(self._handle, self._name, args, kwargs)


class ActorHandle:
    """Serializable handle; pickles to the actor id and re-binds to the
    local process runtime on deserialization (same as the reference's
    handle reduction)."""

    def __init__(self, actor_id: ActorID, method_meta: dict[str, int]
                 | None = None):
        self._actor_id = actor_id
        self._method_meta = method_meta or {}

    def __getattr__(self, name: str) -> ActorMethod:
        if name == "__ray_call__":
            # Run an arbitrary closure on the actor instance
            # (reference: actor.__ray_call__.remote(lambda self: ...));
            # the worker special-cases this method name.
            return ActorMethod(self, name, 1)
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name,
                           self._method_meta.get(name, 1))

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def state(self) -> str:
        from ray_tpu_torch.core.api import get_runtime
        rt = get_runtime()
        if hasattr(rt, "actor_state"):
            return rt.actor_state(self._actor_id)
        return "UNKNOWN"

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._method_meta))

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return (isinstance(other, ActorHandle)
                and other._actor_id == self._actor_id)


class ActorClass:
    """Created by ``@ray_tpu_torch.remote`` on a class; instantiate with
    ``.remote()`` / ``.options(...).remote()``."""

    def __init__(self, cls: type, **default_opts: Any):
        self._cls = cls
        self._default_opts = default_opts
        self._cls_blob: bytes | None = None
        # Per-method num_returns declared via @ray_tpu.method.
        self._method_meta = {
            name: getattr(m, "__ray_tpu_num_returns__")
            for name, m in cls.__dict__.items()
            if hasattr(m, "__ray_tpu_num_returns__")
        }

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self._cls.__name__} cannot be instantiated "
            f"directly; use .remote()")

    def options(self, **opts) -> "ActorClass":
        merged = {**self._default_opts, **opts}
        ac = ActorClass(self._cls, **merged)
        ac._cls_blob = self._cls_blob
        return ac

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch.core.api import get_runtime
        from ray_tpu_torch.core.remote_function import _unwrap_duck_refs
        args, kwargs = _unwrap_duck_refs(args, kwargs)
        rt = get_runtime()
        if self._cls_blob is None:
            self._cls_blob = ser.dumps(self._cls)
        opts = dict(self._default_opts)
        # Actors default to 1 CPU like tasks; num_cpus=0 allowed for
        # lightweight coordination actors.
        options = make_task_options(**opts)
        actor_id = rt.create_actor(
            self._cls_blob, self._cls.__name__, args, kwargs, options,
            name=opts.get("name", "") or "",
            max_restarts=int(opts.get("max_restarts", 0)),
            max_concurrency=int(opts.get("max_concurrency", 1)))
        return ActorHandle(actor_id, self._method_meta)

    def bind(self, *args, **kwargs):
        """Lazily bind actor construction into a DAG."""
        from ray_tpu_torch.dag.dag_node import ClassNode
        return ClassNode(self, args, kwargs)

    @property
    def underlying_class(self) -> type:
        return self._cls
