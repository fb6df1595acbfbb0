"""@remote functions (reference: python/ray/remote_function.py:266)."""

from __future__ import annotations

import functools
from typing import Any

from ray_tpu_torch.core.runtime import TaskOptions


def _build_resources(num_cpus=None, num_gpus=None, resources=None,
                     ) -> dict[str, float]:
    out: dict[str, float] = {}
    out["CPU"] = float(num_cpus) if num_cpus is not None else 1.0
    if num_gpus:
        out["GPU"] = float(num_gpus)
    if resources:
        out.update(resources)
    return out


def _is_duck_ref(o) -> bool:
    # TYPE-level lookup: an instance __getattr__ that answers every
    # probe (mock objects) must not read as a duck-ref.
    return getattr(type(o), "_to_object_ref", None) is not None


def _unwrap_duck_ref(o):
    """One duck-ref (serve DeploymentResponse et al) -> its
    ObjectRef; everything else passes through. THE shared unwrap —
    get/wait/submission all route here."""
    return o._to_object_ref() if _is_duck_ref(o) else o


def _unwrap_duck_refs(args: tuple, kwargs: dict):
    """Duck-refs unwrap to their ObjectRef at submission so the
    runtime's top-level arg resolution sees them."""
    if any(_is_duck_ref(a) for a in args):
        args = tuple(_unwrap_duck_ref(a) for a in args)
    if kwargs and any(_is_duck_ref(v) for v in kwargs.values()):
        kwargs = {k: _unwrap_duck_ref(v) for k, v in kwargs.items()}
    return args, kwargs


def make_task_options(**opts: Any) -> TaskOptions:
    resources = _build_resources(
        opts.get("num_cpus"), opts.get("num_gpus"), opts.get("resources"))
    pg = opts.get("placement_group")
    sched = opts.get("scheduling_strategy", "DEFAULT")
    node_id = ""
    soft = False
    bundle_index = opts.get("placement_group_bundle_index", -1)
    if sched is not None and not isinstance(sched, str):
        if hasattr(sched, "placement_group"):
            # PlacementGroupSchedulingStrategy
            pg = sched.placement_group
            bundle_index = getattr(
                sched, "placement_group_bundle_index", bundle_index)
            sched = "PLACEMENT_GROUP"
        elif hasattr(sched, "node_id"):
            # NodeAffinitySchedulingStrategy
            node_id = sched.node_id
            soft = bool(getattr(sched, "soft", False))
            sched = "NODE_AFFINITY"
        else:
            sched = "DEFAULT"
    return TaskOptions(
        num_returns=opts.get("num_returns", 1),
        resources=resources,
        max_retries=opts.get("max_retries", -1),
        retry_exceptions=bool(opts.get("retry_exceptions", False)),
        name=opts.get("name", ""),
        runtime_env=opts.get("runtime_env"),
        placement_group=pg,
        placement_group_bundle_index=bundle_index,
        scheduling_strategy=sched if isinstance(sched, str) else "DEFAULT",
        node_id=node_id,
        soft=soft,
    )


class RemoteFunction:
    """Handle created by ``@ray_tpu_torch.remote``; call via
    ``.remote()``."""

    def __init__(self, fn, **default_opts):
        self._fn = fn
        self._default_opts = default_opts
        self._fn_id: str | None = None
        self._fn_blob: bytes | None = None
        # Options are identical for every .remote() of this handle —
        # build once and share the instance (nothing mutates it after
        # construction; the tracing path copies before writing).
        self._options_template: TaskOptions | None = None
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._fn.__name__} cannot be called "
            f"directly; use .remote()")

    def options(self, **opts) -> "RemoteFunction":
        merged = {**self._default_opts, **opts}
        rf = RemoteFunction(self._fn, **merged)
        rf._fn_id, rf._fn_blob = self._fn_id, self._fn_blob
        return rf

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.core.api import get_runtime
        args, kwargs = _unwrap_duck_refs(args, kwargs)
        rt = get_runtime()
        if self._fn_id is None:
            self._fn_id, self._fn_blob = rt.register_function(self._fn)
        options = self._options_template
        if options is None:
            options = make_task_options(**self._default_opts)
            if not self._default_opts.get("name"):
                options.name = self._fn.__name__
            self._options_template = options
        from ray_tpu_torch.util.tracing import get_tracer
        tracer = get_tracer()
        if tracer.enabled:
            # Reference: _tracing_task_invocation wraps .remote() and
            # serializes the span context into the task
            # (tracing_helper.py:293).
            import copy
            template = options
            options = copy.copy(options)
            # copy.copy goes through __getstate__, which strips the
            # runtime caches — carry them over so traced submits
            # don't recompute env/sched-class on every call.
            for attr in ("_env_cache", "_sched_cache"):
                v = getattr(template, attr, None)
                if v is not None:
                    setattr(options, attr, v)
            with tracer.span(f"submit::{options.name}"):
                options.trace_ctx = tracer.current_context()
                refs = rt.submit_task(
                    self._fn_id, self._fn_blob, self._fn.__name__,
                    args, kwargs, options)
            # Warm the template from the clone: under always-on
            # tracing the template itself never submits, so without
            # this write-back every call recomputes the caches.
            for attr in ("_env_cache", "_sched_cache"):
                if getattr(template, attr, None) is None:
                    v = getattr(options, attr, None)
                    if v is not None:
                        setattr(template, attr, v)
        else:
            refs = rt.submit_task(self._fn_id, self._fn_blob,
                                  self._fn.__name__, args, kwargs,
                                  options)
        if options.num_returns == "streaming":
            return refs            # ObjectRefGenerator
        return refs[0] if options.num_returns == 1 else refs

    def bind(self, *args, **kwargs):
        """Lazily bind into a DAG (reference: dag_node.py bind)."""
        from ray_tpu_torch.dag.dag_node import FunctionNode
        return FunctionNode(self, args, kwargs)

    @property
    def underlying_function(self):
        return self._fn
