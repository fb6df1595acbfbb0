"""Serve public API: @deployment, bind, run, handles.

Reference analog: python/ray/serve/api.py (serve.run at :510) and the
deployment-graph build: ``A.bind(x)`` produces an Application node;
``serve.run`` deploys the node's dependency tree bottom-up (nested
binds become their own deployments whose handles are injected as init
args — model composition, deployment_graph_build.py).
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import ray_tpu_torch
from ray_tpu_torch.core import serialization as ser
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.router import Router

_proxy = None
_proxy_port: int | None = None
_grpc_proxy = None
_grpc_proxy_port: int | None = None
_GRPC_TOKEN_KV = (b"grpc_ingress_token", "_ray_tpu_serve")


def grpc_ingress_token() -> str:
    """Token gRPC clients must present (``ray-auth-token`` metadata)
    to send pickle payloads through the ingress.

    One-way HMAC derivation from the cluster token: any cluster
    member can compute it, but handing it to a semi-trusted gRPC
    client does NOT disclose the cluster authkey itself (which would
    let the holder join the cluster as a full member). Recomputed on
    every call so a shutdown/re-init cycle with a new cluster token
    yields the new ingress token, not a stale cache.

    Worker processes dial the head over a unix socket with no
    authkey, so they can't derive the token locally — ``serve.run``
    publishes it to internal KV and they read it from there. JSON
    payloads need no token."""
    import hmac as _hmac

    from ray_tpu_torch.core.api import get_runtime_or_none
    rt = get_runtime_or_none()
    tok = (getattr(rt, "cluster_token", None)
           or getattr(rt, "_token", None))
    if isinstance(tok, str):
        tok = tok.encode()
    if tok:
        return _hmac.new(bytes(tok), b"ray-tpu-grpc-ingress",
                         "sha256").hexdigest()
    if rt is not None:
        from ray_tpu_torch.experimental import internal_kv
        v = internal_kv._kv_get(_GRPC_TOKEN_KV[0],
                                namespace=_GRPC_TOKEN_KV[1])
        if v:
            return v.decode()
    raise RuntimeError(
        "grpc_ingress_token() needs a cluster token: call it after "
        "ray_tpu_torch.init() on the driver, or after serve.run(grpc_port=…) "
        "from any cluster process (the token is published to internal "
        "KV then). Returning a made-up token would just fail "
        "UNAUTHENTICATED at the proxy.")


@dataclass
class Deployment:
    cls: type
    name: str
    num_replicas: int = 1
    ray_actor_options: dict = field(default_factory=dict)
    user_config: Any = None
    autoscaling_config: dict | None = None
    # Bounded per-replica queue (reference: max_ongoing_requests): a
    # replica already holding this many requests sheds new ones back
    # to the router. None = config serve_max_queue_len_per_replica.
    max_ongoing_requests: int | None = None

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def options(self, *, num_replicas: int | None = None,
                name: str | None = None,
                ray_actor_options: dict | None = None,
                autoscaling_config: dict | None = None,
                user_config=None,
                max_ongoing_requests: int | None = None) -> "Deployment":
        return Deployment(
            cls=self.cls,
            name=name or self.name,
            num_replicas=num_replicas or self.num_replicas,
            ray_actor_options=ray_actor_options
            or self.ray_actor_options,
            user_config=(self.user_config if user_config is None
                         else user_config),
            autoscaling_config=autoscaling_config
            or self.autoscaling_config,
            max_ongoing_requests=(self.max_ongoing_requests
                                  if max_ongoing_requests is None
                                  else max_ongoing_requests))


@dataclass
class Application:
    deployment: Deployment
    init_args: tuple
    init_kwargs: dict


class DeploymentResponse:
    """The future a handle call returns (reference:
    serve.handle.DeploymentResponse): ``.result(timeout_s=...)``
    blocks for the value; ``ray_tpu_torch.get(response)``/``wait`` and
    top-level task/actor arguments unwrap to the underlying
    ObjectRef, and a response passed to ANOTHER handle call resolves
    to its VALUE in the replica (composition) — while user-passed
    plain ObjectRefs keep their ref contract."""

    _SENTINEL = object()

    def __init__(self, ref, retry_ctx=None):
        self._ref = ref
        self._retry_ctx = retry_ctx
        self._value = self._SENTINEL
        if retry_ctx is not None:
            import weakref
            # A response dropped without .result() (fire-and-forget)
            # must still release its router pending-count slot.
            self._finalizer = weakref.finalize(self, retry_ctx.finish)

    def result(self, timeout_s: float | None = None):
        """Block for the response value. With the retry plane on, a
        first dispatch that failed retryably (replica died / was
        stopping / shed the request) is re-dispatched under the same
        request id — the replica-side ledger guarantees at most one
        execution per replica even when the original call actually
        finished."""
        if self._value is not self._SENTINEL:
            return self._value
        ctx = self._retry_ctx
        try:
            out = ray_tpu_torch.get(self._ref, timeout=timeout_s)
            if ctx is not None:
                ctx.finish()
            self._value = out
            return out
        except Exception as e:
            if ctx is None:
                raise
            from ray_tpu_torch.serve.exceptions import is_retryable
            if not is_retryable(e):
                ctx.finish()
                raise
            out = ctx.retry(e, timeout=timeout_s)
            self._value = out
            return out

    def __await__(self):
        """``await response`` in async code, a replica's composition
        among it (reference: DeploymentResponse is awaitable):
        :meth:`result` on the running loop's default executor, so the
        loop goes on serving while the call is out."""
        import asyncio
        return asyncio.get_running_loop().run_in_executor(
            None, self.result).__await__()

    def _to_object_ref(self):
        # Raw-ref unwrap (ray_tpu_torch.get(response) / wait / composition
        # args): single-attempt — the retry plane rides .result() and
        # the proxies; a raw ref has no replay context.
        return self._ref

    def __reduce__(self):
        # TYPE-PRESERVING: replicas must distinguish a composition
        # response (resolve to value before user code) from a user-
        # passed ObjectRef (pass through untouched). Top-level task/
        # actor args never reach here — submission unwraps duck-refs
        # first.
        return (DeploymentResponse, (self._ref,))

    def __repr__(self):
        return f"DeploymentResponse({self._ref!r})"


class DeploymentHandle:
    """Client handle routing to a deployment's replicas (reference:
    handle.py:710). ``handle.remote(...)`` and
    ``handle.method.remote(...)`` return
    :class:`DeploymentResponse` futures (streaming calls return the
    generator directly)."""

    def __init__(self, deployment_name: str, controller=None,
                 multiplexed_model_id: str = "", stream: bool = False):
        self._name = deployment_name
        self._controller = controller or ray_tpu_torch.get_actor(
            CONTROLLER_NAME)
        self._router = Router.for_deployment(
            self._controller, deployment_name)
        self._model_id = multiplexed_model_id
        self._stream = stream

    def options(self, *, multiplexed_model_id: str | None = None,
                stream: bool | None = None) -> "DeploymentHandle":
        """Unspecified options inherit from THIS handle, so
        .options(multiplexed_model_id=...).options(stream=True)
        composes instead of resetting."""
        h = DeploymentHandle(
            self._name, self._controller,
            multiplexed_model_id=(self._model_id
                                  if multiplexed_model_id is None
                                  else multiplexed_model_id),
            stream=self._stream if stream is None else stream)
        h._router = self._router     # share replica cache
        return h

    def remote(self, *args, **kwargs):
        out, ctx = self._router.assign_ctx(
            "__call__", args, kwargs,
            multiplexed_model_id=self._model_id,
            stream=self._stream)
        return out if self._stream else DeploymentResponse(out, ctx)

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)

        class _Method:
            def __init__(self, outer, name):
                self._outer = outer
                self._name = name

            def remote(self, *args, **kwargs):
                out, ctx = self._outer._router.assign_ctx(
                    self._name, args, kwargs,
                    multiplexed_model_id=self._outer._model_id,
                    stream=self._outer._stream)
                return out if self._outer._stream \
                    else DeploymentResponse(out, ctx)

        return _Method(self, method)

    def __reduce__(self):
        return (DeploymentHandle,
                (self._name, None, self._model_id, self._stream))


def deployment(cls: type | None = None, *, name: str | None = None,
               num_replicas: int = 1,
               ray_actor_options: dict | None = None,
               autoscaling_config: dict | None = None,
               user_config=None,
               max_ongoing_requests: int | None = None):
    """Decorator turning a class (or function) into a Deployment."""
    def wrap(target):
        return Deployment(
            cls=target, name=name or target.__name__,
            num_replicas=num_replicas,
            ray_actor_options=ray_actor_options or {},
            user_config=user_config,
            autoscaling_config=autoscaling_config,
            max_ongoing_requests=max_ongoing_requests)
    if cls is not None:
        return wrap(cls)
    return wrap


def _ensure_controller():
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        controller = None
    if controller is not None:
        from ray_tpu_torch.core.exceptions import ActorDiedError
        try:
            ray_tpu_torch.get(controller.list_deployments.remote(),
                        timeout=30)
            return controller
        except ActorDiedError:
            # A controller that was killed (shutdown(), crash) can
            # still hold the name for a beat — death observation is
            # async. Wait it out, then start fresh.
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                try:
                    ray_tpu_torch.get_actor(CONTROLLER_NAME)
                except ValueError:
                    break
                time.sleep(0.05)
    return ServeController.options(
        name=CONTROLLER_NAME, num_cpus=0,
        max_concurrency=16).remote()


def _deploy_tree(app: Application, controller,
                 root_name: str | None = None) -> str:
    """Deploy nested Applications depth-first; replace them with
    DeploymentHandles in the parent's init args. ``root_name``
    overrides the ROOT (ingress) deployment's name — the
    serve.run(name=...) application name (apps and their ingress
    deployments share a name here)."""
    def resolve(v):
        if isinstance(v, Application):
            child = _deploy_tree(v, controller)
            return DeploymentHandle(child, controller)
        return v

    args = tuple(resolve(a) for a in app.init_args)
    kwargs = {k: resolve(v) for k, v in app.init_kwargs.items()}
    d = app.deployment
    name = root_name or d.name
    if d.user_config is not None and not callable(
            getattr(d.cls, "reconfigure", None)):
        # eager, driver-side (reference validates at deployment
        # creation): a replica crash-loop is the silent alternative
        raise ValueError(
            f"deployment {name!r} has a user_config but "
            f"{getattr(d.cls, '__name__', d.cls)!r} defines no "
            f"reconfigure(config) method")
    resources = dict(d.ray_actor_options.get("resources", {}))
    if "num_cpus" in d.ray_actor_options:
        resources["CPU"] = d.ray_actor_options["num_cpus"]
    if "num_tpus" in d.ray_actor_options:
        raise ValueError(
            f"deployment {name!r}: ray_actor_options['num_tpus'] names the "
            f"JAX package's TPU resource; a replica that holds a card asks "
            f"for num_gpus")
    if "num_gpus" in d.ray_actor_options:
        resources["GPU"] = d.ray_actor_options["num_gpus"]
    ray_tpu_torch.get(controller.deploy.remote(
        name, ser.dumps(d.cls), args, kwargs, d.num_replicas,
        resources, d.autoscaling_config, d.user_config,
        d.max_ongoing_requests), timeout=120)
    return name


def run(app: Application, *, name: str | None = None,
        route_prefix: str = "/",
        http_port: int | None = None,
        grpc_port: int | None = None,
        blocking: bool = False) -> DeploymentHandle:
    global _proxy, _proxy_port, _grpc_proxy, _grpc_proxy_port
    controller = _ensure_controller()
    name = _deploy_tree(app, controller, root_name=name)
    # Wait until the deployment is fully up: readiness gating keeps a
    # spawned replica OUT of the routing set until its first healthy
    # probe, so "non-empty" alone would return with stragglers still
    # starting. Settle for partial availability only at the deadline.
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        info = ray_tpu_torch.get(
            controller.list_deployments.remote()).get(name, {})
        if info.get("num_replicas", 0) >= info.get("desired", 1) \
                and not info.get("starting", 0):
            break
        time.sleep(0.1)
    from ray_tpu_torch.serve.asgi import ASGI_MARKER
    is_asgi = bool(getattr(app.deployment.cls, ASGI_MARKER, False))
    route_entry = {"name": name, "asgi": is_asgi}
    if http_port is not None:
        if _proxy is None or _proxy_port != http_port:
            from ray_tpu_torch.serve.proxy import ProxyActor
            _proxy = ProxyActor.options(
                num_cpus=0, max_concurrency=32).remote(http_port)
            _proxy_port = http_port
            ray_tpu_torch.get(_proxy.ready.remote(), timeout=30)
        routes = {route_prefix: route_entry}
        ray_tpu_torch.get(_proxy.set_routes.remote(routes))
    if grpc_port is not None:
        # gRPC ingress (reference: gRPCProxy, proxy.py:545) sharing
        # the router/replica path with HTTP.
        if _grpc_proxy is None or _grpc_proxy_port != grpc_port:
            from ray_tpu_torch.serve.grpc_proxy import GRPCProxyActor
            token = grpc_ingress_token()
            # Publish for worker/replica processes, which can't
            # derive it (no authkey on the unix-socket path).
            from ray_tpu_torch.experimental import internal_kv
            internal_kv._kv_put(_GRPC_TOKEN_KV[0], token.encode(),
                                namespace=_GRPC_TOKEN_KV[1])
            _grpc_proxy = GRPCProxyActor.options(
                num_cpus=0, max_concurrency=32).remote(
                    grpc_port, auth_token=token)
            _grpc_proxy_port = grpc_port
            ray_tpu_torch.get(_grpc_proxy.ready.remote(), timeout=30)
        routes = {route_prefix: name}
        ray_tpu_torch.get(_grpc_proxy.set_routes.remote(routes))
    handle = DeploymentHandle(name, controller)
    if blocking:
        while True:
            time.sleep(1)
    return handle


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def get_app_handle(name: str) -> DeploymentHandle:
    """Handle to a running application's ingress deployment
    (reference: serve.get_app_handle; applications and their ingress
    deployments share a name here)."""
    return DeploymentHandle(name)


@dataclass
class HTTPOptions:
    """HTTP proxy options (reference: serve.config.HTTPOptions).
    Honored fields: ``host`` and ``port`` (the proxy binds them);
    ``location="NoServer"`` skips the proxy; ``request_timeout_s``
    becomes the default end-to-end deadline for every request through
    the proxy (per-request ``X-Request-Timeout-S`` headers override
    it). The remaining reference fields are accepted for signature
    compatibility and recorded but have no effect in this proxy."""

    host: str = "127.0.0.1"
    port: int = 8000
    root_path: str = ""
    request_timeout_s: float | None = None
    keep_alive_timeout_s: float = 5.0
    location: str = "HeadOnly"


def start(*, http_port: int | None = None,
          grpc_port: int | None = None,
          http_options: HTTPOptions | dict | None = None) -> None:
    """Boot the serve control plane (controller + optional proxies)
    without deploying anything (reference: serve.start) — idempotent;
    later serve.run/deploy_config calls attach to it."""
    global _proxy, _proxy_port, _grpc_proxy, _grpc_proxy_port
    _ensure_controller()
    host = "127.0.0.1"
    request_timeout_s = None
    if http_options is not None:
        if isinstance(http_options, dict):
            http_options = HTTPOptions(**http_options)
        if http_options.location == "NoServer":
            # NoServer wins over an http_port argument: no proxy.
            http_port = None
        else:
            host = http_options.host
            request_timeout_s = http_options.request_timeout_s
            if http_port is None:
                http_port = http_options.port
    if http_port is not None and _proxy is not None \
            and _proxy_port == http_port and host != "127.0.0.1":
        raise ValueError(
            f"an HTTP proxy is already bound on port {http_port} "
            f"(host 127.0.0.1); serve.shutdown() first to rebind on "
            f"{host!r}")
    if http_port is not None and (_proxy is None
                                  or _proxy_port != http_port):
        from ray_tpu_torch.serve.proxy import ProxyActor
        _proxy = ProxyActor.options(
            num_cpus=0, max_concurrency=32).remote(
                http_port, host, request_timeout_s=request_timeout_s)
        _proxy_port = http_port
        ray_tpu_torch.get(_proxy.ready.remote(), timeout=30)
    if grpc_port is not None and (_grpc_proxy is None
                                  or _grpc_proxy_port != grpc_port):
        from ray_tpu_torch.serve.grpc_proxy import GRPCProxyActor
        from ray_tpu_torch.experimental import internal_kv
        token = grpc_ingress_token()
        internal_kv._kv_put(_GRPC_TOKEN_KV[0], token.encode(),
                            namespace=_GRPC_TOKEN_KV[1])
        _grpc_proxy = GRPCProxyActor.options(
            num_cpus=0, max_concurrency=32).remote(
                grpc_port, auth_token=token)
        _grpc_proxy_port = grpc_port
        ray_tpu_torch.get(_grpc_proxy.ready.remote(), timeout=30)


def delete(name: str, *, timeout: float = 30.0) -> bool:
    """Remove a deployment/application: replicas drain then die
    (reference: serve.delete). Returns False for an unknown name."""
    controller = _ensure_controller()
    ok = ray_tpu_torch.get(controller.delete_deployment.remote(name),
                     timeout=timeout)
    if ok:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if name not in ray_tpu_torch.get(
                    controller.list_deployments.remote(),
                    timeout=10):
                break
            time.sleep(0.1)
    return bool(ok)


_CONFIG_APPS_KV = (b"serve:config_apps", "serve")


def deploy_config(config, *, _import_override: Callable | None = None):
    """Declarative deploy (reference: ``serve deploy config.yaml`` —
    serve/scripts.py + schema.py): reconcile the cluster's Serve apps
    to a config. Apps present in the config are (re)deployed with
    their overrides; apps deployed by a PREVIOUS config but absent
    from this one are deleted — their replicas drain through the
    controller's normal reconciliation.

    ``config``: a path to a YAML file, a dict, or a
    ``ServeDeploySchema``. ``_import_override(app_schema)`` lets
    tests supply bound Applications without real module imports.
    Returns {app_name: DeploymentHandle}.
    """
    from ray_tpu_torch.experimental import internal_kv
    from ray_tpu_torch.serve.schema import (
        ServeDeploySchema, load_config, parse_config,
    )

    if isinstance(config, str):
        schema = load_config(config)
    elif isinstance(config, dict):
        schema = parse_config(config)
    elif isinstance(config, ServeDeploySchema):
        schema = config
    else:
        raise TypeError(f"deploy_config: unsupported {type(config)}")

    http_port = schema.http_options.get("port")
    grpc_port = schema.grpc_options.get("port")
    if schema.http_options and http_port is not None:
        # Boot the HTTP proxy through start() so http_options beyond
        # the port (host, request_timeout_s) take effect; run() below
        # reuses the proxy it finds bound on that port.
        start(http_options=schema.http_options)
    handles: dict[str, DeploymentHandle] = {}
    deployed_names: set[str] = set()
    for app_schema in schema.applications:
        target = (_import_override(app_schema)
                  if _import_override is not None
                  else app_schema.import_target())
        if isinstance(target, Deployment):
            target = target.bind()
        if not isinstance(target, Application):
            raise ValueError(
                f"applications[{app_schema.name}].import_path "
                f"{app_schema.import_path!r} resolved to "
                f"{type(target).__name__}; expected a bound "
                f"Application (Deployment.bind(...)) or a Deployment")
        target = _apply_overrides(target, app_schema)
        handles[app_schema.name] = run(
            target, route_prefix=app_schema.route_prefix,
            http_port=http_port, grpc_port=grpc_port)
        deployed_names.update(_tree_names(target))

    # Reconcile deletions: deployments owned by the previous config
    # that this config no longer mentions drain away.
    prev_raw = internal_kv._kv_get(_CONFIG_APPS_KV[0],
                                   namespace=_CONFIG_APPS_KV[1])
    if prev_raw:
        import json as _json
        stale = set(_json.loads(prev_raw)) - deployed_names
        if stale:
            controller = _ensure_controller()
            for name in sorted(stale):
                ray_tpu_torch.get(
                    controller.delete_deployment.remote(name),
                    timeout=60)
    import json as _json
    internal_kv._kv_put(
        _CONFIG_APPS_KV[0],
        _json.dumps(sorted(deployed_names)).encode(),
        namespace=_CONFIG_APPS_KV[1])
    return handles


def _tree_names(app: Application) -> set[str]:
    out = {app.deployment.name}
    for v in list(app.init_args) + list(app.init_kwargs.values()):
        if isinstance(v, Application):
            out |= _tree_names(v)
    return out


def _apply_overrides(app: Application, app_schema) -> Application:
    """Apply per-deployment config overrides through the whole
    composition tree."""
    by_name = {o.name: o for o in app_schema.deployments}

    def walk(a: Application) -> Application:
        args = tuple(walk(v) if isinstance(v, Application) else v
                     for v in a.init_args)
        kwargs = {k: walk(v) if isinstance(v, Application) else v
                  for k, v in a.init_kwargs.items()}
        d = a.deployment
        o = by_name.get(d.name)
        if o is not None:
            d = d.options(
                num_replicas=o.num_replicas,
                ray_actor_options=o.ray_actor_options,
                autoscaling_config=o.autoscaling_config,
                max_ongoing_requests=o.max_ongoing_requests)
            if o.user_config is not None:
                d.user_config = o.user_config
        return Application(d, args, kwargs)

    return walk(app)


def status() -> dict:
    """Cluster Serve status (reference: ``serve status``): per
    deployment, live vs desired replica counts."""
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return {"deployments": {}, "controller": "NOT_RUNNING"}
    deployments = ray_tpu_torch.get(controller.list_deployments.remote(),
                              timeout=30)
    for name, info in deployments.items():
        info["status"] = ("HEALTHY"
                         if info["num_replicas"] >= info["desired"]
                         else "UPDATING")
    return {"deployments": deployments, "controller": "RUNNING"}


def shutdown() -> None:
    global _proxy, _proxy_port, _grpc_proxy, _grpc_proxy_port
    from ray_tpu_torch.serve.router import LongPollClient, Router
    LongPollClient.shutdown_all()   # stop this process's poll thread
    with Router._cache_lock:
        Router._cache.clear()
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        ray_tpu_torch.get(controller.graceful_shutdown.remote(), timeout=30)
        ray_tpu_torch.kill(controller)
        # Block until the name unregisters (death observation is
        # async): a serve.run() immediately after shutdown() must get
        # a fresh controller, not a handle to the dying one.
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                ray_tpu_torch.get_actor(CONTROLLER_NAME)
            except ValueError:
                break
            time.sleep(0.05)
    except ValueError:
        pass
    if _proxy is not None:
        try:
            ray_tpu_torch.kill(_proxy)
        except Exception:  # noqa: BLE001
            pass
        _proxy = None
        _proxy_port = None
    if _grpc_proxy is not None:
        try:
            ray_tpu_torch.kill(_grpc_proxy)
        except Exception:  # noqa: BLE001
            pass
        _grpc_proxy = None
        _grpc_proxy_port = None


_batch_init_lock = None  # created lazily per process (picklability)


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Request batching decorator (reference: serve.batching): queued
    single calls coalesce into one list-call of the wrapped method —
    on the card this turns N requests into one batched forward.

    The wrapped method runs in the batch's worker thread, not in the
    caller's: thread-local state such as torch's grad mode does not
    reach it, so enter ``torch.inference_mode()`` inside the method.

    All state (queue + worker thread) is created lazily per instance in
    the replica process, so decorated classes stay picklable.
    """

    def wrap(fn):
        attr = f"__serve_batch_state_{fn.__name__}"

        @functools.wraps(fn)
        def inner(self, single_arg):
            import queue as queue_mod
            import threading

            global _batch_init_lock
            if _batch_init_lock is None:
                _batch_init_lock = threading.Lock()
            state = getattr(self, attr, None)
            if state is None:
                with _batch_init_lock:
                    state = getattr(self, attr, None)
                    if state is None:
                        state = {"q": queue_mod.Queue()}

                        def worker():
                            q = state["q"]
                            while True:
                                items = [q.get()]
                                deadline = (time.monotonic()
                                            + batch_wait_timeout_s)
                                while len(items) < max_batch_size:
                                    remaining = (deadline
                                                 - time.monotonic())
                                    if remaining <= 0:
                                        break
                                    try:
                                        items.append(
                                            q.get(timeout=remaining))
                                    except queue_mod.Empty:
                                        break
                                args = [it[0] for it in items]
                                events = [it[1] for it in items]
                                slots = [it[2] for it in items]
                                try:
                                    results = fn(self, args)
                                    for s, e, r in zip(slots, events,
                                                       results):
                                        s.append((True, r))
                                        e.set()
                                except Exception as exc:  # noqa: BLE001
                                    for s, e in zip(slots, events):
                                        s.append((False, exc))
                                        e.set()

                        threading.Thread(target=worker,
                                         daemon=True).start()
                        setattr(self, attr, state)
            event = threading.Event()
            slot: list = []
            state["q"].put((single_arg, event, slot))
            event.wait(60)
            ok, result = slot[0]
            if not ok:
                raise result
            return result

        return inner

    if _fn is not None:
        return wrap(_fn)
    return wrap
