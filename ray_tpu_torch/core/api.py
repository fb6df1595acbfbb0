"""Public core API (reference L4: ray.init/get/put/wait/remote)."""

from __future__ import annotations

import atexit
import threading
from typing import Any, Sequence

from ray_tpu_torch.core.actor import ActorClass, ActorHandle
from ray_tpu_torch.core.config import Config, set_config, reset_config
from ray_tpu_torch.core.exceptions import RuntimeNotInitializedError
from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.remote_function import RemoteFunction

_runtime = None
_runtime_lock = threading.Lock()
_actor_context: ActorID | None = None


def _set_runtime(rt) -> None:
    global _runtime
    _runtime = rt


def _set_actor_context(actor_id: ActorID) -> None:
    global _actor_context
    _actor_context = actor_id


# Per-execution task context (reference: runtime_context.get_task_id /
# get_current_placement_group). A ContextVar, not threading.local:
# actor max_concurrency>1 runs calls on executor threads (each thread
# has its own context) AND async actor methods interleave as asyncio
# tasks on one shared loop (each task gets a context copy — a
# thread-local on the loop thread would bleed between coroutines).
import contextvars as _contextvars

_task_ctx: "_contextvars.ContextVar[tuple | None]" = \
    _contextvars.ContextVar("ray_tpu_task_ctx", default=None)
_actor_pg = None  # the PG the hosting actor was placed under


def _set_task_context(task_id_bytes: bytes | None, pg=None) -> None:
    _task_ctx.set((task_id_bytes, pg))


def _clear_task_context() -> None:
    _task_ctx.set(None)


def _current_task_id() -> bytes | None:
    v = _task_ctx.get()
    return v[0] if v else None


def _current_task_pg():
    v = _task_ctx.get()
    return v[1] if v else None


def _set_actor_pg(pg) -> None:
    global _actor_pg
    _actor_pg = pg


def _current_actor_pg():
    return _actor_pg


def get_runtime():
    if _runtime is None:
        raise RuntimeNotInitializedError()
    return _runtime


def get_runtime_or_none():
    return _runtime


def is_initialized() -> bool:
    return _runtime is not None


def init(num_cpus: int | None = None,
         num_gpus: int | None = None,
         resources: dict[str, float] | None = None,
         local_mode: bool = False,
         ignore_reinit_error: bool = False,
         runtime_env: dict[str, Any] | None = None,
         address: str | None = None,
         log_to_driver: bool = True,
         logging_config=None,
         object_store_memory: int | None = None,
         namespace: str | None = None,
         include_dashboard: bool | None = None,
         dashboard_port: int | None = None,
         cluster_token: str | bytes | None = None,
         _system_config: dict[str, Any] | None = None):
    """Start the runtime's head in this process (driver), or — with
    ``address`` — connect this process as a CLIENT of a running head
    (the Ray Client analog, ``ray.init("ray://...")``): the full API
    proxies over the head's socket, so a separate script can submit
    tasks, create actors and read objects on a live cluster.

    ``address`` is the head's ``runtime.sock`` path
    (``client_address()`` on the head, or under
    ``ray_tpu_torch_sessions/<pid>/`` in the temporary directory), a
    head daemon's ``host:port`` (``core/head.py``; the token in
    ``cluster_token`` or ``RAY_TPU_CLUSTER_TOKEN``), or "auto" for the
    newest live session on this host (``RAY_TPU_ADDRESS`` first).

    ``num_gpus`` is the head node's ``GPU`` resource; by default the
    cards this process may use (``core.accelerator.detect_gpu_count``,
    which puts nothing on the card). A task or actor that asks for no
    GPU runs in a worker that sees none (``CUDA_VISIBLE_DEVICES=""``);
    one that asks for GPU sees the cards the scheduler gave it and no
    other. The session's socket and worker logs live under
    ``ray_tpu_torch_sessions/<pid>/`` in the temporary directory.

    ``include_dashboard`` starts the dashboard head
    (``dashboard.start_dashboard``) on ``dashboard_port`` (8265 by
    default; 0 picks a free one), reached through
    ``get_runtime()._dashboard``; ``shutdown()`` stops it. A dashboard
    that cannot bind its port fails ``init``, and the session with it.

    Reference analog: ``ray.init`` (python/ray/_private/worker.py:1240).
    ``_system_config`` injects config overrides for the whole session —
    same test pattern as the reference's conftest injection.
    """
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            if ignore_reinit_error:
                return _runtime
            raise RuntimeError(
                "ray_tpu_torch.init() called twice; pass "
                "ignore_reinit_error=True to allow")
        if logging_config is not None:
            # Apply on the driver AND export to os.environ so spawned
            # workers inherit it (worker_entry applies it).
            logging_config._apply()
            logging_config._export_env()
        if namespace is not None:
            import warnings
            warnings.warn(
                "ray_tpu_torch has no actor namespaces: named actors are "
                "cluster-global; namespace=%r is ignored" % namespace,
                stacklevel=2)
        if address is not None:
            bad = {"num_cpus": num_cpus, "num_gpus": num_gpus,
                   "object_store_memory": object_store_memory,
                   "include_dashboard": include_dashboard,
                   "resources": resources,
                   "_system_config": _system_config}
            passed = [k for k, v in bad.items() if v]
            if local_mode:
                passed.append("local_mode")
            if passed:
                raise ValueError(
                    f"init(address=...) connects to an existing head; "
                    f"{', '.join(passed)} configure a NEW cluster and "
                    f"would be silently ignored — remove them or drop "
                    f"address")
            if runtime_env:
                # Client-default env for every task/actor this client
                # submits without its own. Validate BEFORE dialing so
                # a bad env doesn't leak a connection.
                from ray_tpu_torch.runtime_env import validate_runtime_env
                validate_runtime_env(runtime_env)
            from ray_tpu_torch.core.worker import ClientRuntime
            token = cluster_token
            if token is None:
                import os
                token = os.environ.get("RAY_TPU_CLUSTER_TOKEN")
            if isinstance(token, str):
                token = bytes.fromhex(token)
            _runtime = ClientRuntime(_resolve_address(address),
                                     token=token)
            if runtime_env:
                _runtime.default_runtime_env = dict(runtime_env)
            atexit.register(_shutdown_at_exit)
            return _runtime
        if num_gpus is not None and resources and "GPU" in resources \
                and resources["GPU"] != float(num_gpus):
            raise ValueError(
                f"num_gpus={num_gpus} conflicts with "
                f"resources['GPU']={resources['GPU']}")
        if object_store_memory is not None:
            _system_config = dict(_system_config or {})
            prior = _system_config.get("object_store_memory")
            if prior is not None and prior != int(object_store_memory):
                raise ValueError(
                    f"object_store_memory={object_store_memory} "
                    f"conflicts with _system_config"
                    f"['object_store_memory']={prior}")
            _system_config["object_store_memory"] = \
                int(object_store_memory)
        cfg = Config.from_env(_system_config)
        set_config(cfg)
        from ray_tpu_torch.core.runtime import DriverRuntime
        if runtime_env:
            from ray_tpu_torch.runtime_env import validate_runtime_env
            validate_runtime_env(runtime_env)
        _runtime = DriverRuntime(
            cfg, num_cpus=num_cpus, num_gpus=num_gpus,
            resources=resources, local_mode=local_mode,
            runtime_env=runtime_env, log_to_driver=log_to_driver)
        if include_dashboard:
            from ray_tpu_torch.dashboard.head import start_dashboard
            try:
                # kept on the runtime: callers reach the bound port
                # via get_runtime()._dashboard.port
                _runtime._dashboard = start_dashboard(
                    port=dashboard_port
                    if dashboard_port is not None else 8265)
            except BaseException:
                rt, _runtime = _runtime, None
                reset_config()
                rt.shutdown()
                raise
        atexit.register(_shutdown_at_exit)
        return _runtime


def _resolve_address(address: str) -> str:
    if address != "auto":
        return address
    import glob
    import os

    from ray_tpu_torch.core.runtime import session_root
    # Explicit override first (reference: RAY_ADDRESS).
    env = os.environ.get("RAY_TPU_ADDRESS")
    if env:
        return env
    live: list[tuple[str, int]] = []
    for sock in sorted(glob.glob(f"{session_root()}/*/runtime.sock"),
                       key=os.path.getmtime, reverse=True):
        # Liveness: the session dir is named by the head's pid.
        pid = os.path.basename(os.path.dirname(sock))
        if pid.isdigit() and os.path.exists(f"/proc/{pid}"):
            live.append((sock, int(pid)))
    # Prefer a session whose head is an ANCESTOR of this process: a
    # script spawned by a driver must find THAT driver, not whichever
    # concurrent session on the host touched its socket last.
    ancestors = set()
    pid = os.getpid()
    for _ in range(64):
        try:
            with open(f"/proc/{pid}/stat", "rb") as f:
                stat = f.read()
            # field 4 (ppid) sits after the parenthesized comm, which
            # may itself contain spaces.
            pid = int(stat[stat.rindex(b")") + 2:].split()[1])
        except (OSError, ValueError, IndexError):
            break
        if pid <= 1:
            break
        ancestors.add(pid)
    for sock, pid in live:
        if pid in ancestors:
            return sock
    if live:
        return live[0][0]
    raise ConnectionError(
        "address='auto': no live ray_tpu_torch session found on this host")


def client_address() -> str:
    """The unix-socket address remote clients connect to
    (``init(address=...)``)."""
    return get_runtime().client_address


def _shutdown_at_exit():
    try:
        shutdown()
    except Exception:  # noqa: BLE001
        pass


def shutdown() -> None:
    global _runtime
    with _runtime_lock:
        if _runtime is None:
            return
        rt = _runtime
        _runtime = None
        reset_config()
    dash = getattr(rt, "_dashboard", None)
    if dash is not None:
        try:  # init(include_dashboard=True) owns this server
            dash.stop()
        except Exception:  # noqa: BLE001
            pass
    rt.shutdown()


def remote(*args, **kwargs):
    """Decorator: turn a function into a RemoteFunction or a class into
    an ActorClass. Usable bare (``@remote``) or with options
    (``@remote(num_cpus=2)``)."""
    if len(args) == 1 and not kwargs and callable(args[0]):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target)
        return RemoteFunction(target)
    if args:
        raise TypeError("remote() takes keyword options only")

    def decorator(target):
        if isinstance(target, type):
            return ActorClass(target, **kwargs)
        return RemoteFunction(target, **kwargs)

    return decorator


def method(num_returns: int = 1):
    """Decorator for actor methods declaring multiple returns
    (reference: ray.method)."""
    def decorator(fn):
        fn.__ray_tpu_num_returns__ = num_returns
        return fn
    return decorator


def put(value) -> ObjectRef:
    return get_runtime().put(value)


def get(refs, timeout: float | None = None):
    # Duck-refs (serve DeploymentResponse) unwrap to their ObjectRef.
    from ray_tpu_torch.core.remote_function import (
        _is_duck_ref, _unwrap_duck_ref,
    )
    if _is_duck_ref(refs):
        refs = refs._to_object_ref()
    elif isinstance(refs, (list, tuple)) and any(
            _is_duck_ref(r) for r in refs):
        refs = [_unwrap_duck_ref(r) for r in refs]
    # Channel-mode compiled DAGs hand back CompiledDAGRefs (values ride
    # shm channels, not the object store) — unwrap them here so
    # ``ray.get(dag.execute(x))`` works across both modes.
    from ray_tpu_torch.dag.compiled_dag import CompiledDAGRef
    if isinstance(refs, CompiledDAGRef):
        return refs.get(timeout)
    if isinstance(refs, (list, tuple)) and any(
            isinstance(r, CompiledDAGRef) for r in refs):
        return [r.get(timeout) if isinstance(r, CompiledDAGRef)
                else get_runtime().get(r, timeout) for r in refs]
    return get_runtime().get(refs, timeout)


def wait(refs: Sequence[ObjectRef], num_returns: int = 1,
         timeout: float | None = None):
    from ray_tpu_torch.core.remote_function import _unwrap_duck_ref
    refs = [_unwrap_duck_ref(r) for r in refs]
    return get_runtime().wait(list(refs), num_returns, timeout)


def get_gpu_ids() -> list:
    """Ids of the cards this process holds (reference:
    ray.get_gpu_ids): [] in a worker that holds no ``GPU``, the cards
    the scheduler gave a GPU-holding worker, every card in the driver
    (see core/accelerator.py)."""
    from ray_tpu_torch.core.accelerator import get_gpu_ids as _g
    return _g()


def cancel(ref: ObjectRef, force: bool = False) -> None:
    get_runtime().cancel(ref, force)


def kill(handle: ActorHandle, no_restart: bool = True) -> None:
    get_runtime().kill_actor(handle.actor_id, no_restart)


def get_actor(name: str, namespace: str | None = None) -> ActorHandle:
    """(reference: ray.get_actor) ``namespace`` is accepted for
    signature compatibility and warned about — named actors are
    cluster-global here (same contract as init(namespace=...))."""
    if namespace is not None:
        import warnings
        warnings.warn(
            "ray_tpu_torch has no actor namespaces: named actors are "
            "cluster-global; namespace=%r is ignored" % namespace,
            stacklevel=2)
    actor_id = get_runtime().get_named_actor(name)
    return ActorHandle(actor_id)


def available_resources() -> dict[str, float]:
    return get_runtime().available_resources()


def cluster_resources() -> dict[str, float]:
    return get_runtime().cluster_resources()


def nodes() -> list[dict]:
    return get_runtime().nodes()


def timeline() -> list[dict]:
    return get_runtime().timeline()


class RuntimeContext:
    """Reference: ray.get_runtime_context() (runtime_context.py)."""

    def get_node_id(self) -> str:
        import os
        nid = os.environ.get("RAY_TPU_NODE_ID", "")
        if nid:
            return nid
        rt = get_runtime_or_none()
        return rt.head_node_id if rt is not None and hasattr(
            rt, "head_node_id") else "driver"

    def get_actor_id(self) -> str | None:
        return _actor_context.hex() if _actor_context else None

    def get_task_id(self) -> str | None:
        """(reference: RuntimeContext.get_task_id) The id of the task
        or actor call executing on THIS thread, else None (driver)."""
        tid = _current_task_id()
        return tid.hex() if tid else None

    def get_job_id(self) -> str:
        rt = get_runtime_or_none()
        return rt.job_id.hex() if rt is not None and hasattr(
            rt, "job_id") else ""


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()
