"""Workflow execution API.

Counterpart of ``ray_tpu/workflow/api.py``. Reference:
python/ray/workflow/api.py + workflow_executor.py — a DAG (built with
the same ``.bind()`` API as ray_tpu_torch.dag) is executed with
**step-level durable logging**: every step's result is persisted before
the workflow advances, so a crashed/failed run resumes from the last
completed step (``resume``). The DAG itself is pickled into workflow
metadata so ``resume(workflow_id)`` needs nothing but the id.

Steps run as regular ray_tpu_torch tasks, so independent branches
execute in parallel; persistence happens as results arrive (fan-in
barrier per step, not per workflow).
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any

from ray_tpu_torch.core import serialization as ser
from ray_tpu_torch.dag.dag_node import (
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
    _DAGInputData,
)
from ray_tpu_torch.workflow import storage as wf_storage
from ray_tpu_torch.workflow.common import (
    WorkflowCancellationError,
    WorkflowExecutionError,
    WorkflowStatus,
)

_running: dict[str, threading.Thread] = {}
_results: dict[str, Any] = {}
_cancel_flags: dict[str, threading.Event] = {}
_starting: set[str] = set()    # resume guard over the IO window
_lock = threading.Lock()


# -- events / sleep / continuation (reference: workflow/api.py
#    wait_for_event + event_listener.py; workflow.continuation) -------


class EventListener:
    """Event-source ABC (reference: workflow.EventListener): subclass
    and implement ``poll_for_event`` (sync or async); its return value
    becomes the event step's (durably checkpointed) result, so a
    resumed workflow does NOT re-poll a received event."""

    def poll_for_event(self, *args, **kwargs):
        raise NotImplementedError


class Continuation:
    """A step's "keep going with this DAG" return value — build with
    :func:`continuation` (reference: workflow.continuation)."""

    def __init__(self, dag_node: DAGNode):
        if not isinstance(dag_node, DAGNode):
            raise TypeError(
                f"continuation() takes a bound DAG node, got "
                f"{type(dag_node).__name__}")
        self.dag = dag_node


def continuation(dag_node: DAGNode) -> Continuation:
    """Return this from a workflow step to dynamically extend the
    workflow: the sub-DAG executes with its own durable step log (keys
    namespaced under the returning step), and its result becomes the
    step's result (reference: workflow.continuation — dynamic
    workflows)."""
    return Continuation(dag_node)


def _poll_listener(listener_cls, args, kwargs):
    import asyncio
    import inspect
    listener = listener_cls()
    out = listener.poll_for_event(*args, **kwargs)
    if inspect.iscoroutine(out):
        out = asyncio.run(out)
    return out


def _durable_sleep(duration: float) -> None:
    time.sleep(duration)


def wait_for_event(event_listener_cls, *args, **kwargs) -> DAGNode:
    """A workflow step that completes when the listener's
    ``poll_for_event(*args, **kwargs)`` returns (reference:
    workflow.wait_for_event). The event payload is checkpointed like
    any step result."""
    if not (isinstance(event_listener_cls, type)
            and issubclass(event_listener_cls, EventListener)):
        raise TypeError("wait_for_event takes an EventListener "
                        "subclass")
    import ray_tpu_torch
    rf = ray_tpu_torch.remote(num_cpus=0)(_poll_listener)
    return rf.options(name=f"event_{event_listener_cls.__name__}").bind(
        event_listener_cls, args, kwargs)


def sleep(duration: float) -> DAGNode:
    """A durable timer step (reference: workflow.sleep): a resumed
    workflow whose sleep already completed does not sleep again."""
    import ray_tpu_torch
    rf = ray_tpu_torch.remote(num_cpus=0)(_durable_sleep)
    return rf.options(name="workflow_sleep").bind(duration)


def options(*, name: str | None = None, metadata: dict | None = None,
            **kwargs) -> dict:
    """Step options for ``fn.options(**workflow.options(...))``
    (reference: workflow.options). ``name`` keys the step's durable
    log entry — give steps stable names so refactors don't orphan
    their checkpoints; ``metadata`` is recorded in the workflow
    metadata."""
    out = dict(kwargs)
    if name is not None:
        out["name"] = name
    if metadata is not None:
        out["_workflow_metadata"] = metadata
    return out


def init(storage: str | None = None) -> None:
    """Set the durable storage root (reference: workflow.init)."""
    if storage:
        wf_storage.set_root(storage)


def _step_keys(order: list[DAGNode]) -> dict[int, str]:
    keys: dict[int, str] = {}
    named_seen: dict[str, int] = {}
    for i, n in enumerate(order):
        explicit = None
        if isinstance(n, FunctionNode):
            opts = getattr(n._remote_fn, "_default_opts", {}) or {}
            explicit = opts.get("name")
            name = (explicit
                    or n._remote_fn.underlying_function.__name__)
        else:
            name = type(n).__name__
        if explicit:
            # Explicitly-named steps get POSITION-INDEPENDENT keys —
            # the whole point of workflow.options(name=...): inserting
            # a step must not orphan existing checkpoints. Repeats of
            # one name key by occurrence order.
            count = named_seen.get(explicit, 0)
            named_seen[explicit] = count + 1
            keys[id(n)] = (f"named_{explicit}" if count == 0
                           else f"named_{explicit}_{count + 1}")
        else:
            keys[id(n)] = f"{i:04d}_{name}"
    return keys


def _validate(order: list[DAGNode]) -> None:
    for n in order:
        if not isinstance(n, (FunctionNode, InputNode,
                              InputAttributeNode, MultiOutputNode)):
            raise TypeError(
                f"workflows support function DAGs only; got "
                f"{type(n).__name__} (actor steps are not durable)")


def _execute(dag: DAGNode, store: wf_storage.WorkflowStorage,
             input_val: Any, cancel: threading.Event) -> Any:
    import ray_tpu_torch
    from ray_tpu_torch.core.object_ref import ObjectRef
    order = dag.topological_order()
    _validate(order)
    keys = _step_keys(order)
    # Dataflow-frontier execution: a step is SUBMITTED the moment all
    # its dependencies hold concrete values, and results are harvested
    # as they complete — independent branches run in parallel at every
    # depth. Values never flow as raw ObjectRef args: an upstream step
    # may return a Continuation (dynamic workflows), which must expand
    # through the durable executor BEFORE dependents consume it — the
    # executor, not a worker task, owns that expansion (matching the
    # reference's executor-resolves-step-outputs model).
    vals: dict[int, Any] = {}          # node id -> concrete value
    inflight: dict[int, Any] = {}      # node id -> pending ObjectRef
    node_by_id = {id(n): n for n in order}

    def expand(node, value, fresh: bool):
        """Continuation expansion + persistence for one step value.
        A step (fresh, or cache-loaded after a crash mid-
        continuation) returning a Continuation extends the workflow;
        sub-steps get their own durable log namespaced under this
        step, then the final value overwrites the step entry so a
        completed continuation resumes as a plain cached value."""
        changed = fresh
        while isinstance(value, Continuation):
            if changed:  # checkpoint the outer step first
                store.save_step(keys[id(node)], value)
            sub = _SubStore(store, keys[id(node)])
            value = _execute(value.dag, sub, None, cancel)
            changed = True
        if changed:
            store.save_step(keys[id(node)], value)
        vals[id(node)] = value

    def _deps_of(n) -> list:
        out = []

        def walk(obj):
            if isinstance(obj, DAGNode):
                out.append(obj)
            elif isinstance(obj, (list, tuple)):
                for v in obj:
                    walk(v)
            elif isinstance(obj, dict):
                for v in obj.values():
                    walk(v)

        for a in n._bound_args:
            walk(a)
        for v in getattr(n, "_bound_kwargs", {}).values():
            walk(v)
        return out

    # Dep sets are immutable: walk each node's arg tree ONCE, not on
    # every 0.2 s scheduler tick (an event-poll-blocked workflow would
    # otherwise busy-rescan all waiting nodes for hours).
    dep_ids = {id(n): [id(d) for d in _deps_of(n)] for n in order}

    def resolve_nested(obj):
        if isinstance(obj, DAGNode):
            return vals[id(obj)]
        if isinstance(obj, (list, tuple)):
            return type(obj)(resolve_nested(v) for v in obj)
        if isinstance(obj, dict):
            return {k: resolve_nested(v) for k, v in obj.items()}
        return obj

    waiting = list(order)
    while waiting or inflight:
        if cancel.is_set():
            _cancel_inflight(inflight)
            raise _Canceled()
        # Submit/compute every node whose deps are all concrete.
        progressed = False
        still_waiting = []
        for n in waiting:
            if any(d not in vals for d in dep_ids[id(n)]):
                still_waiting.append(n)
                continue
            progressed = True
            if isinstance(n, InputNode):
                vals[id(n)] = input_val
            elif isinstance(n, InputAttributeNode):
                base = vals[id(n._bound_args[0])]
                if isinstance(base, _DAGInputData):
                    vals[id(n)] = base.pick(n._key)
                elif isinstance(n._key, int):
                    vals[id(n)] = base[n._key]
                else:
                    vals[id(n)] = (base[n._key]
                                   if isinstance(base, dict)
                                   else getattr(base, n._key))
            elif isinstance(n, MultiOutputNode):
                vals[id(n)] = [vals[id(c)] for c in n._bound_args]
            elif store.has_step(keys[id(n)]):
                expand(n, store.load_step(keys[id(n)]), fresh=False)
            else:
                args = tuple(resolve_nested(a) for a in n._bound_args)
                kwargs = {k: resolve_nested(v)
                          for k, v in n._bound_kwargs.items()}
                inflight[id(n)] = n._remote_fn.remote(*args, **kwargs)
        waiting = still_waiting
        if not inflight:
            if not progressed and waiting:
                raise RuntimeError(
                    "workflow DAG made no progress (cycle?)")
            continue
        # Harvest whatever finished (poll, don't block: cancel() must
        # interrupt a workflow stuck on a long step — an event poll).
        ref_to_nid = {ref: nid for nid, ref in inflight.items()}
        done, _ = ray_tpu_torch.wait(list(ref_to_nid), num_returns=1,
                               timeout=0.2)
        for ref in done:
            nid = ref_to_nid[ref]
            del inflight[nid]
            expand(node_by_id[nid], ray_tpu_torch.get(ref), fresh=True)
    return vals[id(order[-1])]


class _SubStore:
    """Step-log namespace for a continuation's sub-DAG (keys prefixed
    by the parent step key, same backing storage)."""

    def __init__(self, store, prefix: str):
        self._store = store
        self._prefix = prefix

    def _k(self, key: str) -> str:
        return f"{self._prefix}__{key}"

    def has_step(self, key: str) -> bool:
        return self._store.has_step(self._k(key))

    def save_step(self, key: str, value) -> None:
        self._store.save_step(self._k(key), value)

    def load_step(self, key: str):
        return self._store.load_step(self._k(key))


class _Canceled(Exception):
    pass


def _cancel_inflight(vals: dict) -> None:
    """Best-effort kill of still-running steps so a canceled workflow
    does not leave workers pinned in event polls."""
    import ray_tpu_torch
    from ray_tpu_torch.core.object_ref import ObjectRef
    for v in vals.values():
        if isinstance(v, ObjectRef):
            try:
                ray_tpu_torch.cancel(v, force=True)
            except Exception:  # noqa: BLE001
                pass


_RESULT_KEY = "__result__"  # step-blob slot for the final output


def _run_thread(workflow_id: str, dag: DAGNode, input_val: Any) -> None:
    store = wf_storage.WorkflowStorage(workflow_id)
    cancel = _cancel_flags[workflow_id]
    meta = store.load_meta() or {}
    try:
        result = _execute(dag, store, input_val, cancel)
        with _lock:
            _results[workflow_id] = ("ok", result)
        # The final result is durable too (its own blob — meta.json
        # stays small): get_output()/get_output_async() work from ANY
        # process after completion.
        store.save_step(_RESULT_KEY, result)
        meta["status"] = WorkflowStatus.SUCCESSFUL
        meta["end_time"] = time.time()
        store.save_meta(meta)
    except _Canceled:
        with _lock:
            _results[workflow_id] = ("canceled", None)
        meta["status"] = WorkflowStatus.CANCELED
        store.save_meta(meta)
    except BaseException as e:  # noqa: BLE001
        with _lock:
            _results[workflow_id] = ("err", e)
        meta["status"] = WorkflowStatus.FAILED
        meta["error"] = repr(e)
        store.save_meta(meta)


def run_async(dag: DAGNode, *, workflow_id: str | None = None,
              args: Any = None,
              metadata: dict | None = None) -> str:
    """Start a workflow; returns its id immediately. ``metadata`` is
    recorded in the durable record (reference: workflow.run's
    user-metadata — surfaced by get_metadata)."""
    workflow_id = workflow_id or f"workflow_{uuid.uuid4().hex[:12]}"
    store = wf_storage.WorkflowStorage(workflow_id)
    meta = {
        "workflow_id": workflow_id,
        "status": WorkflowStatus.RUNNING,
        "start_time": time.time(),
        "dag_blob": ser.dumps((dag, args)).hex(),
    }
    # step metadata from workflow.options(metadata=...) is part of the
    # durable record (reference: workflow metadata storage)
    step_md = {}
    order = dag.topological_order()
    keys = _step_keys(order)
    for n in order:
        if isinstance(n, FunctionNode):
            m = (getattr(n._remote_fn, "_default_opts", {}) or {}
                 ).get("_workflow_metadata")
            if m:
                step_md[keys[id(n)]] = m
    if step_md:
        meta["step_metadata"] = step_md
    import os
    meta["executor_pid"] = os.getpid()
    if metadata:
        meta["user_metadata"] = dict(metadata)
    store.save_meta(meta)
    with _lock:
        _cancel_flags[workflow_id] = threading.Event()
        t = threading.Thread(target=_run_thread,
                             args=(workflow_id, dag, args),
                             daemon=True,
                             name=f"workflow_{workflow_id[:16]}")
        _running[workflow_id] = t
    t.start()
    return workflow_id


def run(dag: DAGNode, *, workflow_id: str | None = None,
        args: Any = None, timeout: float | None = None,
        metadata: dict | None = None) -> Any:
    wid = run_async(dag, workflow_id=workflow_id, args=args,
                    metadata=metadata)
    return get_output(wid, timeout=timeout)


def get_output(workflow_id: str, timeout: float | None = None) -> Any:
    t = _running.get(workflow_id)
    if t is None:
        # Not running here: a completed workflow's output is durable.
        store = wf_storage.WorkflowStorage(workflow_id)
        meta = store.load_meta()
        if meta is None:
            raise ValueError(f"no stored workflow {workflow_id!r}")
        status = meta.get("status")
        if status == WorkflowStatus.SUCCESSFUL \
                and store.has_step(_RESULT_KEY):
            return store.load_step(_RESULT_KEY)
        if status == WorkflowStatus.CANCELED:
            raise WorkflowCancellationError(
                f"workflow {workflow_id} was canceled")
        if status == WorkflowStatus.FAILED:
            raise WorkflowExecutionError(
                f"workflow {workflow_id} failed: "
                f"{meta.get('error', '?')}")
        raise ValueError(
            f"workflow {workflow_id!r} is {status} and not running "
            f"in this process; use resume()")
    t.join(timeout)
    if t.is_alive():
        raise TimeoutError(f"workflow {workflow_id} still running")
    kind, payload = _results[workflow_id]
    if kind == "ok":
        return payload
    if kind == "canceled":
        raise WorkflowCancellationError(
            f"workflow {workflow_id} was canceled")
    raise payload


def _await_workflow(root: str, workflow_id: str,
                    poll_s: float = 0.2) -> Any:
    """Worker-side wait: poll the durable meta until terminal (the
    get_output_async / resume_async ObjectRef body)."""
    from ray_tpu_torch.workflow import storage as st
    st.set_root(root)
    from ray_tpu_torch.workflow.common import (
        WorkflowCancellationError as WCE,
        WorkflowExecutionError as WEE,
    )
    while True:
        store = st.WorkflowStorage(workflow_id)
        meta = store.load_meta()
        if meta is None:
            raise ValueError(f"no stored workflow {workflow_id!r}")
        status = meta.get("status")
        if status == WorkflowStatus.SUCCESSFUL:
            return store.load_step(_RESULT_KEY)
        if status == WorkflowStatus.CANCELED:
            raise WCE(f"workflow {workflow_id} was canceled")
        if status == WorkflowStatus.FAILED:
            raise WEE(f"workflow {workflow_id} failed: "
                      f"{meta.get('error', '?')}")
        time.sleep(poll_s)


def get_output_async(workflow_id: str):
    """The workflow's output as an ObjectRef (reference:
    workflow.get_output_async): ray_tpu_torch.get(ref) blocks until the
    workflow finishes."""
    import ray_tpu_torch
    rf = ray_tpu_torch.remote(num_cpus=0)(_await_workflow)
    return rf.remote(wf_storage.get_root(), workflow_id)


def _start_resume(workflow_id: str) -> None:
    """Shared resume launcher: load the durable DAG, mark RUNNING
    (with this executor's pid), spawn the run thread. Refuses while a
    live executor (this process OR a live recorded pid) owns the
    workflow — a second concurrent execution would double-run steps
    and race the durable log."""
    import os
    from ray_tpu_torch.workflow.common import WorkflowError
    # check-then-act under _lock: two concurrent resume() calls must
    # not both pass the liveness guard (the _starting sentinel covers
    # the storage-IO window between guard and thread registration)
    with _lock:
        t = _running.get(workflow_id)
        if (t is not None and t.is_alive()) \
                or workflow_id in _starting:
            raise WorkflowError(
                f"workflow {workflow_id} is already running in this "
                f"process; cancel() it first")
        _starting.add(workflow_id)
    try:
        store = wf_storage.WorkflowStorage(workflow_id)
        meta = store.load_meta()
        if meta is None:
            raise ValueError(f"no stored workflow {workflow_id!r}")
        if meta.get("status") == WorkflowStatus.RUNNING \
                and meta.get("executor_pid") != os.getpid() \
                and _pid_alive(meta.get("executor_pid")):
            raise WorkflowError(
                f"workflow {workflow_id} is RUNNING under live pid "
                f"{meta.get('executor_pid')}; refusing a second "
                f"executor")
        dag, args = ser.loads(bytes.fromhex(meta["dag_blob"]))
        meta["status"] = WorkflowStatus.RUNNING
        meta["executor_pid"] = os.getpid()
        store.save_meta(meta)
        with _lock:
            _cancel_flags[workflow_id] = threading.Event()
            t = threading.Thread(target=_run_thread,
                                 args=(workflow_id, dag, args),
                                 daemon=True,
                                 name=f"workflow_{workflow_id[:16]}")
            _running[workflow_id] = t
        t.start()
    finally:
        with _lock:
            _starting.discard(workflow_id)


def resume(workflow_id: str, timeout: float | None = None) -> Any:
    """Re-run from durable state: completed steps load from storage,
    the rest re-execute (reference: workflow.resume)."""
    _start_resume(workflow_id)
    return get_output(workflow_id, timeout=timeout)


def resume_async(workflow_id: str):
    """Start resuming and return the output ObjectRef immediately
    (reference: workflow.resume_async)."""
    _start_resume(workflow_id)
    return get_output_async(workflow_id)


def _pid_alive(pid) -> bool:
    import os
    try:
        os.kill(int(pid), 0)
        return True
    except PermissionError:
        # EPERM: the pid exists but belongs to another user — alive.
        # Treating it as dead would let a second concurrent executor
        # double-run steps against the shared storage root.
        return True
    except (OSError, TypeError, ValueError):
        return False


def resume_all() -> list:
    """Resume every resumable workflow — FAILED, RESUMABLE, or
    RUNNING whose recorded executor process is dead (a crash left it
    behind). A RUNNING workflow whose executor pid is still alive on
    this host is skipped — resuming it would start a second
    concurrent execution. (Executors on OTHER hosts sharing a storage
    root are indistinguishable from crashed ones — same caveat as the
    reference's storage-level liveness.) Returns
    [(workflow_id, output_ref)] (reference: workflow.resume_all)."""
    out = []
    for wid in wf_storage.list_workflows():
        meta = wf_storage.WorkflowStorage(wid).load_meta()
        if not meta or "dag_blob" not in meta:
            continue
        status = meta.get("status")
        t = _running.get(wid)
        live_here = t is not None and t.is_alive()
        if live_here or status in (WorkflowStatus.SUCCESSFUL,
                                   WorkflowStatus.CANCELED):
            continue
        if status == WorkflowStatus.RUNNING \
                and _pid_alive(meta.get("executor_pid")):
            continue
        out.append((wid, resume_async(wid)))
    return out


def delete(workflow_id: str) -> None:
    """Remove a workflow's durable state (reference: workflow.delete).
    Refuses while it is executing in this process."""
    import shutil
    t = _running.get(workflow_id)
    if t is not None and t.is_alive():
        raise RuntimeError(
            f"workflow {workflow_id} is running; cancel() it first")
    store = wf_storage.WorkflowStorage(workflow_id)
    meta = store.load_meta()
    if meta is None:
        raise ValueError(f"no stored workflow {workflow_id!r}")
    if meta.get("status") == WorkflowStatus.RUNNING \
            and _pid_alive(meta.get("executor_pid")):
        raise RuntimeError(
            f"workflow {workflow_id} is RUNNING under live pid "
            f"{meta.get('executor_pid')}; refusing to delete its "
            f"storage out from under the executor")
    shutil.rmtree(store.dir, ignore_errors=True)
    with _lock:
        _running.pop(workflow_id, None)
        _results.pop(workflow_id, None)
        _cancel_flags.pop(workflow_id, None)


def get_status(workflow_id: str) -> str:
    meta = wf_storage.WorkflowStorage(workflow_id).load_meta()
    if meta is None:
        raise ValueError(f"no stored workflow {workflow_id!r}")
    return meta["status"]


def get_metadata(workflow_id: str) -> dict:
    meta = wf_storage.WorkflowStorage(workflow_id).load_meta()
    if meta is None:
        raise ValueError(f"no stored workflow {workflow_id!r}")
    return {k: v for k, v in meta.items() if k != "dag_blob"}


def list_all() -> list[tuple[str, str]]:
    out = []
    for wid in wf_storage.list_workflows():
        meta = wf_storage.WorkflowStorage(wid).load_meta()
        if meta:
            out.append((wid, meta.get("status", "UNKNOWN")))
    return out


def cancel(workflow_id: str) -> None:
    flag = _cancel_flags.get(workflow_id)
    if flag is not None:
        flag.set()
    store = wf_storage.WorkflowStorage(workflow_id)
    meta = store.load_meta()
    if meta is not None:
        meta["status"] = WorkflowStatus.CANCELED
        store.save_meta(meta)
