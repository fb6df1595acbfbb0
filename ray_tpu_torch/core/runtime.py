"""Single-node driver runtime: scheduler, worker pool, object directory.

This is the round-1 control plane. It plays the roles the reference
splits across three C++ processes (SURVEY.md §1 L2):

- *GCS analog*: actor table, named actors, placement groups, resource
  view — all in the driver process.
- *Raylet analog*: worker pool with per-runtime-env caching and a
  dispatch loop (``_dispatch_loop`` ~ ClusterTaskManager::
  ScheduleAndDispatchTasks, cluster_task_manager.cc:136), resource
  accounting, lease-style worker reuse keyed by env.
- *Object manager analog*: two-tier store (memory + shared memory) with
  an object directory and spilling.

Worker processes proxy the public API back here over a unix socket
(``_serve_client`` — the worker→raylet/GCS client path), which is what
makes nested patterns work: a Tune trial actor creating a Train worker
group creates real actors through this runtime.

Other nodes are node daemons (``core/node_daemon.py``) that dial the
head's TCP listener (``ensure_tcp_listener``): a remote node is "a
worker pool we reach over a socket", with the same dispatch protocol,
plus logical nodes (rows of resources whose workers the head spawns).
Each node keeps its own cards (``NodeRecord.cards``): a daemon's are the
ids it reported, a logical node's are given or taken from this host's
free ids, and a GPU holder's worker sees its hold's ids and no other.
"""

from __future__ import annotations

import hashlib
import itertools
import math
import os
import threading
import weakref
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from ray_tpu_torch.core import protocol as P
from ray_tpu_torch.core import serialization as ser
from ray_tpu_torch.core import wire
from ray_tpu_torch.core.accelerator import (
    GPU_IDS_ENV, detect_gpu_count, visible_gpu_ids,
)
from ray_tpu_torch.core.config import Config, temp_path
from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    TaskCancelledError,
    TaskError,
)
from ray_tpu_torch.core.ids import ActorID, JobID, ObjectID, PlacementGroupID, TaskID
from ray_tpu_torch.core.object_ref import ObjectRef, ObjectRefGenerator
from ray_tpu_torch.core.object_store import (
    MemoryStore,
    SharedMemoryStore,
    read_descriptor,
)
from ray_tpu_torch.core.serialization import SerializedObject


# What a containerized worker's environment forwards (--env flags):
# the runtime's own variables, the import path, and the card's
# (CUDA_VISIBLE_DEVICES, the NVIDIA container toolkit's NVIDIA_*).
CONTAINER_ENV_PREFIXES = ("RAY_TPU_", "PYTHON", "CUDA_VISIBLE_DEVICES",
                          "NVIDIA_")


class _RefLock:
    """The driver's reference-count lock, which knows whether this
    thread holds it. ``ObjectRef.__del__`` decrements through
    ``_dec_ref``, and a garbage-collection pass runs finalizers on the
    thread that allocated, also inside a region that holds this lock:
    with a plain lock that thread waited on itself, and every later
    submit on the lock (the JAX package keeps the fault,
    ``ray_tpu/core/runtime.py:1087-1089, 1203-1204``). Such a
    decrement is queued instead, and ``on_release`` applies the queue
    once the holder has let go."""

    def __init__(self, on_release: Callable[[], None]):
        self._lock = threading.Lock()
        self._owner: int | None = None
        self._on_release = on_release
        self.deferred: deque = deque()

    def __enter__(self):
        me = threading.get_ident()
        self._lock.acquire()
        self._owner = me

    def __exit__(self, *exc):
        self._owner = None
        self._lock.release()
        if self.deferred:
            self._on_release()

    def held_here(self) -> bool:
        return self._owner == threading.get_ident()


def session_root() -> str:
    """Where a driver keeps its socket and worker logs (``<pid>/``):
    ``ray_tpu_torch_sessions`` in the temporary directory, or in /tmp
    where the socket's path would pass AF_UNIX's 108 bytes."""
    root = temp_path("ray_tpu_torch_sessions")
    if len(root) + len("/4194304/runtime.sock") >= 108:
        root = "/tmp/ray_tpu_torch_sessions"
    return root


def _sendable(obj: SerializedObject) -> tuple[bytes, list[bytes]]:
    """(data, buffers) with every segment materialized as bytes —
    shm/arena-backed views are not picklable over a connection."""
    data = obj.data if isinstance(obj.data, bytes) else bytes(obj.data)
    bufs = [b if isinstance(b, bytes) else bytes(b)
            for b in obj.buffers]
    return data, bufs


def _entry_inline_bytes(entry) -> int:
    """Payload bytes an OP_GET/OP_GET_MANY wire entry contributes to
    its reply frame (inline data + buffers; desc/chunked/defer
    entries are metadata-sized)."""
    if entry and entry[0] == "inline":
        return len(entry[1]) + sum(len(b) for b in entry[2])
    return 0


def _parallel_map_first_error(fn, items, width: int) -> list:
    """Run ``fn(item)`` for every item on up to ``width`` threads,
    returning results in item order. If any call raises, the
    exception of the LOWEST-index failing item is raised (matching
    the serial loop's first-error-wins contract); already-started
    calls drain, unstarted ones are skipped."""
    n = len(items)
    if n == 0:
        return []
    if width <= 1 or n == 1:
        return [fn(it) for it in items]
    results: list = [None] * n
    errors: list = []
    next_lock = threading.Lock()
    counter = iter(range(n))
    stop = threading.Event()

    def run():
        while not stop.is_set():
            with next_lock:
                i = next(counter, None)
            if i is None:
                return
            try:
                results[i] = fn(items[i])
            except BaseException as e:  # noqa: BLE001
                errors.append((i, e))
                stop.set()
                return

    threads = [threading.Thread(target=run, daemon=True,
                                name=f"get_pull_{k}")
               for k in range(min(width, n))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        errors.sort(key=lambda pair: pair[0])
        raise errors[0][1]
    return results


def _wire_to_serialized(entry) -> SerializedObject:
    """(data, buffers[, (ref_id_bytes, nonce) pairs]) wire tuple ->
    SerializedObject. The optional third element carries nested
    ObjectRef identities for container pinning."""
    data, buffers = entry[0], entry[1]
    refs = None
    if len(entry) > 2 and entry[2]:
        refs = [(ObjectID(b), n) for b, n in entry[2]]
    return SerializedObject(data=data, buffers=list(buffers),
                            contained_refs=refs)


# --------------------------------------------------------------------------
# Task/actor bookkeeping structures
# --------------------------------------------------------------------------

@dataclass
class TaskOptions:
    num_returns: int = 1
    resources: dict[str, float] = field(default_factory=lambda: {"CPU": 1.0})
    max_retries: int = -1          # -1 = use config default
    retry_exceptions: bool = False
    name: str = ""
    runtime_env: dict | None = None
    placement_group: Any = None    # PlacementGroup | None
    placement_group_bundle_index: int = -1
    scheduling_strategy: str = "DEFAULT"  # DEFAULT|SPREAD|NODE_AFFINITY
    node_id: str = ""              # NODE_AFFINITY target
    soft: bool = False             # NODE_AFFINITY soft fallback
    trace_ctx: tuple | None = None  # (trace_id, span_id) propagation

    def __getstate__(self):
        # Drop runtime-local caches (_env_cache holds the runtime
        # itself — unpicklable and meaningless in another process).
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}

    def __setstate__(self, state):
        self.__dict__.update(state)


@dataclass
class _StreamState:
    """Driver-side state of one streaming-returns task."""
    cv: threading.Condition
    ready: deque = field(default_factory=deque)   # ObjectRefs not yet taken
    produced: int = 0
    consumed: int = 0
    done: bool = False
    err_blob: bytes | None = None


@dataclass
class NodeRecord:
    """One logical node (raylet analog). Multi-node-on-one-host: each
    node owns a resource pool and its worker processes carry its id —
    the reference's ``Cluster.add_node`` pattern (SURVEY.md §4.2,
    python/ray/cluster_utils.py:135,201) where "a node" is a process
    group with its own resource spec, schedulable and killable."""
    node_id: str
    resources: dict[str, float]
    avail: dict[str, float]
    labels: dict[str, str] = field(default_factory=dict)
    alive: bool = True
    is_head: bool = False
    started_at: float = field(default_factory=time.time)
    # Drain state (reference: the DrainNode protocol — a draining
    # node is excluded from scheduling while its work and objects
    # migrate off, then terminates without losing anything).
    draining: bool = False
    drain_reason: str = ""
    drain_deadline: float = 0.0     # monotonic
    # Daemon-backed nodes (a real ray_tpu.core.node_daemon process on
    # the other end of a TCP connection). conn is None for the head
    # node and for logical test nodes.
    conn: Any = None
    send_lock: Any = None
    pid: int = 0
    hostname: str = ""
    # (host, port) of the daemon's direct object-plane listener, so
    # peers pull chunks from each other instead of relaying through
    # the head (reference: ObjectManager p2p, object_manager.h:117).
    object_addr: Any = None
    # Active health checking (reference: GcsHealthCheckManager,
    # gcs_health_check_manager.h:39): last ND_PONG seen, and whether
    # a ping send is already in flight (a wedged daemon can block the
    # sender on its full socket).
    last_pong: float = 0.0
    ping_inflight: bool = False
    # Versioned load report pushed by the daemon (ND_RSYNC): what the
    # node OBSERVES about itself (running workers, ...), as opposed to
    # the head's authoritative allocation view in resources/avail.
    observed: dict = field(default_factory=dict)
    report_version: int = -1
    # The node's cards, id -> the share of it no holder has taken
    # (1.0 when free). The GPU resource in resources/avail admits
    # work; these say which card each GPU holder gets.
    cards: dict[str, float] = field(default_factory=dict)

    @property
    def is_daemon(self) -> bool:
        return self.conn is not None

    def node_send(self, msg: tuple) -> None:
        with self.send_lock:
            self.conn.send(msg)


@dataclass
class CardHold:
    """Cards of one node held by one task lease or one actor: the
    worker serving it sees exactly these (``CUDA_VISIBLE_DEVICES``).
    ``share`` is what each card gave: 1.0, or the fraction of a
    ``num_gpus < 1`` request."""
    node_id: str
    ids: tuple[str, ...]
    share: float
    released: bool = False


@dataclass
class TaskRecord:
    task_id: TaskID
    fn_id: str
    name: str
    args_blob: bytes
    arg_refs: list[ObjectRef]
    options: TaskOptions
    return_ids: list[ObjectID]
    attempts: int = 0
    state: str = "PENDING"         # PENDING/RUNNING/FINISHED/FAILED/CANCELLED
    worker: "WorkerHandle | None" = None
    worker_index: int = -1
    node_id: str = ""              # node running the task
    pg_bundle: int = -1            # bundle the resources came from
    submitted_at: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0
    # Runtime env resolved ONCE at submission (runtime_env builds can
    # stat whole staged trees — too costly per dispatch/retry).
    env_key: str = ""
    env_vars: dict[str, str] | None = None
    oom_killed: bool = False       # memory monitor chose this victim
    # Scheduling class + effective resources, computed once on first
    # enqueue: the scheduler scan probes these per pending task, and
    # recomputing them (dict sort) dominated deep-queue scans.
    sched_class: tuple | None = None
    need: dict[str, float] | None = None
    # Lease pipelining: True when this task rides a worker's existing
    # resource acquisition (no acquire ran; finish must not release).
    leased: bool = False
    # Admission attribution: which client's submits put this task in
    # the pending queues ("driver" for in-process submits) — the
    # per-client fairness counts key on it.
    client_key: str = ""
    # Global enqueue sequence: the class-indexed ready queues pick the
    # lowest-seq head for cross-class FIFO. Assigned once on first
    # enqueue; retries keep it (original submission order).
    seq: int = 0
    # Cards taken at placement (a GPU request); the lease's worker
    # carries the hold until the lease ends.
    card_hold: CardHold | None = None


@dataclass
class ActorRecord:
    actor_id: ActorID
    name: str
    cls_name: str
    cls_blob: bytes
    init_args_blob: bytes
    init_arg_refs: list[ObjectRef]
    options: TaskOptions
    max_restarts: int
    max_concurrency: int
    worker: "WorkerHandle | None" = None
    state: str = "PENDING"         # PENDING/ALIVE/RESTARTING/DEAD
    node_id: str = ""
    pg_bundle: int = -1
    restart_count: int = 0
    in_flight: dict[TaskID, tuple] = field(default_factory=dict)
    ready_event: threading.Event = field(default_factory=threading.Event)
    creation_error: Exception | None = None
    # Per-actor ordered submit queue + single pusher thread (reference:
    # SequentialActorSubmitQueue, actor_task_submitter.h:75) — preserves
    # per-handle call ordering.
    submit_queue: "deque | None" = None
    queue_cv: threading.Condition = field(
        default_factory=threading.Condition)
    pusher: "threading.Thread | None" = None
    # Resolved once at creation; restarts reuse it.
    env_key: str = ""
    env_vars: dict[str, str] | None = None
    # Set when a drain kills a non-restartable actor so the death
    # error names the real cause instead of "process exited".
    drain_reason: str = ""
    # Cards of this incarnation (a GPU actor), taken at placement.
    card_hold: CardHold | None = None


@dataclass
class LineageRecord:
    """Retained spec of a finished task so its return objects can be
    rebuilt by re-execution after loss (reference: lineage retention
    in TaskManager, task_manager.h:560-602; recovery driven by
    ObjectRecoveryManager, object_recovery_manager.h:41). Holding
    arg_refs pins the argument objects — the reference's "lineage
    pinning" — until the record is evicted by the byte budget."""
    fn_id: str
    name: str
    args_blob: bytes
    arg_refs: list
    options: "TaskOptions"
    return_ids: list
    nbytes: int = 0
    reconstructions: int = 0
    rebuilding: bool = False
    live_returns: set = field(default_factory=set)


@dataclass
class PGRecord:
    pg_id: PlacementGroupID
    bundles: list[dict[str, float]]
    strategy: str
    name: str = ""
    # Per-bundle unclaimed reservations + the node each bundle landed
    # on (reference: bundles own their reserved resources,
    # placement_group_resource_manager.cc; 2-phase placement
    # gcs_placement_group_scheduler.cc).
    bundle_avail: list[dict[str, float]] = field(default_factory=list)
    bundle_nodes: list[str] = field(default_factory=list)
    ready: threading.Event = field(default_factory=threading.Event)
    created: bool = False


class TransferPlane:
    """Chunked object transfers in flight (ObjectManager analog,
    SURVEY §2.1 N17: ObjectBufferPool chunking + pull-based flow
    control). Shared by the head runtime and node daemons; a tid
    prefix lets a splicing proxy route pulls to whichever side owns
    the transfer. Entries idle >600s are purged lazily."""

    def __init__(self, chunk_bytes: int, prefix: str = ""):
        self._chunk = chunk_bytes
        self._prefix = prefix
        self._table: dict[str, tuple] = {}
        self._lock = threading.Lock()
        self.chunks_served = 0

    def start(self, obj: SerializedObject) -> tuple:
        import uuid
        now = time.time()
        tid = self._prefix + uuid.uuid4().hex
        with self._lock:
            stale = [t for t, (_, ts) in self._table.items()
                     if now - ts > 600]
            for t in stale:
                self._table.pop(t, None)
            self._table[tid] = (obj, now)
        return ("chunked", tid, len(obj.data),
                [len(b) for b in obj.buffers], self._chunk)

    def chunk(self, tid: str, index: int) -> bytes:
        with self._lock:
            entry = self._table.get(tid)
            if entry is not None:
                # Refresh activity so a long multi-GB pull is never
                # purged mid-transfer (expiry is idle-based).
                self._table[tid] = (entry[0], time.time())
        if entry is None:
            raise KeyError(f"unknown or expired transfer {tid}")
        obj, _ = entry
        start = index * self._chunk
        out = bytearray()
        pos = 0
        for seg in (obj.data, *obj.buffers):
            seg_len = len(seg)
            if start < pos + seg_len and len(out) < self._chunk:
                lo = max(0, start - pos)
                hi = min(seg_len, lo + (self._chunk - len(out)))
                out += memoryview(seg)[lo:hi]
            pos += seg_len
            if len(out) >= self._chunk:
                break
        self.chunks_served += 1
        return bytes(out)

    def end(self, tid: str) -> None:
        with self._lock:
            self._table.pop(tid, None)

    def owns(self, tid: str) -> bool:
        return bool(self._prefix) and tid.startswith(self._prefix)

    @property
    def table(self) -> dict:
        return self._table


class _CachedThreadPool:
    """Cached-thread executor for blocking ops: submit() reuses an
    idle worker or spawns a fresh daemon thread — it NEVER queues, so
    a pool full of parked long-blocking ops (client gets waiting on
    results) cannot deadlock work that would unblock them. Idle
    workers expire after ``idle_ttl``.

    vs ThreadPoolExecutor: a bounded executor queues past max_workers
    (deadlock-prone for blocking ops); unbounded spawn-per-message is
    what this replaces (~100 us of thread start per op on the client
    hot path)."""

    def __init__(self, name: str, idle_ttl: float = 10.0):
        self._name = name
        self._ttl = idle_ttl
        self._idle: deque = deque()   # (event, box) parked workers
        self._lock = threading.Lock()
        self._seq = itertools.count()

    def submit(self, fn, *args) -> None:
        with self._lock:
            while self._idle:
                ev, box = self._idle.pop()
                box.append((fn, args))
                ev.set()
                return
        threading.Thread(
            target=self._worker, args=(fn, args), daemon=True,
            name=f"{self._name}_{next(self._seq)}").start()

    def _worker(self, fn, args) -> None:
        while True:
            try:
                fn(*args)
            except Exception:  # noqa: BLE001
                traceback.print_exc()
            ev = threading.Event()
            box: list = []
            entry = (ev, box)
            with self._lock:
                self._idle.append(entry)
            if not ev.wait(self._ttl):
                with self._lock:
                    try:
                        self._idle.remove(entry)
                    except ValueError:
                        # submit() popped us between timeout and
                        # remove: the job in the box MUST run.
                        ev.wait()
                        fn, args = box[0]
                        continue
                return
            fn, args = box[0]


class WorkerDiedBeforeConnectError(RuntimeError):
    """The worker process exited before its exec channel attached."""


class PlacementError(RuntimeError):
    """The placement request can never be satisfied (bad bundle index,
    hard affinity to a dead node, ...) — fail the task, don't wait."""


class WorkerHandle:
    """A pooled worker process plus its exec channel.

    Workers are standalone processes running a dedicated entry module
    (``python -m ray_tpu_torch.core.worker_entry``) that dials back to the
    driver's unix socket — the reference's model (raylet spawns
    ``default_worker.py``), deliberately NOT multiprocessing-spawn,
    which would re-import the user's ``__main__`` and re-execute
    unguarded driver scripts inside every worker.
    """

    _counter = itertools.count()
    BOOT_TIMEOUT_S = 120.0

    def __init__(self, runtime: "DriverRuntime", env_key: str,
                 env_vars: dict[str, str], node_id: str = ""):
        self.index = next(self._counter)
        self.env_key = env_key
        self.node_id = node_id
        self.busy = False
        self.is_actor = False
        self.actor_id: ActorID | None = None
        self.dead = False
        self.last_idle = time.monotonic()
        self.sent_fn_ids: set[str] = set()
        self._runtime = runtime
        self.send_lock = threading.Lock()
        # Lease pipeline: tasks queued on this worker (FIFO, executed
        # serially) under ONE resource acquisition. Guarded by
        # lease_lock (appends from dispatch threads race pops from
        # the result-reader thread).
        self.lease_queue: deque = deque()
        self.lease_lock = threading.Lock()
        # Cards of the lease or actor this worker serves (its
        # CUDA_VISIBLE_DEVICES never changes; the hold does).
        self.card_hold: CardHold | None = None
        self.token = os.urandom(8).hex()
        self.conn = None
        self._conn_ready = threading.Event()

        import subprocess
        import sys
        env = dict(os.environ)
        env.update(env_vars)
        env["RAY_TPU_WORKER"] = "1"
        env["RAY_TPU_NODE_ID"] = node_id
        # Head-set sampling knob pushed to workers: the worker tracer
        # reads it at construction, so the disabled/sampled-out path
        # never pays a head round-trip.
        env["RAY_TPU_TRACE_SAMPLE_RATE"] = str(
            runtime.config.trace_sample_rate)
        # Propagate the driver's import path so workers resolve the same
        # modules (incl. a repo added to sys.path by the driver script).
        env["PYTHONPATH"] = os.pathsep.join(
            [p for p in sys.path if p] +
            [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        # Worker stdout/stderr go to a per-worker log file; the
        # driver's LogMonitor tails it back to the driver's stdout
        # (reference: log_monitor.py publishing remote prints).
        stdout_target = None
        self.log_path = None
        if runtime.log_dir is not None:
            env["PYTHONUNBUFFERED"] = "1"   # lines appear promptly
            self.log_path = os.path.join(
                runtime.log_dir, f"worker-{self.index}.log")
            stdout_target = open(self.log_path, "ab", buffering=0)
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.worker_entry",
               runtime.client_address, self.token]
        prefix_json = env.pop("RAY_TPU_CONTAINER_PREFIX", None)
        if prefix_json:
            # Container runtime env (runtime_env/plugins.py
            # ContainerPlugin): the worker boots THROUGH the
            # container runner's argv prefix. Popped from env so the
            # containerized worker's own spawns don't re-wrap. A real
            # OCI runner starts the container with the IMAGE's env,
            # not this Popen's — every variable the worker needs
            # (import path, session/rendezvous addresses, platform
            # pins, plugin env_vars) must be forwarded explicitly as
            # --env flags, spliced before the image (prefix's last
            # element by the plugin's contract).
            # A worker that holds cards also gets the runner's flag
            # exposing them; the host's ids ride CUDA_VISIBLE_DEVICES
            # (ContainerPlugin's docstring says why not the one card).
            import json as _json

            from ray_tpu_torch.runtime_env.plugins import card_flags
            prefix = _json.loads(prefix_json)
            fwd = [f"--env={k}={v}" for k, v in env.items()
                   if k.startswith(CONTAINER_ENV_PREFIXES)]
            if env.get("CUDA_VISIBLE_DEVICES"):
                fwd = card_flags(prefix[0]) + fwd
            cmd = prefix[:-1] + fwd + [prefix[-1]] + cmd
        self.proc = subprocess.Popen(
            cmd,
            env=env,
            cwd=os.getcwd(),
            stdout=stdout_target,
            stderr=stdout_target,
        )
        if stdout_target is not None:
            stdout_target.close()   # child holds its own fd
        runtime._register_pending_worker(self)

    def attach_conn(self, conn) -> None:
        """Called by the runtime's accept loop once the worker dials in."""
        self.conn = conn
        self._conn_ready.set()
        self.reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"worker_reader_{self.index}")
        self.reader.start()

    def send(self, msg: tuple) -> None:
        # Wait in slices so a worker killed pre-handshake (e.g. its
        # node was removed) surfaces immediately instead of after the
        # full boot timeout — there is no reader-thread EOF to notice
        # it for us until the connection exists.
        deadline = time.monotonic() + self.BOOT_TIMEOUT_S
        while not self._conn_ready.wait(0.25):
            if self.proc.poll() is not None:
                self.dead = True
                self._runtime._forget_worker(self)
                raise WorkerDiedBeforeConnectError(
                    f"worker {self.index} process exited (pid="
                    f"{self.proc.pid}, code={self.proc.returncode}) "
                    f"before connecting")
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"worker {self.index} failed to connect within "
                    f"{self.BOOT_TIMEOUT_S}s (pid={self.proc.pid})")
        with self.send_lock:
            self.conn.send(msg)

    def _read_loop(self) -> None:
        try:
            while True:
                msg = self.conn.recv()
                try:
                    self._runtime._on_worker_message(self, msg)
                except Exception:  # noqa: BLE001
                    # A malformed message must not kill the reader —
                    # that would strand the worker's in-flight task.
                    import traceback as tb
                    tb.print_exc()
        except (EOFError, OSError):
            pass
        finally:
            self.dead = True
            # Reap the child so it doesn't linger as a zombie — a
            # zombie pid still has a /proc entry, which would make the
            # store's dead-pin reaper think the reader is alive.
            try:
                self.proc.wait(timeout=5)
            except Exception:  # noqa: BLE001
                pass
            self._runtime._on_worker_exit(self)

    def shutdown(self, timeout: float = 2.0) -> None:
        try:
            if self._conn_ready.is_set():
                with self.send_lock:
                    self.conn.send((P.EXEC_SHUTDOWN,))
        except (OSError, BrokenPipeError):
            pass
        try:
            self.proc.wait(timeout)
        except Exception:  # noqa: BLE001
            self.proc.terminate()
            try:
                self.proc.wait(1.0)
            except Exception:  # noqa: BLE001
                self.proc.kill()


class _RemoteProc:
    """Process shim for a worker living on a node daemon. Mirrors the
    subprocess.Popen surface the runtime touches (poll/kill/terminate/
    wait/pid/returncode); signals travel over the node channel."""

    def __init__(self, handle: "RemoteWorkerHandle"):
        self._h = handle
        self.pid = -handle.index          # not a local pid
        self.returncode: int | None = None

    def poll(self):
        return self.returncode

    def _signal(self, how: str) -> None:
        try:
            self._h.node.node_send((P.ND_WKILL, self._h.index, how))
        except (OSError, BrokenPipeError, AttributeError):
            pass

    def kill(self):
        self._signal("kill")

    def terminate(self):
        self._signal("term")

    def wait(self, timeout=None):
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        while self.returncode is None:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError
            time.sleep(0.02)
        return self.returncode


class RemoteWorkerHandle:
    """Head-side proxy of a worker process hosted by a node daemon.

    Presents the same surface as WorkerHandle so the dispatch loop,
    task retry, and actor restart machinery treat local and remote
    workers identically (reference: the owner talks to every leased
    worker over the same gRPC PushTask interface regardless of node,
    normal_task_submitter.cc:547). ``send`` forwards the exec-channel
    message over the node's TCP channel; replies come back through
    ``_serve_node`` -> ``_on_worker_message``.
    """

    def __init__(self, runtime: "DriverRuntime", node: NodeRecord,
                 env_key: str, env_vars: dict[str, str]):
        self.index = next(WorkerHandle._counter)
        self.env_key = env_key
        self.node_id = node.node_id
        self.node = node
        self.busy = False
        self.is_actor = False
        self.actor_id: ActorID | None = None
        self.dead = False
        self.last_idle = time.monotonic()
        self.sent_fn_ids: set[str] = set()
        self.log_path = None
        self._runtime = runtime
        self.lease_queue: deque = deque()
        self.lease_lock = threading.Lock()
        self.proc = _RemoteProc(self)
        self.card_hold: CardHold | None = None
        # Non-None => post-attach death handling is owned by the node
        # channel (ND_WEXIT -> _on_worker_exit), matching the local
        # reader-thread contract checked in _start_actor.
        self.conn = ("remote", node.node_id)
        runtime._remote_workers[self.index] = self
        node.node_send((P.ND_WSPAWN, self.index, env_key,
                        dict(env_vars)))

    def send(self, msg: tuple) -> None:
        if self.dead:
            raise WorkerDiedBeforeConnectError(
                f"remote worker {self.index} on {self.node_id} is dead")
        self.node.node_send((P.ND_WMSG, self.index, msg))

    def shutdown(self, timeout: float = 2.0) -> None:
        try:
            self.send((P.EXEC_SHUTDOWN,))
        except (OSError, BrokenPipeError,
                WorkerDiedBeforeConnectError):
            pass
        self._runtime._remote_workers.pop(self.index, None)


# --------------------------------------------------------------------------
# Driver runtime
# --------------------------------------------------------------------------

class DriverRuntime:
    def __init__(self, config: Config, num_cpus: int | None = None,
                 num_gpus: int | None = None,
                 resources: dict[str, float] | None = None,
                 local_mode: bool = False,
                 runtime_env: dict | None = None,
                 log_to_driver: bool = True):
        self.config = config
        self.job_id = JobID.next()
        self.local_mode = local_mode
        self.job_runtime_env = runtime_env or {}
        self._shutdown = False

        ncpu = num_cpus if num_cpus is not None else (os.cpu_count() or 1)
        ngpu = num_gpus if num_gpus is not None else detect_gpu_count()
        head_res: dict[str, float] = {"CPU": float(ncpu)}
        if ngpu:
            head_res["GPU"] = float(ngpu)
        if resources:
            head_res.update(resources)
        # Node table (GCS node-manager analog): the head node holds the
        # init resources; Cluster.add_node adds more logical nodes.
        self._res_cv = threading.Condition()
        self._nodes: dict[str, NodeRecord] = {}
        # Owner-based directory (reference:
        # ownership_based_object_directory.cc): owner-minted put
        # ids embed an 8-byte node tag; this registry maps tags
        # back to nodes so ANY process resolves such locations
        # as a pure function of the id — _obj_locations is only
        # the bootstrap/fallback for them. locate_calls counts
        # daemon directory reads against the head (tests assert
        # it stays flat in steady state).
        self._owner_tags: dict[bytes, str] = {}
        self.locate_calls = 0
        self._node_seq = itertools.count()
        # The head's host: its logical nodes share its cards (one
        # card never goes to two nodes of a host).
        import socket
        self.hostname = socket.gethostname()
        self.head_node_id = self._add_node_locked_free(
            head_res, is_head=True)
        self._rr_counter = itertools.count()  # SPREAD round-robin

        # Object plane
        self.memory_store = MemoryStore()
        cap = config.object_store_memory
        if cap <= 0:
            try:
                total_ram = os.sysconf("SC_PHYS_PAGES") * os.sysconf(
                    "SC_PAGE_SIZE")
            except (ValueError, OSError):
                total_ram = 8 << 30
            cap = int(total_ram * 0.3)
        from ray_tpu_torch.core.object_store import make_shared_store
        self.shm_store = make_shared_store(
            cap, config.spill_dir or temp_path("ray_tpu_torch_spill"),
            config.object_spilling_threshold)
        self._obj_cv = threading.Condition()
        self._errors: dict[ObjectID, bytes] = {}   # oid -> error blob
        self._obj_locations: dict[ObjectID, str] = {}  # "mem" | "shm"
        # Directory-side object sizes (guarded by _obj_cv with the
        # location table): memory_summary attributes store bytes per
        # node/object without touching the stores' own locks.
        self._obj_sizes: dict[ObjectID, int] = {}
        self._put_counter = itertools.count()
        # Per-process deserialization cache for immutable objects
        # (repeated get of the same large ref skips the unpickle and
        # keeps serving zero-copy views); invalidated on delete and
        # on re-store.
        from ray_tpu_torch.core.deser_cache import DeserializationCache
        self._deser_cache = DeserializationCache(
            config.deser_cache_max_bytes, config.deser_cache_min_bytes)

        # Reference counting (driver-local; see object_ref docstring).
        # Three pins per object (reference: reference_count.h):
        #   _refcounts — owner-side live ObjectRef objects;
        #   _escape_nonces — serialized copies in flight, keyed by a
        #     per-copy nonce (pickle adds it, exactly that copy's
        #     materialization consumes it); a copy that is never
        #     deserialized pins forever (conservative);
        #   _container_pins — refs nested inside stored objects,
        #     held for the container's lifetime;
        #   _borrows — live borrower copies in other processes
        #     (deserialize +1, borrower GC -1).
        # Deletable only when all three are zero.
        self._refcounts: dict[ObjectID, int] = {}
        # Escape (transit) pins keyed by per-copy nonce: a pickled
        # copy pins the object until exactly THAT copy materializes
        # (consuming its nonce) — a bare counter could consume pins
        # belonging to unrelated in-flight copies.
        self._escape_nonces: dict[ObjectID, set] = {}
        # Nonces consumed before their escape notification arrived
        # (cross-channel reordering: results ride the exec socket,
        # escapes the client socket) — bounded memory of recent
        # consumptions so the late escape doesn't pin forever.
        self._preconsumed: set = set()
        self._preconsumed_order: deque = deque(
            maxlen=config.preconsumed_window)
        # Window evictions mean a late escape notification for an
        # already-consumed nonce would pin its object forever
        # (conservative but silent) — counted for observability.
        self._preconsumed_evictions = 0
        self._borrows: dict[ObjectID, int] = {}
        # Container pinning (reference: nested refs in
        # reference_count.h): a stored object pins every ObjectRef
        # pickled inside it until the container itself is reclaimed,
        # so a nested ref can be fetched any number of times
        # regardless of borrower churn.
        self._contains: dict[ObjectID, list[ObjectID]] = {}
        self._container_pins: dict[ObjectID, int] = {}
        self._ref_lock = _RefLock(self._apply_deferred_decs)

        # Task plane
        self._tasks: dict[TaskID, TaskRecord] = {}
        self._done_tasks: deque[TaskRecord] = deque(
            maxlen=config.task_event_buffer_size)
        # Pending queues, split by dependency state (replaces the old
        # single O(n)-scanned deque):
        #   _pending_deps    — tasks with unresolved arg refs; the
        #                      scheduler walks these linearly (dep
        #                      state can flip per result store, and
        #                      dep errors must propagate to each).
        #   _ready_classes   — dep-free tasks indexed by scheduling
        #                      class, FIFO per class; one placement
        #                      probe per DISTINCT class serves any
        #                      queue depth (reference: per-
        #                      SchedulingClass queues,
        #                      scheduling_class_util.h). The 100k-task
        #                      drain scans 1 class, not 100k records.
        self._pending_deps: deque[TaskRecord] = deque()
        self._ready_classes: dict[tuple, deque[TaskRecord]] = {}
        # Total pending count — admission's load signal and the
        # introspection/dashboard depth gauge. Mutated under _res_cv,
        # read unlocked (a stale int, never a torn structure).
        self._pending_count = 0
        self._pending_seq = itertools.count(1)
        # Pending-count per scheduling class (see _sched_class): lets
        # a scheduling scan stop as soon as every class present has
        # failed placement this pass. Audited against the queues by
        # _check_pending_invariants_locked (debug knob).
        self._pending_classes: dict[tuple, int] = {}
        # Admission + backpressure (tentpole): bounded control-plane
        # queueing with client-visible ST_BUSY pushback.
        from ray_tpu_torch.core.admission import AdmissionController
        self.admission = AdmissionController(config)
        # EWMA of how late this process's periodic threads wake vs.
        # what they asked for — the head-saturation signal liveness
        # deadlines stretch by (false-positive fix) and the
        # ray_tpu_head_loop_lag_ms gauge.
        self._head_loop_lag_s = 0.0
        # True while any PENDING task might be waiting on arg deps:
        # gates the per-result-store dispatcher wake. Set on every
        # dep-carrying enqueue; cleared only by a full dispatcher scan
        # that saw no dep-carrying task (stale-True costs a spurious
        # wake; stale-False is impossible — both flips hold _res_cv).
        self._pending_has_deps = False
        self._task_lock = threading.Lock()
        self._fn_cache: dict[str, bytes] = {}

        # Streaming generator returns (reference: generator returns,
        # ReportGeneratorItemReturns): task_id -> stream state
        self._streams: dict[TaskID, _StreamState] = {}
        self._stream_lock = threading.Lock()

        # Lineage cache for object reconstruction (LRU by insertion,
        # evicted once the pickled-args budget is exceeded).
        from collections import OrderedDict
        self._lineage: "OrderedDict[TaskID, LineageRecord]" = \
            OrderedDict()
        self._lineage_bytes = 0
        self._lineage_lock = threading.Lock()

        # Worker pool
        self._workers: list[WorkerHandle] = []
        self._idle: dict[str, list[WorkerHandle]] = {}
        self._pool_lock = threading.Lock()
        self._last_reap_ts = 0.0
        self._rview_version = 0
        self._rview_broadcasts = 0
        # Serializes version increment + snapshot + send across the
        # periodic loop and the membership-change seed: without it,
        # two threads can stamp different snapshots with the same
        # version (daemons drop one) or an older snapshot with a
        # higher version (transiently resurrecting a dead node).
        self._rview_lock = threading.Lock()
        self._rview_last = None
        self.max_workers = config.max_workers or max(2, ncpu)

        # Actor plane
        self._actors: dict[ActorID, ActorRecord] = {}
        self._named_actors: dict[str, ActorID] = {}
        self._actor_lock = threading.Lock()

        # Placement groups
        self._pgs: dict[PlacementGroupID, PGRecord] = {}
        self._pg_lock = threading.Lock()

        # Internal KV (GCS InternalKV analog, gcs_kv_manager.cc):
        # namespaced small-metadata store for libraries.
        self._kv: dict[tuple[str, bytes], bytes] = {}
        self._kv_lock = threading.Lock()
        # Long-poll pubsub topics (reference: src/ray/pubsub/).
        self._pubsub: dict[str, dict] = {}
        self._pubsub_lock = threading.Lock()

        # Chunked object transfers in flight (ObjectManager analog):
        # holding the object keeps its bytes/pinned views alive until
        # the puller ends.
        self.transfer_plane = TransferPlane(
            config.object_transfer_chunk_bytes)
        # Chunks the head pulled from a node on behalf of some other
        # consumer — the relay traffic the p2p object plane exists to
        # eliminate (asserted zero in tests/test_p2p_transfer.py).
        self._relay_chunks = 0

        # Drain / recovery observability. lineage_reconstructions
        # counts launched re-executions — a graceful drain must leave
        # it flat (asserted in tests/test_node_drain.py); the drain
        # counters prove the proactive paths actually ran.
        self.lineage_reconstructions = 0
        self.drains_started = 0
        self.drains_completed = 0
        self.drain_objects_evacuated = 0
        self.drain_tasks_preempted = 0
        self.drain_actors_migrated = 0

        # Events / timeline
        self._events: deque = deque(maxlen=config.task_event_buffer_size)
        # Cluster observability plane (SURVEY.md §5.5): aggregates
        # worker/daemon metric pushes, keeps the GcsTaskManager-style
        # task-event store, renders cluster /metrics + timeline.
        from ray_tpu_torch.observability.plane import ObservabilityPlane
        self.observability = ObservabilityPlane(self)

        # Client listener (worker -> driver API proxy + exec channels)
        # NB not <tmp>/ray_tpu_torch: a directory named exactly like
        # the package next to a user's script (or cwd=/tmp) would
        # shadow the real module as an empty namespace package. Nor
        # the JAX package's ray_tpu_sessions: init(address="auto")
        # there must never find this runtime.
        sock_dir = f"{session_root()}/{os.getpid()}"
        os.makedirs(sock_dir, exist_ok=True)
        self.client_address = os.path.join(sock_dir, "runtime.sock")
        # Per-worker log capture + driver-side republish (reference:
        # log_monitor.py). log_dir=None disables capture.
        self.log_dir: str | None = None
        self.log_monitor = None
        if log_to_driver:
            self.log_dir = os.path.join(sock_dir, "logs")
            os.makedirs(self.log_dir, exist_ok=True)
            from ray_tpu_torch.core.log_monitor import LogMonitor
            self.log_monitor = LogMonitor(self.log_dir)
        # All channels ride the hardened wire layer (core/wire.py):
        # checksummed sequenced frames, heartbeat-aware, chaos-
        # injectable. The head is the "head" node for fault rules
        # scoped to node boundaries.
        wire.set_local_node("head")
        self._listener = wire.WireListener(
            self.client_address, family="AF_UNIX",
            kind=wire.K_CLIENT)
        self._pending_workers: dict[str, WorkerHandle] = {}
        self._pending_workers_lock = threading.Lock()
        self._client_threads: list[threading.Thread] = []
        # In-flight direct (worker-written) puts: oid -> (total, refs)
        # until the worker commits. Orphans (writer disconnected
        # mid-put) age out on a grace timer before their slot is
        # freed — the writer may still hold a live view.
        self._pending_direct: dict[ObjectID, tuple] = {}
        # Owned actor-call replay guard (actor tasks have no _tasks
        # entry keyed by TaskID at submit time — calls queue on the
        # ActorRecord — so dedupe-by-id needs its own structure).
        # Insertion-ordered so trimming drops the OLDEST ids.
        from collections import OrderedDict as _OD
        self._actor_owned_seen: "_OD" = _OD()
        self._orphan_direct: dict[bytes, float] = {}
        # node_id -> latest per-node agent sample (dashboard).
        self._agent_stats: dict[str, dict] = {}
        # Introspection/profiling plane (SURVEY §L6): worker client
        # connections that registered as profile-capable (the head
        # pushes SRV_REQ frames down them), pending upcall tokens,
        # and the one-capture-at-a-time cluster session guard.
        self._profile_peers: dict[int, dict] = {}
        self._profile_peers_lock = threading.Lock()
        self._profile_peer_seq = itertools.count(1)
        self._profile_results: dict[str, tuple] = {}
        self._profile_results_lock = threading.Lock()
        self._profile_session_lock = threading.Lock()
        # Direct actor-call plane: actor_id -> (addr, token_hex,
        # epoch) announced by the hosting worker's listener; the
        # OP_ACTOR_LOCATION lease hands it to callers. Epoch bumps on
        # every (re)registration and the entry is dropped on actor
        # death/kill/migration, so a stale lease can only ever point
        # at a closed socket (callers fall back and re-resolve).
        self._direct_registry: dict[ActorID, tuple] = {}
        self._direct_epoch: dict[ActorID, int] = {}
        self._direct_reg_lock = threading.Lock()
        # Per-op counts of client-channel frames the head has served
        # (oplog-style observability; tests/perf pin the zero-head-
        # frames steady-state contract with it).
        self.client_op_counts: dict[str, int] = {}
        self._op_count_lock = threading.Lock()
        # Reply cache for client-replayed mutating ops (see
        # protocol.wrap_dd): dd_id -> (status, payload), plus in-flight
        # events so a replay racing the original coalesces onto it.
        self._dd_lock = threading.Lock()
        self._dd_results: "OrderedDict[str, tuple]" = OrderedDict()
        self._dd_inflight: dict[str, threading.Event] = {}
        # Wire TaskOptions blobs -> shared deserialized instance
        # (_loads_options_cached).
        self._opts_blob_cache: dict[bytes, TaskOptions] = {}
        # Cached threads for blocking client ops (thread-per-message
        # spawn was ~12% of head CPU in the task-storm profile).
        self._client_op_pool = _CachedThreadPool("client_op")
        # Per-connection admission identity (fairness accounting keys
        # on it; a reconnect gets a fresh key).
        self._client_key_seq = itertools.count(1)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="client_accept")
        self._accept_thread.start()

        # Cross-host control plane (GCS gRPC analog): a TCP listener
        # node daemons and remote clients dial, started lazily by
        # ensure_tcp_listener(). One NodeRecord.conn per daemon.
        self._tcp_listener = None
        self.tcp_address: tuple[str, int] | None = None
        self.cluster_token: bytes = os.urandom(16)
        self._remote_workers: dict[int, RemoteWorkerHandle] = {}
        self._node_calls: dict[int, tuple] = {}   # fid -> (event, slot)
        self._node_calls_lock = threading.Lock()
        self._node_fid = itertools.count(1)
        # Objects homed in a daemon's local store (location =
        # ("node", node_id)): per-node index for death handling.
        self._node_objects: dict[str, set[ObjectID]] = {}
        # Secondary copies made by p2p pulls (plasma caches pulled
        # objects the same way): oid -> nodes holding a replica.
        # Freed together with the primary; promoted to primary when
        # the home node dies (saving a lineage reconstruction).
        self._obj_replicas: dict[ObjectID, set[str]] = {}

        if not local_mode:
            self._dispatch_thread = threading.Thread(
                target=self._dispatch_loop, daemon=True, name="dispatcher")
            self._dispatch_thread.start()
            # Health/gauge loop runs from birth, not from the first
            # daemon registration: a daemon-less head still owes the
            # scrape its ray_tpu_head_* admission gauges and needs
            # the loop-lag EWMA feeding lag-scaled deadlines.
            self._ensure_health_thread()
            # Signals loop: samples the merged registry into the
            # head-side time-series store and evaluates the SLO
            # burn-rate rules. Its own thread (not the health loop)
            # so the sampling cadence is independent of
            # health_check_period_s; never started when disabled.
            if config.metrics_export_enabled \
                    and config.signals_enabled:
                self._signals_thread = threading.Thread(
                    target=self._signals_loop, daemon=True,
                    name="signals")
                self._signals_thread.start()

        # Memory monitor / OOM killer (reference: MemoryMonitor N26)
        self.memory_monitor = None
        if not local_mode and config.memory_usage_threshold > 0:
            from ray_tpu_torch.core.memory_monitor import MemoryMonitor
            self.memory_monitor = MemoryMonitor(
                self, config.memory_usage_threshold,
                config.memory_monitor_refresh_s)

    # ---------------- object plane ----------------

    def register_ref(self, ref: ObjectRef) -> ObjectRef:
        with self._ref_lock:
            self._refcounts[ref.id] = self._refcounts.get(ref.id, 0) + 1
        if ref._del_cb is None:
            ref._del_cb = self._dec_ref
        else:
            # Same instance registered twice (rare): the __del__ slot
            # fires once, so the extra count needs its own finalizer.
            import weakref
            weakref.finalize(ref, self._dec_ref, ref.id)
        return ref

    def _pinned_locked(self, oid: ObjectID) -> bool:
        return (self._refcounts.get(oid, 0) > 0
                or bool(self._escape_nonces.get(oid))
                or self._borrows.get(oid, 0) > 0
                or self._container_pins.get(oid, 0) > 0)

    def _consume_escape_locked(self, oid: ObjectID, nonce) -> None:
        """Consume one copy's transit pin; remembers early
        consumptions so a late-arriving escape is dropped."""
        if nonce is None:
            return
        s = self._escape_nonces.get(oid)
        if s is not None and nonce in s:
            s.discard(nonce)
            if not s:
                self._escape_nonces.pop(oid, None)
            return
        if nonce in self._preconsumed:
            # Already recorded (e.g. a stored blob re-deserialized many
            # times re-submits its long-consumed nonces): keep the one
            # entry instead of flooding the window — and never append
            # deque duplicates, whose eviction would drop the set entry
            # while a newer copy is still queued.
            return
        if len(self._preconsumed_order) == \
                self._preconsumed_order.maxlen:
            self._preconsumed.discard(self._preconsumed_order[0])
            self._preconsumed_evictions += 1
            if self._preconsumed_evictions == 1:
                import sys
                print(
                    "ray_tpu: preconsumed-nonce window overflowed; "
                    "under heavy borrow traffic a reordered escape "
                    "notification may leave a permanent object pin "
                    "(raise RAY_TPU_PRECONSUMED_WINDOW to avoid)",
                    file=sys.stderr)
        self._preconsumed.add(nonce)
        self._preconsumed_order.append(nonce)

    def _delete_object(self, oid: ObjectID) -> None:
        self._lineage_release_return(oid)
        self._deser_cache.invalidate(oid)
        with self._obj_cv:
            loc = self._obj_locations.pop(oid, None)
            self._obj_sizes.pop(oid, None)
            replica_nodes = self._obj_replicas.pop(oid, set())
        # Target the store the location names — an unconditional
        # native-store delete takes the arena's process-shared lock
        # on EVERY small-object GC (the hot actor-call path).
        if loc == "shm":
            self.shm_store.delete(oid)
        elif loc == "mem":
            self.memory_store.delete(oid)
        else:
            self.memory_store.delete(oid)
            self.shm_store.delete(oid)
        if isinstance(loc, tuple):
            self._node_objects.get(loc[1], set()).discard(oid)
            replica_nodes.add(loc[1])
        # Node-homed copies (primary + p2p replicas): tell each daemon
        # to drop its copy.
        for nid in replica_nodes:
            node = self._nodes.get(nid)
            if node is not None and node.alive and node.is_daemon:
                try:
                    node.node_send((P.ND_CALL, -1, "free",
                                    oid.binary()))
                except (OSError, BrokenPipeError):
                    pass
        # Cascade: refs nested in this object lose their container
        # pin; reclaim any that became unreferenced.
        with self._ref_lock:
            to_free = []
            for rid in self._contains.pop(oid, ()):
                c = self._container_pins.get(rid, 0) - 1
                if c > 0:
                    self._container_pins[rid] = c
                else:
                    self._container_pins.pop(rid, None)
                    if not self._pinned_locked(rid):
                        to_free.append(rid)
        for rid in to_free:
            self._delete_object(rid)

    def _register_contained_refs(self, oid: ObjectID, obj) -> None:
        refs = getattr(obj, "contained_refs", None)
        if not refs:
            return
        with self._ref_lock:
            # Re-stores (task retried / duplicate completion) MERGE:
            # the retry blob may reference different inner ids, and
            # whichever blob won the store must have its refs pinned —
            # over-pinning both attempts until container delete is
            # safe, dropping either is not.
            self._contains.setdefault(oid, []).extend(
                rid for rid, _n in refs)
            for rid, nonce in refs:
                self._container_pins[rid] = \
                    self._container_pins.get(rid, 0) + 1
                # The container pin supersedes this copy's transit
                # (escape) pin — consume its nonce so a driver-side
                # put of refs doesn't pin them forever.
                self._consume_escape_locked(rid, nonce)

    def _dec_ref(self, oid: ObjectID) -> None:
        if self._ref_lock.held_here():
            # A collection inside a locked region ran the finalizer.
            self._ref_lock.deferred.append(oid)
            return
        with self._ref_lock:
            cnt = self._refcounts.get(oid, 0) - 1
            if cnt > 0:
                self._refcounts[oid] = cnt
                return
            self._refcounts.pop(oid, None)
            if self._pinned_locked(oid):
                return
        self._delete_object(oid)

    def _apply_deferred_decs(self) -> None:
        """The decrements finalizers queued while this thread held
        ``_ref_lock``."""
        oids = []
        while True:
            try:
                oids.append(self._ref_lock.deferred.popleft())
            except IndexError:   # empty, or emptied by another thread
                break
        for oid in oids:
            try:
                self._dec_ref(oid)
            except Exception:  # noqa: BLE001 — as ObjectRef.__del__ does
                pass

    def on_ref_escaped(self, oid: ObjectID, nonce=None) -> None:
        """A copy of this ref was serialized out of the owner (task
        arg, nested object, client return): pin until that copy
        materializes (transferring the pin to _borrows or a container
        pin) — or forever, if it never does. A None nonce is a
        deliberate permanent pin (e.g. results handed to a client
        process that registers no borrows)."""
        with self._ref_lock:
            if nonce is None:
                import uuid
                nonce = f"perm-{uuid.uuid4().hex}"
            elif nonce in self._preconsumed:
                # This copy already materialized (notification raced
                # ahead on another channel) — nothing to pin.
                self._preconsumed.discard(nonce)
                return
            self._escape_nonces.setdefault(oid, set()).add(nonce)

    def on_borrow_add(self, oid: ObjectID, nonce=None) -> None:
        """A borrower deserialized a copy: consume that copy's escape
        pin (by nonce — rehydrating the same blob twice consumes it
        once) and count the live copy."""
        with self._ref_lock:
            self._consume_escape_locked(oid, nonce)
            self._borrows[oid] = self._borrows.get(oid, 0) + 1

    def on_borrow_release(self, oid: ObjectID) -> None:
        """A borrower's copy was garbage-collected. When no pins of
        any kind remain, the object is reclaimed — long-running
        sessions stop accumulating escaped objects."""
        with self._ref_lock:
            cnt = self._borrows.get(oid, 0) - 1
            if cnt > 0:
                self._borrows[oid] = cnt
                return
            self._borrows.pop(oid, None)
            if cnt < 0 or self._pinned_locked(oid):
                return
        self._delete_object(oid)

    def on_ref_deserialized(self, ref: ObjectRef, nonce=None) -> None:
        # Driver re-receiving one of its own refs: register a live
        # refcount pin tied to THIS instance's lifetime — without it,
        # a container-delete cascade could reclaim the object while
        # the driver still holds the rehydrated ref. Deliberately no
        # nonce consumption: the same blob may still be in flight to
        # a worker.
        self.register_ref(ref)

    def put(self, value) -> ObjectRef:
        oid = ObjectID.for_put(next(self._put_counter))
        # copy_buffers=False: the store copies straight from the
        # source arrays into its destination (arena slot / segment /
        # materialized bytes) inside _store_value, so the extra
        # .tobytes() pass here would be pure overhead — this is the
        # single-copy large-put path.
        self._store_value(oid, ser.serialize(value,
                                             copy_buffers=False))
        return self.register_ref(ObjectRef(oid))

    def put_serialized(self, obj: SerializedObject) -> ObjectRef:
        oid = ObjectID.for_put(next(self._put_counter))
        self._store_value(oid, obj)
        return self.register_ref(ObjectRef(oid))

    def _store_value(self, oid: ObjectID, obj: SerializedObject) -> None:
        self._register_contained_refs(oid, obj)
        # A re-store (duplicate completion, lineage reconstruction)
        # must not leave the cache serving the previous blob's value.
        self._deser_cache.invalidate(oid)
        if obj.total_size >= self.config.max_direct_call_object_size:
            self.shm_store.put(oid, obj)      # copies into shm now
            loc = "shm"
        else:
            # The memory store RETAINS the object: materialize any
            # live-view buffers so a later caller-side mutation can't
            # reach the stored copy.
            obj = ser.materialize(obj)
            self.memory_store.put(oid, obj)
            loc = "mem"
        with self._obj_cv:
            self._obj_locations[oid] = loc
            self._obj_sizes[oid] = obj.total_size
            self._obj_cv.notify_all()
        self._wake_dispatcher_for_deps()

    def _wake_dispatcher_for_deps(self) -> None:
        """Wake the dispatcher only when some pending task might be
        waiting on arg deps. An unconditional wake per stored result
        made a deep no-dep queue quadratic: every result triggered a
        full O(pending) scheduling scan that placed nothing (workers
        all busy). Resource frees wake via _release, not here."""
        if self._pending_has_deps:
            with self._res_cv:
                self._res_cv.notify_all()

    def _store_error(self, oid: ObjectID, err_blob: bytes) -> None:
        with self._obj_cv:
            self._errors[oid] = err_blob
            self._obj_locations[oid] = "err"
            self._obj_cv.notify_all()
        self._wake_dispatcher_for_deps()

    def _object_available(self, oid: ObjectID) -> bool:
        return oid in self._obj_locations

    def _probe_ready_locked(self, oids) -> list:
        """One pass over the location table (caller holds _obj_cv) —
        the single availability probe under wait() AND batched get(),
        so a wait-then-get loop polls one structure one way."""
        table = self._obj_locations
        return [o for o in oids if o in table]

    def wait_available(self, oids: list[ObjectID], num_returns: int,
                       timeout: float | None) -> tuple[list, list]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._obj_cv:
            while True:
                ready = self._probe_ready_locked(oids)
                if len(ready) >= num_returns:
                    ready_set = set(ready[:num_returns])
                    done = [o for o in oids if o in ready_set]
                    rest = [o for o in oids if o not in ready_set]
                    return done, rest
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    ready_set = set(ready)
                    return ([o for o in oids if o in ready_set],
                            [o for o in oids if o not in ready_set])
                self._obj_cv.wait(remaining)

    def _wait_locations_many(self, oids, deadline: float | None) -> dict:
        """Batched ``_wait_location``: ONE condition-wait loop resolves
        the whole list instead of one blocking wait per ref. Returns
        {oid: "mem"|"shm"|"err"|("node", nid)} for every oid.

        Error semantics mirror the serial loop exactly: a stored
        error is raised only once every ref BEFORE it (in list order)
        has resolved — the serial loop would still be blocked on an
        earlier unresolved ref and never reach the error. On timeout,
        the first unresolved ref in list order names the
        GetTimeoutError."""
        locs: dict = {}
        pending = set()
        for o in oids:
            if o not in locs:
                pending.add(o)
        with self._obj_cv:
            while True:
                resolved = []
                for o in pending:
                    loc = self._obj_locations.get(o)
                    if loc is None:
                        loc = self._owned_route(o)
                    if loc is not None:
                        locs[o] = loc
                        resolved.append(o)
                pending.difference_update(resolved)
                # First-error-wins over the resolved PREFIX.
                for o in oids:
                    loc = locs.get(o)
                    if loc is None:
                        break
                    if loc == "err":
                        raise ser.loads(self._errors[o])
                if not pending:
                    return locs
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    for o in oids:
                        if o in pending:
                            raise GetTimeoutError(o.hex())
                self._obj_cv.wait(remaining)

    def _owned_route(self, oid: ObjectID):
        """Directory-as-a-function-of-the-id: owner-minted put ids
        resolve to their owner node with NO table read (reference:
        ownership_based_object_directory.cc — locations come from the
        owner, not a central store)."""
        tag = oid.owner_tag()
        if tag is None:
            return None
        nid = self._owner_tags.get(tag)
        if nid is None:
            return None
        node = self._nodes.get(nid)
        if node is None or not node.alive:
            return None
        return ("node", nid)

    def _wait_location(self, oid: ObjectID,
                       deadline: float | None) -> str:
        """Block until the object has a location; raises the stored
        error or GetTimeoutError. Returns "mem" | "shm" |
        ("node", node_id)."""
        with self._obj_cv:
            while oid not in self._obj_locations:
                owned = self._owned_route(oid)
                if owned is not None:
                    return owned
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError(oid.hex())
                self._obj_cv.wait(remaining)
            loc = self._obj_locations[oid]
            if loc == "err":
                raise ser.loads(self._errors[oid])
            return loc

    def get_serialized(self, oid: ObjectID,
                       timeout: float | None = None) -> SerializedObject:
        deadline = None if timeout is None else time.monotonic() + timeout
        loc = self._wait_location(oid, deadline)
        if isinstance(loc, tuple):      # ("node", node_id)
            try:
                return self._fetch_from_node(loc[1], oid, deadline)
            except ObjectLostError:
                # The holder died under us (get racing node death):
                # the death handler may not have reached this oid yet,
                # so try lineage recovery here instead of surfacing a
                # loss the system can repair.
                with self._obj_cv:
                    if self._obj_locations.get(oid) == loc:
                        self._obj_locations.pop(oid, None)
                self._deser_cache.invalidate(oid)
                if not self._try_reconstruct(oid):
                    raise
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                return self.get_serialized(oid, remaining)
        if loc == "mem":
            obj = self.memory_store.try_get(oid)
            if obj is not None:
                return obj
        read_local = getattr(self.shm_store, "read_local", None)
        if read_local is not None:
            obj = read_local(oid)
            if obj is not None:
                return obj
        desc = self.shm_store.get_descriptor(oid)
        if desc is None:
            # raced a deletion, or the spilled copy is gone
            obj = self.memory_store.try_get(oid)
            if obj is None:
                with self._obj_cv:
                    self._obj_locations.pop(oid, None)
                self._deser_cache.invalidate(oid)
                if self._try_reconstruct(oid):
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    return self.get_serialized(oid, remaining)
                raise ObjectLostError(oid.hex())
            return obj
        return read_descriptor(desc)

    def get_serialized_or_desc(self, oid: ObjectID,
                               timeout: float | None = None):
        """("desc", descriptor) for shm-resident objects — the caller
        (a worker on this node) maps and reads the arena zero-copy —
        else ("obj", SerializedObject) shipped inline. The timeout
        covers the whole call (the inline fallback gets the remaining
        budget, not a fresh one)."""
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        loc = self._wait_location(oid, deadline)
        if loc == "shm":
            desc = self.shm_store.get_descriptor(oid)
            if desc is not None:
                return ("desc", desc)
        remaining = (None if deadline is None
                     else max(0.0, deadline - time.monotonic()))
        return ("obj", self.get_serialized(oid, remaining))

    # -- chunked transfer plane (ObjectManager analog, SURVEY §2.1
    # N17: ObjectBufferPool chunking + pull-based flow control; the
    # "remote node" here is any client that cannot map the shm arena).

    def _start_transfer(self, obj: SerializedObject) -> tuple:
        return self.transfer_plane.start(obj)

    def _transfer_chunk(self, tid: str, index: int) -> bytes:
        return self.transfer_plane.chunk(tid, index)

    # Test/introspection shims over the transfer plane.
    @property
    def _transfers(self) -> dict:
        return self.transfer_plane.table

    @property
    def _transfer_chunks_served(self) -> int:
        return self.transfer_plane.chunks_served

    def get_serialized_many(self, oids: list[ObjectID],
                            timeout: float | None = None
                            ) -> list[SerializedObject]:
        """Vectorized resolution of a ref list: ONE batched
        availability wait for the whole list, then local reads inline
        and node-homed pulls fanned out on a bounded thread pool
        (reference: CoreWorkerMemoryStore GetAsync batching +
        PullManager concurrent pulls) instead of the serial
        wait+fetch loop that paid max-latency per ref."""
        if len(oids) == 1:
            return [self.get_serialized(oids[0], timeout)]
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        locs = self._wait_locations_many(oids, deadline)

        def resolve(oid: ObjectID) -> SerializedObject:
            remaining = (None if deadline is None
                         else max(deadline - time.monotonic(), 0.0))
            # get_serialized re-checks the (now warm) location and
            # owns every fallback: spill reads, reconstruction,
            # holder-death retries.
            return self.get_serialized(oid, remaining)

        remote = [o for o, loc in locs.items()
                  if isinstance(loc, tuple)]
        resolved: dict = {}
        if len(remote) > 1:
            objs = _parallel_map_first_error(
                resolve, remote, max(1, self.config.get_parallelism))
            resolved = dict(zip(remote, objs))
        return [resolved[o] if o in resolved else resolve(o)
                for o in oids]

    @property
    def deser_cache_hits(self) -> int:
        return self._deser_cache.hits

    @property
    def deser_cache_misses(self) -> int:
        return self._deser_cache.misses

    def get(self, refs, timeout: float | None = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        oids = [r.id for r in refs]
        values: dict = {}
        misses: list = []
        for o in dict.fromkeys(oids):       # unique, order-preserving
            hit, val = self._deser_cache.lookup(o)
            if hit:
                values[o] = val
            else:
                misses.append(o)
        if misses:
            objs = self.get_serialized_many(misses, timeout)
            for o, so in zip(misses, objs):
                val = ser.deserialize(so)
                self._deser_cache.offer(o, val, so.total_size)
                values[o] = val
        out = [values[o] for o in oids]
        return out[0] if single else out

    def _serve_get_entry(self, oid: ObjectID,
                         timeout: float | None, allow_desc: bool):
        """One client-get wire entry — desc | inline | chunked —
        shared by OP_GET and OP_GET_MANY so the serving policy cannot
        diverge between the single and batched paths."""
        if allow_desc:
            kind, val = self.get_serialized_or_desc(oid, timeout)
            if kind == "desc":
                return ("desc", val)
        else:
            val = self.get_serialized(oid, timeout)
        if val.total_size > self.config.object_transfer_inline_max:
            # Chunked pull (ObjectManager analog): the client fetches
            # fixed-size chunks as separate req/resp rounds, so other
            # client ops interleave instead of queueing behind one
            # multi-GB message.
            return self._start_transfer(val)
        data, bufs = _sendable(val)
        return ("inline", data, bufs)

    async def get_async(self, ref: ObjectRef):
        import asyncio
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self.get, ref)

    def as_future(self, ref: ObjectRef):
        import concurrent.futures
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def run():
            try:
                fut.set_result(self.get(ref))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True).start()
        return fut

    def wait(self, refs: list[ObjectRef], num_returns: int = 1,
             timeout: float | None = None):
        done_ids, rest_ids = self.wait_available(
            [r.id for r in refs], num_returns, timeout)
        by_id = {r.id: r for r in refs}
        return [by_id[i] for i in done_ids], [by_id[i] for i in rest_ids]

    # ---------------- function cache ----------------

    def register_function(self, fn: Callable) -> tuple[str, bytes]:
        blob = ser.dumps(fn)
        fn_id = hashlib.sha1(blob).hexdigest()
        self._fn_cache.setdefault(fn_id, blob)
        return fn_id, blob

    # ---------------- task plane ----------------

    def submit_task(self, fn_id: str, fn_blob: bytes | None,
                    fn_name: str, args: tuple, kwargs: dict,
                    options: TaskOptions,
                    preminted: tuple | None = None,
                    packed: tuple | None = None,
                    client_key: str = "driver"
                    ) -> list[ObjectRef]:
        """``packed=(args_blob, arg_refs)`` reuses an already-encoded
        args payload (owned submits: the client's blob, proven
        ref-free) instead of re-serializing — safe ONLY when the blob
        contains no pickled ObjectRefs (each carries a one-shot
        nonce that must be re-minted per hop).

        NB the preminted non-streaming registration sequence below
        (dup check, lineage gate, PENDING event, pending add, ref
        pins) is MIRRORED by _handle_owned_submit_many's batch
        transaction — change one, change both
        (tests/test_core_regressions.py pins their equivalence)."""
        if fn_blob is not None:
            self._fn_cache.setdefault(fn_id, fn_blob)
        if (client_key == "driver" and not self.local_mode
                and self.admission.enabled
                and self._pending_count >= self.admission.high):
            # Driver-local backpressure: in-process submits have no
            # wire channel to push ST_BUSY down, so the submitting
            # thread blocks until the queue drains below the
            # watermark. BOUNDED: a queue full of tasks that can only
            # run after THIS submission's downstream consumers (dep
            # chains) must not deadlock the driver — past the bound
            # the task is admitted anyway.
            deadline = (time.monotonic()
                        + self.config.admission_driver_block_s)
            with self._res_cv:
                while (self._pending_count >= self.admission.high
                       and time.monotonic() < deadline
                       and not self._shutdown):
                    self._res_cv.wait(0.05)
        # Resolve the runtime env now: a broken env (task- OR
        # job-level) fails at .remote() with RuntimeEnvSetupError, and
        # dispatch/retries reuse the resolved result.
        env_key, env_vars = self._env_for_options_cached(options)
        streaming = options.num_returns == "streaming"
        if preminted is not None:
            # Ownership-model submit: the CLIENT minted the ids (and
            # already holds refs to them) — register, don't re-mint.
            # Idempotent under dd-replay by task id.
            task_id, return_ids = preminted
            with self._task_lock:
                if task_id in self._tasks:
                    return [self.register_ref(ObjectRef(o))
                            for o in return_ids]
        else:
            task_id = TaskID.for_normal_task(self.job_id)
            return_ids = [] if streaming else [
                ObjectID.for_return(task_id, i)
                for i in range(options.num_returns)]
        if packed is not None:
            args_blob, arg_refs = packed
        else:
            args_blob, arg_refs = self._pack_args(args, kwargs)
        rec = TaskRecord(
            task_id=task_id, fn_id=fn_id, name=fn_name or "task",
            args_blob=args_blob, arg_refs=arg_refs, options=options,
            return_ids=return_ids, submitted_at=time.time(),
            env_key=env_key, env_vars=env_vars,
            client_key=client_key)
        with self._task_lock:
            self._tasks[task_id] = rec
        effective_retries = (options.max_retries
                             if options.max_retries >= 0
                             else self.config.task_max_retries)
        if (not streaming and effective_retries > 0
                and self.config.lineage_cache_max_bytes > 0):
            # max_retries=0 declares the task unsafe to re-run (side
            # effects): its returns are not reconstructable, matching
            # the reference's retryable-task gate.
            self._lineage_put(task_id, LineageRecord(
                fn_id=fn_id, name=rec.name, args_blob=args_blob,
                arg_refs=list(arg_refs), options=options,
                return_ids=list(return_ids),
                nbytes=len(args_blob) + 256))
        if streaming:
            with self._stream_lock:
                self._streams[task_id] = _StreamState(
                    cv=threading.Condition())
        self._event(rec, "PENDING")

        if self.local_mode:
            self._execute_local(rec)
        else:
            with self._res_cv:
                self._pending_add_locked(rec)
                self._res_cv.notify_all()
        if streaming:
            return ObjectRefGenerator(task_id.binary(), _owner=True)
        return [self.register_ref(ObjectRef(oid)) for oid in return_ids]

    _EMPTY_ARGS_BLOB = None

    def _pack_args(self, args: tuple, kwargs: dict):
        # Top-level ObjectRefs are resolved to values before execution
        # (reference: LocalDependencyResolver / plasma arg fetch). Nested
        # refs pass through as refs.
        if not args and not kwargs:
            # No-arg calls (the common case for control-heavy loads)
            # share one cached pickle instead of re-encoding ((), {})
            # per submit.
            blob = DriverRuntime._EMPTY_ARGS_BLOB
            if blob is None:
                blob = DriverRuntime._EMPTY_ARGS_BLOB = \
                    ser.dumps(((), {}))
            return blob, []
        arg_refs = [a for a in list(args) + list(kwargs.values())
                    if isinstance(a, ObjectRef)]
        return ser.dumps((args, kwargs)), arg_refs

    def _resolve_args_payload(self, rec_args_blob: bytes,
                              arg_refs: list[ObjectRef],
                              remote: bool = False):
        # Ship resolved values of top-level refs alongside: small
        # objects inline; shm-resident objects as descriptors the
        # worker reads zero-copy from the mapped arena (plasma arg
        # fetch — the bytes never transit the exec socket). For
        # daemon-hosted workers, node-homed values go as ("fetch",
        # oid) markers: the worker pulls through its client channel,
        # which its local daemon serves straight from the node store
        # when the object is already there.
        resolved = {}
        for r in arg_refs:
            if remote:
                loc = self._obj_locations.get(r.id)
                if isinstance(loc, tuple):
                    resolved[r.id.binary()] = ("fetch", r.id.binary())
                    continue
                # A daemon-hosted worker cannot map the head's arena:
                # small values go inline; large ones as fetch markers
                # so the bytes ride the chunked pull plane instead of
                # head-of-line-blocking the multiplexed node channel.
                obj = self.get_serialized(r.id)
                if (obj.total_size
                        > self.config.object_transfer_inline_max):
                    resolved[r.id.binary()] = ("fetch", r.id.binary())
                else:
                    data, bufs = _sendable(obj)
                    resolved[r.id.binary()] = ("inline", data, bufs)
                continue
            kind, val = self.get_serialized_or_desc(r.id)
            if kind == "desc":
                resolved[r.id.binary()] = ("desc", val)
            else:
                resolved[r.id.binary()] = ("inline", val.data,
                                           val.buffers)
        return resolved

    def _execute_local(self, rec: TaskRecord) -> None:
        fn = ser.loads(self._fn_cache[rec.fn_id])
        args, kwargs = ser.loads(rec.args_blob)
        args = tuple(self.get(a) if isinstance(a, ObjectRef) else a
                     for a in args)
        kwargs = {k: (self.get(v) if isinstance(v, ObjectRef) else v)
                  for k, v in kwargs.items()}
        rec.state = "RUNNING"
        rec.started_at = time.time()
        try:
            result = fn(*args, **kwargs)
            if rec.options.num_returns == "streaming":
                for i, item in enumerate(result):
                    self._stream_item(rec.task_id, i,
                                      ser.serialize(item))
                self._finish_stream(rec.task_id)
            else:
                self._store_returns(rec, result)
            rec.state = "FINISHED"
        except Exception as e:  # noqa: BLE001
            tb = traceback.format_exc()
            err = TaskError(rec.name, tb, e)
            blob = ser.dumps(err)
            for oid in rec.return_ids:
                self._store_error(oid, blob)
            self._finish_stream(rec.task_id, blob)
            rec.state = "FAILED"
        rec.finished_at = time.time()
        self._event(rec, rec.state)
        self._prune_task(rec)

    def _store_returns(self, rec: TaskRecord, result) -> None:
        n = rec.options.num_returns
        if n == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != n:
                raise ValueError(
                    f"task {rec.name} declared num_returns={n} but "
                    f"returned {len(values)} values")
        for oid, v in zip(rec.return_ids, values):
            self._store_value(oid, v if isinstance(v, SerializedObject)
                              else ser.serialize(v))

    # ---------------- memory pressure (OOM killer) ----------------

    def oom_kill_one(self) -> bool:
        """Retriable-FIFO worker-killing policy (reference:
        worker_killing_policy_retriable_fifo.h): kill the NEWEST
        running retriable normal task — it has made the least
        progress and will be retried by the worker-death path; fall
        back to the newest running task when none are retriable."""
        with self._task_lock:
            running = [r for r in self._tasks.values()
                       if r.state == "RUNNING" and r.worker is not None
                       and not r.worker.is_actor]
            if not running:
                return False

            def retriable(r: TaskRecord) -> bool:
                mr = (r.options.max_retries
                      if r.options.max_retries >= 0
                      else self.config.task_max_retries)
                return r.attempts <= mr

            pool = [r for r in running if retriable(r)] or running
            victim = max(pool, key=lambda r: r.started_at)
            victim.oom_killed = True
        try:
            victim.worker.proc.terminate()
        except Exception:  # noqa: BLE001
            return False
        return True

    # ---------------- streaming returns ----------------

    def _stream_item(self, task_id: TaskID, index: int,
                     obj: SerializedObject) -> None:
        oid = ObjectID.for_return(task_id, index)
        self._store_value(oid, obj)
        with self._stream_lock:
            st = self._streams.get(task_id)
        if st is None:
            # Stream was dropped: free the stored item everywhere it
            # may live (large items land in shm, not memory_store) —
            # via _delete_object so nested-ref pins cascade.
            self._delete_object(oid)
            return
        ref = self.register_ref(ObjectRef(oid))
        with st.cv:
            st.ready.append(ref)
            st.produced += 1
            st.cv.notify_all()

    def _finish_stream(self, task_id: TaskID,
                       err_blob: bytes | None = None) -> None:
        with self._stream_lock:
            st = self._streams.get(task_id)
        if st is None:
            return
        with st.cv:
            st.done = True
            if err_blob is not None:
                st.err_blob = err_blob
            st.cv.notify_all()

    def stream_next(self, task_id_bytes: bytes,
                    timeout: float | None = None) -> ObjectRef | None:
        """Next ObjectRef of a streaming task; None = exhausted."""
        task_id = TaskID(task_id_bytes)
        with self._stream_lock:
            st = self._streams.get(task_id)
        if st is None:
            return None
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        with st.cv:
            while True:
                if st.ready:
                    st.consumed += 1
                    return st.ready.popleft()
                if st.err_blob is not None:
                    raise ser.loads(st.err_blob)
                if st.done:
                    with self._stream_lock:
                        self._streams.pop(task_id, None)
                    return None
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("stream_next timed out")
                st.cv.wait(remaining)

    def drop_stream(self, task_id_bytes: bytes) -> None:
        """Consumer abandoned the generator: delete unconsumed items."""
        task_id = TaskID(task_id_bytes)
        with self._stream_lock:
            st = self._streams.pop(task_id, None)
        if st is None:
            return
        with st.cv:
            # Unconsumed ObjectRefs die with this deque; their
            # weakref finalizers (register_ref) free the stored values.
            st.ready.clear()
            st.done = True
            st.cv.notify_all()

    # ---------------- dispatch loop (raylet analog) ----------------

    def _dispatch_loop(self) -> None:
        while not self._shutdown:
            try:
                self._dispatch_loop_step()
            except Exception:  # noqa: BLE001
                # The dispatcher must survive anything — a dead
                # dispatcher strands every future task as PENDING.
                traceback.print_exc()
                time.sleep(0.1)

    def _dispatch_loop_step(self) -> None:
        """One blocking schedule-and-dispatch iteration."""
        with self._res_cv:
            rec = self._next_schedulable_locked()
            while rec is None and not self._shutdown:
                self._res_cv.wait(0.5)
                self._reap_idle_workers()
                rec = self._next_schedulable_locked()
            if self._shutdown:
                return
        self._dispatch_picked(rec)

    class _InlineNeedsSpawn(Exception):
        """Raised by a spawn_ok=False dispatch when no pooled worker
        exists: the recv thread must hand the task to the dispatcher
        thread instead of forking a worker itself."""

    def _try_dispatch_inline(self, limit: int = 4) -> None:
        """Opportunistic dispatch on the CALLING thread (result-recv
        or submit): every completed task used to hand off to the
        dispatcher thread through a condvar — one GIL round-trip per
        task on the hot path. Dispatching inline where the slot was
        just freed (or the task just enqueued) removes the handoff;
        the dispatcher thread remains as the blocking fallback.
        Bounded so a recv thread never turns into the dispatcher for
        an entire deep queue."""
        for _ in range(limit):
            with self._res_cv:
                rec = self._next_schedulable_locked()
            if rec is None:
                return
            if rec.state != "FAILED" and not self._has_idle_worker(
                    rec.env_key, rec.node_id):
                self._inline_hand_back(rec)
                return
            try:
                self._dispatch_picked(rec, spawn_ok=False)
            except self._InlineNeedsSpawn:
                # Race: the idle worker we saw was taken before our
                # _take_worker ran. Spawning here — on a result-recv
                # thread, under _pool_lock — is exactly what this
                # path must never do; hand back instead.
                self._inline_hand_back(rec)
                return

    def _inline_hand_back(self, rec: TaskRecord) -> None:
        """Undo an inline pick: re-enqueue at the FRONT, release the
        acquired resources, and wake the dispatcher thread (which may
        spawn a worker — a synchronous process boot that must not run
        on a result-recv thread)."""
        hold, rec.card_hold = rec.card_hold, None
        with self._res_cv:
            self._pending_readd_front_locked(rec)
            self._res_cv.notify_all()
        self._release(rec.need or {},
                      rec.options.placement_group,
                      node_id=rec.node_id,
                      bundle=rec.pg_bundle, hold=hold)

    def _has_idle_worker(self, env_key: str, node_id: str) -> bool:
        node_id = node_id or self.head_node_id
        node = self._nodes.get(node_id)
        if node is not None and node.is_daemon:
            # Daemon-hosted workers spawn on the daemon, not here —
            # dispatch is just a channel send either way.
            return True
        with self._pool_lock:
            return any(not w.dead for w in
                       self._idle.get((node_id, env_key), ()))

    def _dispatch_picked(self, rec: TaskRecord,
                         spawn_ok: bool = True) -> None:
        """Dispatch a task _next_schedulable_locked returned (node and
        resources already acquired), with the full failure handling."""
        if rec.state == "FAILED":
            # dependency/placement error — already propagated
            self._prune_task(rec)
            return
        if rec.state == "CANCELLED":
            # cancel(force=True) marked it after it left the queue
            # (_dispatch checks again under the lock): no worker.
            self._release_picked(rec)
            self._prune_task(rec)
            return
        from ray_tpu_torch.util.tracing import get_tracer
        t0 = time.time() if get_tracer().enabled else 0.0
        try:
            self._dispatch(rec, spawn_ok=spawn_ok)
            if t0:
                self._record_head_span(
                    "head.dispatch", rec, t0, time.time(),
                    {"task": rec.name, "node": rec.node_id})
        except self._InlineNeedsSpawn:
            raise
        except Exception:  # noqa: BLE001
            self._release_picked(rec)
            if rec.state == "CANCELLED":
                # cancel(force=True) stored the error and stopped the
                # worker before it connected (or before it was taken):
                # never retried, and no attempt refunded.
                self._prune_task(rec)
                return
            if getattr(rec.worker, "drain_preempted", False):
                # A node drain killed the worker before it connected:
                # the attempt is refunded, as a running task's is
                # (_handle_worker_victim).
                rec.attempts = max(0, rec.attempts - 1)
                self.drain_tasks_preempted += 1
            max_retries = (rec.options.max_retries
                           if rec.options.max_retries >= 0
                           else self.config.task_max_retries)
            # Dispatch failure (e.g. the worker died before its
            # handshake) is retryable, same as a mid-task death.
            if rec.attempts <= max_retries and self._retry(rec):
                return
            if rec.state == "CANCELLED":
                self._prune_task(rec)
                return
            if rec.oom_killed:
                # The memory monitor terminated the worker while it
                # was still booting (the task was already RUNNING from
                # the scheduler's view) — surface OOM, not a generic
                # dispatch failure.
                from ray_tpu_torch.core.exceptions import OutOfMemoryError
                err: Exception = OutOfMemoryError(
                    f"task {rec.name} was killed by the memory "
                    f"monitor after {rec.attempts} attempts")
            else:
                err = TaskError(rec.name, traceback.format_exc())
            blob = ser.dumps(err)
            for oid in rec.return_ids:
                self._store_error(oid, blob)
            self._finish_stream(rec.task_id, blob)
            rec.state = "FAILED"
            self._event(rec, "FAILED")
            self._prune_task(rec)

    def _release_picked(self, rec: TaskRecord) -> None:
        """Give back what placement acquired for ``rec`` (its resources
        and card hold) when no worker runs it."""
        hold, rec.card_hold = rec.card_hold, None
        self._release(self._effective_resources(rec.options),
                      rec.options.placement_group,
                      node_id=rec.node_id, bundle=rec.pg_bundle,
                      hold=hold)

    def _start_on(self, rec: TaskRecord, w) -> None:
        """Mark ``rec`` RUNNING on ``w``. ``cancel(force=True)`` marks a
        task it finds taken from the queue CANCELLED under the same lock;
        such a task starts on no worker: TaskCancelledError, for the
        caller's failure path."""
        with self._task_lock:
            if rec.state == "CANCELLED":
                raise TaskCancelledError(rec.name)
            rec.worker = w
            rec.worker_index = w.index
            rec.state = "RUNNING"

    def _retry(self, rec: TaskRecord) -> bool:
        """Queue a task whose attempt failed again, unless
        ``cancel(force=True)`` marked it CANCELLED (checked under the lock
        cancel marks it with). Returns whether it was queued."""
        with self._task_lock:
            if rec.state == "CANCELLED":
                return False
            rec.state = "PENDING"
            rec.worker = None
            # A fresh attempt gets a clean slate: a later unrelated
            # crash must not be misreported as OOM.
            rec.oom_killed = False
        with self._res_cv:
            self._pending_add_locked(rec)
            self._res_cv.notify_all()
        return True

    def _effective_resources(self, options: TaskOptions) -> dict[str, float]:
        return options.resources or {"CPU": 1.0}

    def _deps_state(self, rec: TaskRecord) -> str:
        """'ready' | 'waiting' | 'error' for the task's arg objects
        (reference: DependencyManager gating before dispatch,
        dependency_manager.cc)."""
        for r in rec.arg_refs:
            loc = self._obj_locations.get(r.id)
            if loc is None:
                return "waiting"
            if loc == "err":
                return "error"
        return "ready"

    @staticmethod
    def _sched_class(need: dict[str, float], options) -> tuple:
        """Scheduling-class key: everything _try_place_locked's
        outcome depends on. Within one scheduling pass the cluster's
        free resources don't change, so once one task of a class
        fails to place, every later task of the same class will too —
        skipping them turns the scan from O(pending) placement
        attempts into O(distinct classes) (reference: tasks are
        queued per SchedulingClass, scheduling_class_util.h)."""
        pg = options.placement_group
        return (tuple(sorted(need.items())),
                options.scheduling_strategy or "DEFAULT",
                pg.id if pg is not None else None,
                options.placement_group_bundle_index,
                options.node_id, options.soft)

    def pending_count(self) -> int:
        """Head pending-queue depth — admission's load signal and the
        introspection gauge. Plain int read, safe without _res_cv."""
        return self._pending_count

    def _pending_add_locked(self, rec: TaskRecord) -> None:
        """Enqueue under _res_cv, keeping the count, the per-class
        counts, and the deps flag coherent. Class + need are computed
        once here; the global seq is assigned on FIRST enqueue only
        (retries keep their original submission order)."""
        if rec.sched_class is None:
            # Options instances are shared across calls of one remote
            # handle — cache the derived class there so repeat submits
            # skip the dict sort entirely.
            cache = getattr(rec.options, "_sched_cache", None)
            if cache is None:
                need = self._effective_resources(rec.options)
                cache = (need, self._sched_class(need, rec.options))
                rec.options._sched_cache = cache
            rec.need, rec.sched_class = cache
        if rec.seq == 0:
            rec.seq = next(self._pending_seq)
        if rec.arg_refs:
            self._pending_deps.append(rec)
            self._pending_has_deps = True
        else:
            q = self._ready_classes.get(rec.sched_class)
            if q is None:
                q = self._ready_classes[rec.sched_class] = deque()
            q.append(rec)
        self._pending_enqueued_locked(rec)

    def _pending_readd_front_locked(self, rec: TaskRecord) -> None:
        """Put a just-picked record back at the FRONT of its queue
        (inline hand-back, pipeline undo): seq is preserved, so the
        lowest-seq pick returns it before anything enqueued since."""
        if rec.arg_refs:
            self._pending_deps.appendleft(rec)
            self._pending_has_deps = True
        else:
            q = self._ready_classes.get(rec.sched_class)
            if q is None:
                q = self._ready_classes[rec.sched_class] = deque()
            q.appendleft(rec)
        self._pending_enqueued_locked(rec)

    def _pending_enqueued_locked(self, rec: TaskRecord) -> None:
        self._pending_count += 1
        self._pending_classes[rec.sched_class] = (
            self._pending_classes.get(rec.sched_class, 0) + 1)
        self.admission.note_enqueued(rec.client_key)
        if self.config.debug_pending_invariants:
            self._check_pending_invariants_locked()

    def _pending_removed_locked(self, rec: TaskRecord) -> None:
        """Bookkeeping for a record the caller already removed from
        its queue (both removal sites below and the class-queue pops
        in the scheduler/pipeliner)."""
        self._pending_count -= 1
        c = self._pending_classes.get(rec.sched_class, 0) - 1
        if c <= 0:
            self._pending_classes.pop(rec.sched_class, None)
        else:
            self._pending_classes[rec.sched_class] = c
        self.admission.note_dequeued(rec.client_key)
        if self.config.debug_pending_invariants:
            self._check_pending_invariants_locked()

    def _ready_pop_locked(self, klass: tuple,
                          q: "deque[TaskRecord]") -> TaskRecord:
        rec = q.popleft()
        if not q:
            # Empty class deques must not linger: the scheduler scan
            # is O(len(_ready_classes)).
            del self._ready_classes[klass]
        self._pending_removed_locked(rec)
        return rec

    def _check_pending_invariants_locked(self) -> None:
        """Debug audit (config.debug_pending_invariants): the three
        views of the pending set — total counter, per-class counts,
        and the actual queue contents — must agree after every
        mutation. Guards the hand-back/re-enqueue paths against
        bookkeeping drift under concurrent floods."""
        actual = len(self._pending_deps) + sum(
            len(q) for q in self._ready_classes.values())
        by_class = sum(self._pending_classes.values())
        if not (actual == by_class == self._pending_count):
            raise AssertionError(
                f"pending bookkeeping drift: queues hold {actual}, "
                f"class counts sum to {by_class}, counter says "
                f"{self._pending_count}")
        if any(not q for q in self._ready_classes.values()):
            raise AssertionError(
                "empty class deque left in _ready_classes")

    def _record_head_span(self, name: str, rec: TaskRecord,
                          start: float, end: float,
                          attrs: dict | None = None) -> None:
        """Record a head-side span under a traced task's trace. Spans
        are synthesized post-hoc from (start, end) — the head never
        holds an open span across scheduler lock boundaries, and an
        untraced task (trace_ctx=None) costs nothing here."""
        from ray_tpu_torch.util.tracing import get_tracer
        ctx = getattr(rec.options, "trace_ctx", None)
        tr = get_tracer()
        if not tr.enabled or not ctx:
            return
        import uuid
        tr.add_spans([{
            "name": name, "trace_id": ctx[0],
            "span_id": uuid.uuid4().hex[:16], "parent_id": ctx[1],
            "start": start, "end": end,
            "attributes": dict(attrs or {}), "process": "head",
        }])

    def _next_schedulable_locked(self) -> TaskRecord | None:
        """Scan wrapper that times the resource scan for the causal
        trace plane: a traced task that sat behind a long placement
        scan shows a ``head.resource_scan`` span explaining the gap
        between driver submit and worker execution."""
        from ray_tpu_torch.util.tracing import get_tracer
        if not get_tracer().enabled:
            return self._next_schedulable_scan_locked()
        t0 = time.time()
        rec = self._next_schedulable_scan_locked()
        if rec is not None and rec.state != "FAILED":
            self._record_head_span(
                "head.resource_scan", rec, t0, time.time(),
                {"task": rec.name, "node": rec.node_id})
        return rec

    def _next_schedulable_scan_locked(self) -> TaskRecord | None:
        unplaceable: set[tuple] = set()
        # Phase 1 — dep-carrying tasks: legacy linear walk (usually a
        # small minority of the queue). Dependency state can flip per
        # result store, and dep ERRORS must propagate to every
        # affected task, so these can't ride the class index.
        dq = self._pending_deps
        i = 0
        while i < len(dq):
            rec = dq[i]
            deps = self._deps_state(rec)
            if deps == "error":
                # Propagate the dependency's error to this task's
                # returns (reference: error propagation through
                # lineage).
                del dq[i]
                self._pending_removed_locked(rec)
                for r in rec.arg_refs:
                    blob = self._errors.get(r.id)
                    if blob is not None:
                        for oid in rec.return_ids:
                            self._store_error(oid, blob)
                        break
                rec.state = "FAILED"
                return rec
            if deps == "ready" and rec.sched_class not in unplaceable:
                try:
                    placed = self._try_place_locked(rec.need,
                                                    rec.options, rec)
                except PlacementError as e:
                    # Infeasible forever: fail the task now instead
                    # of leaving it pending (and keep the dispatcher
                    # alive).
                    del dq[i]
                    self._pending_removed_locked(rec)
                    blob = ser.dumps(TaskError(rec.name, str(e), e))
                    for oid in rec.return_ids:
                        self._store_error(oid, blob)
                    rec.state = "FAILED"
                    return rec
                if placed is not None:
                    rec.node_id, rec.pg_bundle = placed
                    del dq[i]
                    self._pending_removed_locked(rec)
                    return rec
                unplaceable.add(rec.sched_class)
            i += 1
        if not dq:
            # Full fruitless dep walk (under _res_cv): result stores
            # stop waking the dispatcher until a dep-carrying task is
            # enqueued again.
            self._pending_has_deps = False
        # Phase 2 — dep-free tasks, indexed by scheduling class: one
        # placement probe per DISTINCT class (within one pass the
        # cluster's free resources don't change, so a class that
        # failed once fails for every queued task of that class).
        # Among placeable classes the lowest-seq head is picked, so
        # dispatch stays globally FIFO. O(classes²) worst case on the
        # min-scan, with classes = handful — not O(pending).
        while True:
            best_k = best_q = best = None
            for klass, q in self._ready_classes.items():
                if klass in unplaceable or not q:
                    continue
                head = q[0]
                if best is None or head.seq < best.seq:
                    best, best_k, best_q = head, klass, q
            if best is None:
                return None
            try:
                placed = self._try_place_locked(best.need,
                                                best.options, best)
            except PlacementError as e:
                self._ready_pop_locked(best_k, best_q)
                blob = ser.dumps(TaskError(best.name, str(e), e))
                for oid in best.return_ids:
                    self._store_error(oid, blob)
                best.state = "FAILED"
                return best
            if placed is not None:
                best.node_id, best.pg_bundle = placed
                self._ready_pop_locked(best_k, best_q)
                return best
            unplaceable.add(best_k)

    # -- node-aware placement (ClusterResourceScheduler analog,
    #    cluster_resource_scheduler.cc:146 GetBestSchedulableNode) ------

    def _fits_pool(self, pool: dict[str, float],
                   need: dict[str, float]) -> bool:
        return all(pool.get(k, 0.0) + 1e-9 >= v for k, v in need.items())

    def _alive_nodes(self) -> list[NodeRecord]:
        return [n for n in self._nodes.values() if n.alive]

    def _schedulable_nodes(self) -> list[NodeRecord]:
        """Alive nodes that accept NEW work: a draining node keeps
        serving its objects and finishing its grace-window tasks but
        is excluded from every placement decision (reference: a
        draining raylet rejects new leases)."""
        return [n for n in self._nodes.values()
                if n.alive and not n.draining]

    def _try_place_locked(self, need: dict[str, float],
                          options: TaskOptions, holder=None,
                          ) -> tuple[str, int] | None:
        """Pick (node, pg_bundle) for the request and ACQUIRE the
        resources, or return None if nothing fits right now. For a
        ``holder`` (the TaskRecord or ActorRecord being placed) that
        asks for GPU, also take its cards (``holder.card_hold``).

        Policies (reference: scheduling/policy/*.cc):
        - placement group: draw from the assigned bundle on its node
        - NODE_AFFINITY: the named node (soft -> fall back to DEFAULT)
        - SPREAD: round-robin over fitting nodes (spread_scheduling)
        - DEFAULT: hybrid pack-then-spread — prefer the head node until
          its utilization crosses the threshold, then best-fit spill
          (hybrid_scheduling_policy.cc)
        """
        pg = options.placement_group
        if pg is not None:
            pg_rec = self._pgs.get(pg.id)
            if pg_rec is None or not pg_rec.created:
                return None
            if (options.placement_group_bundle_index
                    >= len(pg_rec.bundles)):
                raise PlacementError(
                    f"placement_group_bundle_index="
                    f"{options.placement_group_bundle_index} out of "
                    f"range for a {len(pg_rec.bundles)}-bundle group")
            idxs = ([options.placement_group_bundle_index]
                    if options.placement_group_bundle_index >= 0
                    else range(len(pg_rec.bundle_avail)))
            for bi in idxs:
                node = self._nodes.get(pg_rec.bundle_nodes[bi])
                if node is None or not node.alive or node.draining:
                    # A draining node's bundles stop taking new work;
                    # they re-home through the node-death path once
                    # the drain completes.
                    continue
                if (self._fits_pool(pg_rec.bundle_avail[bi], need)
                        and self._pick_cards(node, need, holder)
                        is not None):
                    for k, v in need.items():
                        pg_rec.bundle_avail[bi][k] = (
                            pg_rec.bundle_avail[bi].get(k, 0.0) - v)
                    self._take_cards(node, need, holder)
                    return pg_rec.bundle_nodes[bi], bi
            return None

        strategy = options.scheduling_strategy or "DEFAULT"
        if strategy == "NODE_AFFINITY" and options.node_id:
            node = self._nodes.get(options.node_id)
            if (node is not None and node.alive and not node.draining
                    and self._fits_pool(node.avail, need)
                    and self._pick_cards(node, need, holder) is not None):
                self._take_from_node(node, need)
                self._take_cards(node, need, holder)
                return node.node_id, -1
            if not options.soft:
                if node is None or not node.alive:
                    # Fail fast: a hard affinity to a missing/dead node
                    # can never be satisfied (reference behavior:
                    # NodeAffinity infeasible -> task error).
                    raise PlacementError(
                        f"node {options.node_id!r} is "
                        f"{'dead' if node is not None else 'unknown'} "
                        f"and scheduling is not soft")
                if node.draining:
                    # The node is on its way out — a hard pin to it
                    # can never be satisfied again.
                    raise PlacementError(
                        f"node {options.node_id!r} is draining "
                        f"({node.drain_reason or 'no reason'}) and "
                        f"scheduling is not soft")
                return None
            # soft: fall through to DEFAULT below

        candidates = [n for n in self._schedulable_nodes()
                      if self._fits_pool(n.avail, need)
                      and self._fits_pool(n.resources, need)
                      and self._pick_cards(n, need, holder) is not None]
        if not candidates:
            return None
        if strategy == "SPREAD":
            pick = candidates[next(self._rr_counter) % len(candidates)]
        else:
            # hybrid: pack onto head (or first nodes) while utilization
            # is below threshold, else pick the least-loaded candidate.
            thr = self.config.scheduler_spread_threshold
            pick = None
            for n in candidates:
                cpu_total = n.resources.get("CPU", 0.0) or 1.0
                util = 1.0 - n.avail.get("CPU", 0.0) / cpu_total
                if util < thr:
                    pick = n
                    break
            if pick is None:
                pick = max(candidates,
                           key=lambda n: n.avail.get("CPU", 0.0))
        self._take_from_node(pick, need)
        self._take_cards(pick, need, holder)
        return pick.node_id, -1

    def _take_from_node(self, node: NodeRecord,
                        need: dict[str, float]) -> None:
        for k, v in need.items():
            node.avail[k] = node.avail.get(k, 0.0) - v

    # -- cards: which of a node's GPUs a holder gets (reference: the
    #    raylet's GPU instance ids behind ray.get_gpu_ids()) ----------

    @staticmethod
    def _pick_cards(node: NodeRecord, need: dict[str, float],
                    holder) -> tuple[str, ...] | None:
        """The cards a GPU request would take on ``node``: whole free
        cards, lowest ids first, for ``num_gpus >= 1``; for a fraction,
        the fullest card that still has room (best fit). ``()`` when
        the request holds no cards, None when they do not fit now."""
        g = need.get("GPU", 0.0)
        if holder is None or g <= 0:
            return ()
        if g < 1.0:
            fits = [(free, i) for i, free in node.cards.items()
                    if free + 1e-9 >= g]
            return (min(fits)[1],) if fits else None
        free = [i for i, f in node.cards.items() if f >= 1.0 - 1e-9]
        n = math.ceil(g)
        return tuple(free[:n]) if len(free) >= n else None

    def _take_cards(self, node: NodeRecord, need: dict[str, float],
                    holder) -> None:
        ids = self._pick_cards(node, need, holder)
        if not ids:
            return
        share = min(need["GPU"], 1.0)
        for i in ids:
            node.cards[i] -= share
        holder.card_hold = CardHold(node.node_id, ids, share)

    def _release_cards(self, hold: CardHold | None) -> None:
        """Give a hold's cards back (once; under _res_cv)."""
        if hold is None or hold.released:
            return
        hold.released = True
        node = self._nodes.get(hold.node_id)
        if node is not None:
            for i in hold.ids:
                node.cards[i] = min(1.0, node.cards[i] + hold.share)

    @staticmethod
    def _card_env(env_key: str, env_vars: dict,
                  hold: CardHold | None) -> tuple[str, dict]:
        """The worker environment of a holder: it sees its cards and
        no other. Workers are pooled by this key, so a pooled worker
        only serves holders of the same cards."""
        if hold is None:
            return env_key, env_vars
        ids = ",".join(hold.ids)
        return f"{env_key}/gpu{ids}", {
            **env_vars, "CUDA_VISIBLE_DEVICES": ids, GPU_IDS_ENV: ids}

    def acquire_on_some_node(self, need: dict[str, float],
                             options: TaskOptions,
                             timeout: float | None = None,
                             holder=None,
                             ) -> tuple[str, int] | None:
        """Blocking placement for actors/PGs; returns (node_id, bundle)
        or None on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._res_cv:
            while True:
                placed = self._try_place_locked(need, options, holder)
                if placed is not None:
                    return placed
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return None
                self._res_cv.wait(remaining)

    def _release(self, resources: dict[str, float], pg=None,
                 node_id: str = "", bundle: int = -1,
                 hold: CardHold | None = None) -> None:
        with self._res_cv:
            self._release_cards(hold)
            if pg is not None and bundle >= 0:
                pg_rec = self._pgs.get(pg.id)
                if (pg_rec is not None and pg_rec.created
                        and bundle < len(pg_rec.bundle_nodes)
                        and pg_rec.bundle_nodes[bundle] == (
                            node_id or self.head_node_id)):
                    pool = pg_rec.bundle_avail[bundle]
                    for k, v in resources.items():
                        pool[k] = pool.get(k, 0.0) + v
                    self._res_cv.notify_all()
                    return
                # PG removed, or the bundle was re-homed after its node
                # died (remove_node resets the new bundle to full
                # capacity — crediting this release too would
                # over-subscribe it): fall through to the node pool,
                # which drops the release if that node is dead.
            node = self._nodes.get(node_id or self.head_node_id)
            if node is not None and node.alive:
                for k, v in resources.items():
                    node.avail[k] = node.avail.get(k, 0.0) + v
            self._res_cv.notify_all()

    # -- node management (GCS node manager analog) ----------------------

    def _add_node_locked_free(self, resources: dict[str, float],
                              labels: dict[str, str] | None = None,
                              is_head: bool = False,
                              node_id: str = "",
                              gpu_ids=None,
                              hostname: str = "") -> str:
        """Create (or, given a prior id from a re-registering daemon,
        revive) a node-table entry. ``gpu_ids`` are the node's cards
        (a daemon's report, or a logical node's explicit ids); without
        them the node takes cards of this host (``_host_cards``).
        Raises ValueError where a live node of the same host, not
        draining, holds one of them: one card never goes to two
        nodes."""
        node_id = node_id or \
            f"node_{next(self._node_seq):04d}_{os.urandom(4).hex()}"
        count = math.ceil(resources.get("GPU", 0.0))
        hostname = hostname or self.hostname
        if gpu_ids is not None:
            cards = [str(i) for i in gpu_ids][:count]
            if len(cards) < count:
                raise ValueError(
                    f"a node with GPU={resources.get('GPU')} needs "
                    f"{count} card ids, got {list(gpu_ids)}")
        else:
            cards = self._host_cards(count, hostname)
        # (A draining node's cards are on their way out: its
        # replacement may take them. A re-registering node's own
        # record holds its cards: it is not another node.)
        shared = sorted(set(cards) & self._cards_on_host(
            hostname, draining=False, but=node_id))
        if shared:
            raise ValueError(
                f"node {node_id} on {hostname} asks for cards {shared}, "
                f"which another node of that host holds")
        from ray_tpu_torch.core.ids import owner_tag_of
        self._owner_tags[owner_tag_of(node_id)] = node_id
        self._nodes.pop(node_id, None)
        self._nodes[node_id] = NodeRecord(
            node_id=node_id, resources=dict(resources),
            avail=dict(resources), labels=dict(labels or {}),
            is_head=is_head, hostname=hostname,
            cards=dict.fromkeys(cards, 1.0))
        return node_id

    def _cards_on_host(self, hostname: str, draining: bool = True,
                       but: str = "") -> set[str]:
        """Cards the live nodes of ``hostname`` other than ``but`` hold
        (with or without the draining ones)."""
        return {i for n in self._nodes.values()
                if n.alive and n.hostname == hostname and n.node_id != but
                and (draining or not n.draining) for i in n.cards}

    def _host_cards(self, count: int, hostname: str) -> list[str]:
        """Cards for a node that names none (the head, a logical
        node): this host's ids (the head process's
        ``CUDA_VISIBLE_DEVICES``, else 0, 1, ...) that no other node of
        the host holds, lowest first. One card is never handed out by
        two nodes of the same host."""
        taken = self._cards_on_host(hostname)
        visible = visible_gpu_ids()
        if visible and len(visible) >= count:
            free = [i for i in visible if i not in taken]
            if len(free) < count:
                raise ValueError(
                    f"a node with {count} GPU finds no free card on "
                    f"{hostname}: {visible} are held ({sorted(taken)}); "
                    f"name its gpu_ids")
            return free[:count]
        # No cards named (or fewer than asked, as node_gpu_ids reads
        # it): ids count up from 0.
        free, k = [], 0
        while len(free) < count:
            if str(k) not in taken:
                free.append(str(k))
            k += 1
        return free

    def _daemon_cards(self, resources: dict[str, float],
                      reported) -> list[str]:
        """A node daemon's cards: the ids it reported at registration
        (its own ``CUDA_VISIBLE_DEVICES``), never this process's."""
        count = math.ceil(resources.get("GPU", 0.0))
        return [str(i) for i in (reported or [])][:count]

    def add_node(self, resources: dict[str, float],
                 labels: dict[str, str] | None = None,
                 gpu_ids=None) -> str:
        """A logical node: a row of resources inside this process,
        whose workers the head spawns. ``gpu_ids`` names its cards;
        without them it takes cards of this host no other node holds."""
        with self._res_cv:
            node_id = self._add_node_locked_free(resources, labels,
                                                 gpu_ids=gpu_ids)
            self._rehome_bundles_locked()
            self._res_cv.notify_all()
        return node_id

    def remove_node(self, node_id: str) -> None:
        """Node removal / simulated failure: tell a daemon-backed node
        to exit, then run the death path (mark dead, kill workers,
        lose its objects — GcsNodeManager::OnNodeFailure analog,
        gcs_node_manager.cc:408)."""
        node = self._nodes.get(node_id)
        if node is not None and node.is_daemon and node.alive:
            try:
                node.node_send((P.ND_SHUTDOWN,))
            except (OSError, BrokenPipeError):
                pass
        self._handle_node_death(node_id)

    # -- graceful drain (DrainNode protocol analog) ---------------------

    def drain_node(self, node_id: str, reason: str = "",
                   deadline_s: float | None = None,
                   remove: bool = False) -> bool:
        """Gracefully drain a node ahead of an anticipated failure
        (spot preemption notice, autoscaler scale-down, maintenance):

        1. mark the node ``draining`` — it leaves every scheduling
           decision immediately (visible in ``nodes()`` and
           ``util.state.list_nodes``);
        2. give in-flight tasks a grace window, then preempt the
           stragglers — they retry elsewhere through the existing
           retry path with the interrupted attempt refunded;
        3. migrate restartable actors to surviving nodes without
           consuming restart budget; non-restartable actors die with
           an ActorDiedError naming the drain;
        4. evacuate primary object copies homed on the node (promote
           a live replica, else pull to the head) so NO lineage
           reconstruction fires when the node goes away.

        Blocks until the drain completes or the deadline lapses.
        ``remove=True`` terminates the node afterwards (the
        preemption-notice path). Returns False for unknown/dead/head
        nodes."""
        cfg = self.config
        if deadline_s is None:
            deadline_s = cfg.drain_deadline_s
        deadline = time.monotonic() + max(0.0, deadline_s)
        with self._res_cv:
            node = self._nodes.get(node_id)
            if node is None or not node.alive or node.is_head:
                return False
            if not node.draining:
                node.draining = True
                node.drain_reason = reason
                node.drain_deadline = deadline
                self.drains_started += 1
            self._res_cv.notify_all()
        # A draining node's series go stale immediately: its workers
        # are on their way out, and a scrape must not keep reporting
        # them as live capacity.
        self.observability.mark_node_stale(node_id)
        # Tasks first (they may still store results on the node),
        # then actors, then the object evacuation sweeps everything
        # that remains.
        grace = min(cfg.drain_grace_period_s, deadline_s)
        grace_end = time.monotonic() + grace
        self._drain_tasks(node_id, grace_end)
        self._drain_actors(node_id, reason, deadline, grace_end)
        self._drain_objects(node_id, deadline)
        self.drains_completed += 1
        if remove:
            self.remove_node(node_id)
        return True

    def _drain_tasks(self, node_id: str, grace_deadline: float) -> None:
        """Wait out the grace window for tasks running on the node,
        then preempt the rest: their workers are killed with the
        drain flag set, so the worker-exit path requeues them with
        the attempt refunded."""
        while time.monotonic() < grace_deadline:
            with self._task_lock:
                busy = any(rec.node_id == node_id
                           and rec.state == "RUNNING"
                           for rec in self._tasks.values())
            if not busy:
                return
            time.sleep(0.05)
        with self._task_lock:
            victims = {rec.worker for rec in self._tasks.values()
                       if rec.node_id == node_id
                       and rec.state == "RUNNING"
                       and rec.worker is not None
                       and not rec.worker.is_actor}
        for w in victims:
            w.drain_preempted = True
            try:
                w.proc.kill()
            except Exception:  # noqa: BLE001
                pass

    def _drain_actors(self, node_id: str, reason: str,
                      deadline: float, grace_end: float) -> None:
        with self._actor_lock:
            recs = [r for r in self._actors.values()
                    if r.node_id == node_id and r.state == "ALIVE"]
        threads = []
        for rec in recs:
            t = threading.Thread(
                target=self._migrate_actor,
                args=(rec, reason, deadline, grace_end),
                daemon=True,
                name=f"drain_actor_{rec.actor_id.hex()[:8]}")
            t.start()
            threads.append(t)
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()) + 2.0)

    def _migrate_actor(self, rec: ActorRecord, reason: str,
                       deadline: float, grace_end: float) -> None:
        """Move one actor off a draining node. Restartable actors are
        restarted on a surviving node WITHOUT consuming restart
        budget (the failure was anticipated); non-restartable actors
        die with the drain named as the reason. In-flight calls get
        the remainder of the drain deadline to finish first, so a
        well-timed drain is invisible to callers."""
        w = rec.worker
        restartable = rec.restart_count < rec.max_restarts
        # Revoke the direct-call lease first: callers mid-stream fall
        # back to head routing, whose pusher parks through the
        # migration — zero-loss includes the bypass path.
        self._direct_invalidate(rec.actor_id)
        if not restartable:
            # Hold the kill until the grace window lapses AND the
            # actor's in-flight calls drained: higher-level
            # controllers reacting to the DRAINING state (the serve
            # controller drain-replaces replicas, routers refresh
            # their sets) get a bounded window to redirect traffic
            # before the actor disappears.
            while (time.monotonic() < grace_end
                   or rec.in_flight) and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            rec.drain_reason = reason or "node drained"
            if w is not None:
                try:
                    w.proc.terminate()
                except Exception:  # noqa: BLE001
                    pass
            return
        # Stop the pusher from shipping new calls to the doomed
        # incarnation: clear the ready gate and detach the worker
        # (the pusher parks until the replacement is up; the old
        # worker's eventual reader-thread death handler sees a stale
        # worker and no-ops — same contract as _start_actor's
        # cleanup path). THEN wait out in-flight calls: the old
        # incarnation stays alive to finish them, and results flow
        # back through its still-open exec channel.
        rec.state = "RESTARTING"
        rec.ready_event.clear()
        rec.worker = None
        while rec.in_flight and time.monotonic() < deadline:
            time.sleep(0.02)
        leftovers = dict(rec.in_flight)
        rec.in_flight.clear()
        if leftovers:
            # Calls that outran the whole drain deadline cannot be
            # transparently replayed (they may have side effects):
            # surface the drain as the cause.
            blob = ser.dumps(ActorDiedError(
                rec.actor_id.hex(),
                f"node {rec.node_id} drained: {reason or 'drain'} "
                f"(call did not finish within the drain deadline)"))
            for task_id, (return_ids, _m) in leftovers.items():
                for oid in return_ids:
                    self._store_error(oid, blob)
                self._finish_stream(task_id, blob)
        if w is not None:
            with self._pool_lock:
                if w in self._workers:
                    self._workers.remove(w)
            try:
                w.proc.terminate()
            except Exception:  # noqa: BLE001
                pass
        hold, rec.card_hold = rec.card_hold, None
        self._release(self._effective_resources(rec.options),
                      rec.options.placement_group,
                      node_id=rec.node_id, bundle=rec.pg_bundle,
                      hold=hold)
        self.drain_actors_migrated += 1
        # No restart_count += 1: migration is free — budget is
        # reserved for real crashes.
        self._start_actor(rec)

    def _drain_objects(self, node_id: str, deadline: float) -> None:
        """Re-home every primary object copy living on the draining
        node: promote a live replica where one exists, else pull the
        bytes to the head — so the node's eventual death loses
        nothing and no lineage reconstruction fires."""
        oids = list(self._node_objects.get(node_id, set()))
        for oid in oids:
            promoted = None
            with self._obj_cv:
                if self._obj_locations.get(oid) != ("node", node_id):
                    continue      # replica only / already moved
                for nid in self._obj_replicas.get(oid, set()):
                    n = self._nodes.get(nid)
                    if n is not None and n.alive and not n.draining:
                        promoted = nid
                        break
                if promoted is not None:
                    self._obj_replicas[oid].discard(promoted)
                    if not self._obj_replicas[oid]:
                        self._obj_replicas.pop(oid, None)
                    # The draining node's copy survives until the
                    # node actually dies — keep it as a replica so a
                    # delete still frees it.
                    self._obj_replicas.setdefault(oid, set()).add(
                        node_id)
                    self._obj_locations[oid] = ("node", promoted)
                    self._node_objects.setdefault(
                        promoted, set()).add(oid)
                    self._obj_cv.notify_all()
            if promoted is not None:
                self._node_objects.get(node_id, set()).discard(oid)
                self.drain_objects_evacuated += 1
                continue
            try:
                obj = self._fetch_from_node(node_id, oid, deadline)
            except Exception:  # noqa: BLE001
                # Unreachable mid-drain (node died under us): the
                # death path's lineage recovery remains the backstop.
                continue
            with self._obj_cv:
                if self._obj_locations.get(oid) != ("node", node_id):
                    continue      # deleted/moved while we pulled
            self._store_value(oid, obj)
            self._node_objects.get(node_id, set()).discard(oid)
            self.drain_objects_evacuated += 1

    def _handle_node_death(self, node_id: str) -> None:
        with self._res_cv:
            node = self._nodes.get(node_id)
            if node is None or not node.alive:
                return
            node.alive = False
            node.avail = {}
            self._res_cv.notify_all()
        # Its metric series must stop at the last observed value
        # instead of freezing in the scrape forever.
        self.observability.mark_node_stale(node_id)
        self._broadcast_node_map()
        # Local worker processes pinned to the (logical) node die by
        # signal; daemon-hosted workers are marked dead here and fail
        # over through the same _on_worker_exit path their reader
        # thread would have taken.
        with self._pool_lock:
            victims = [w for w in self._workers if w.node_id == node_id]
        remote_victims = [w for w in list(self._remote_workers.values())
                          if w.node_id == node_id]
        for w in victims:
            if isinstance(w, RemoteWorkerHandle):
                continue
            try:
                w.proc.kill()
            except Exception:  # noqa: BLE001
                pass
        for w in remote_victims:
            self._remote_workers.pop(w.index, None)
            if not w.dead:
                w.dead = True
                w.proc.returncode = -9
                try:
                    self._on_worker_exit(w)
                except Exception:  # noqa: BLE001
                    traceback.print_exc()
        # Objects homed in the dead node's store are lost (reference:
        # raylets evict a dead node's objects; recovery is lineage
        # reconstruction's job).
        lost = self._node_objects.pop(node_id, set())
        with self._obj_cv:
            for reps in self._obj_replicas.values():
                reps.discard(node_id)
        for oid in lost:
            with self._obj_cv:
                if self._obj_locations.get(oid) != ("node", node_id):
                    continue
                # A live p2p replica makes reconstruction unnecessary:
                # promote it to primary (reference: the object
                # directory simply points at the surviving copy).
                promoted = None
                for nid in self._obj_replicas.get(oid, set()):
                    n = self._nodes.get(nid)
                    if n is not None and n.alive:
                        promoted = nid
                        break
                if promoted is not None:
                    self._obj_replicas[oid].discard(promoted)
                    if not self._obj_replicas[oid]:
                        self._obj_replicas.pop(oid, None)
                    self._obj_locations[oid] = ("node", promoted)
                    self._node_objects.setdefault(
                        promoted, set()).add(oid)
                    self._obj_cv.notify_all()
                    continue
            self._on_object_lost(oid, node_id)
        # Re-home placement-group bundles that lived on the dead node.
        with self._res_cv:
            self._rehome_bundles_locked()
            self._res_cv.notify_all()

    def _rehome_bundles_locked(self) -> None:
        """Move each created placement group's bundles off dead nodes
        onto a live node with room. A node's death tries first; a bundle
        that found no room then waits on a dead node until a node joins
        (``add_node``, a daemon's registration), which tries again."""
        for pg_rec in self._pgs.values():
            if not pg_rec.created:
                continue
            for bi, nid in enumerate(pg_rec.bundle_nodes):
                node = self._nodes.get(nid)
                if node is not None and node.alive:
                    continue
                placed = self._try_place_locked(
                    pg_rec.bundles[bi], TaskOptions(resources={}))
                if placed is not None:
                    pg_rec.bundle_nodes[bi] = placed[0]
                    pg_rec.bundle_avail[bi] = dict(pg_rec.bundles[bi])

    def _on_object_lost(self, oid: ObjectID, node_id: str) -> None:
        """A stored object's home store is gone: rebuild it through
        lineage if we can (reference: ObjectRecoveryManager re-submits
        the creating task, object_recovery_manager.h:41), else surface
        ObjectLostError to pending/future gets."""
        with self._obj_cv:
            self._obj_locations.pop(oid, None)
        # A lost object's id may be re-stored by re-execution with
        # (legitimately) different nondeterministic content — the
        # cache must not keep serving the dead copy's value.
        self._deser_cache.invalidate(oid)
        if self._try_reconstruct(oid):
            return
        blob = ser.dumps(ObjectLostError(
            f"object {oid.hex()} was stored on node {node_id}, "
            f"which died, and could not be reconstructed"))
        self._store_error(oid, blob)

    # ---------------- head snapshot / restore (GCS HA analog) ---------

    def snapshot_state(self) -> dict:
        """Control-plane tables as a JSON-serializable dict (reference:
        GCS tables journaled to Redis, redis_store_client.cc): KV,
        named-actor specs (with identity, so a surviving node daemon's
        live incarnation can be re-adopted), PG specs."""
        import base64

        def e(b: bytes) -> str:
            return base64.b64encode(b).decode()

        kv_rows = []
        with self._kv_lock:
            for (ns, k), v in self._kv.items():
                kv_rows.append({"ns": ns, "k": e(k), "v": e(v)})
        actor_rows = []
        with self._actor_lock:
            named = dict(self._named_actors)
        for name, actor_id in named.items():
            rec = self._actors.get(actor_id)
            if rec is None or rec.state == "DEAD":
                continue
            actor_rows.append(self._actor_snapshot_row(name, rec))
        pg_rows = []
        with self._pg_lock:
            # Pending PGs included: the op log journals them at
            # creation (the client's ack is durable), so compaction
            # must not silently drop what a crash would then lose.
            for pg_id, pg in self._pgs.items():
                pg_rows.append({"id": pg_id.hex(),
                                "bundles": pg.bundles,
                                "strategy": pg.strategy})
        return {"kv": kv_rows, "named_actors": actor_rows,
                "pgs": pg_rows}

    def _actor_snapshot_row(self, name: str, rec) -> dict:
        from ray_tpu_torch.core.oplog import b64e as e

        pg = rec.options.placement_group
        return {
            "name": name,
            "actor_id": rec.actor_id.hex(),
            "cls_name": rec.cls_name,
            "cls_blob": e(rec.cls_blob),
            "init_args_blob": e(rec.init_args_blob),
            "options_blob": e(ser.dumps(rec.options)),
            "pg_id": pg.id.hex() if pg is not None else None,
            "max_restarts": rec.max_restarts,
            "max_concurrency": rec.max_concurrency,
        }

    def _journal(self, entry: dict) -> None:
        """Durably append one mutation to the head's op log before
        the caller acks it (reference: per-write GCS journaling to
        Redis, redis_store_client.cc). No-op unless a head process
        attached an OpLog."""
        log = getattr(self, "oplog", None)
        if log is not None:
            log.append(entry)

    def _journal_async(self, entry: dict):
        """Enqueue variant for call sites that must order the log
        entry under their mutation lock; returns a waiter or None."""
        log = getattr(self, "oplog", None)
        if log is None:
            return None
        return log.append_async(entry)

    def _journal_actor_remove(self, rec) -> None:
        if rec.name:
            self._journal({"op": "actor_remove", "name": rec.name})

    def save_snapshot(self, path: str, extra: dict | None = None) -> dict:
        """``snapshot_state`` written to ``path`` atomically (a temporary
        file fsynced, then renamed); returns the counts written."""
        import json
        state = self.snapshot_state()
        if extra:
            state.update(extra)
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(path)),
                    exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return {"kv": len(state["kv"]),
                "named_actors": len(state["named_actors"]),
                "pgs": len(state["pgs"])}

    def restore_snapshot(self, state: dict,
                         adopt_grace_s: float = 8.0) -> dict:
        """Replay a head snapshot into THIS runtime after a head
        restart. KV restores verbatim; PGs re-reserve; named actors
        enter RESTARTING under their OLD identity — if a reconnecting
        node daemon reports that incarnation still alive within the
        grace window it is ADOPTED (state preserved), else it restarts
        fresh (reference semantics: GCS restart + raylet resync,
        NotifyGCSRestart, node_manager.proto:383)."""
        import base64

        def d(s: str) -> bytes:
            return base64.b64decode(s)

        for row in state.get("kv", []):
            self.kv_put(d(row["k"]), d(row["v"]), row["ns"])

        from ray_tpu_torch.core.placement_group import PlacementGroup
        pg_map: dict[str, PlacementGroup] = {}
        for row in state.get("pgs", []):
            bundles = [dict(b) for b in row["bundles"]]
            new_id = self.create_placement_group(bundles,
                                                 row["strategy"],
                                                 row.get("name", ""))
            pg_map[row.get("id", "")] = PlacementGroup(
                new_id, bundles, row["strategy"])

        restored = []
        for row in state.get("named_actors", []):
            name = row["name"]
            with self._actor_lock:
                if name in self._named_actors:
                    continue
            options = ser.loads(d(row["options_blob"]))
            if row.get("pg_id") is not None:
                options.placement_group = pg_map.get(row["pg_id"])
                if options.placement_group is None:
                    options.placement_group_bundle_index = -1
                    options.scheduling_strategy = "DEFAULT"
            actor_id = (ActorID(bytes.fromhex(row["actor_id"]))
                        if row.get("actor_id") else
                        ActorID.of(self.job_id))
            rec = ActorRecord(
                actor_id=actor_id, name=name,
                cls_name=row["cls_name"], cls_blob=d(row["cls_blob"]),
                init_args_blob=d(row["init_args_blob"]),
                init_arg_refs=[], options=options,
                max_restarts=row["max_restarts"],
                max_concurrency=row["max_concurrency"],
                state="RESTARTING")
            with self._actor_lock:
                self._named_actors[name] = actor_id
                self._actors[actor_id] = rec
            restored.append(name)

            def _grace_start(rec=rec):
                time.sleep(adopt_grace_s)
                if (rec.worker is None and rec.state == "RESTARTING"
                        and not self._shutdown):
                    self._start_actor(rec)

            threading.Thread(target=_grace_start, daemon=True).start()
        return {"kv": len(state.get("kv", [])),
                "named_actors": restored, "pgs": len(pg_map)}

    def _adopt_worker(self, node: NodeRecord, widx: int,
                      is_actor: bool, actor_id_bytes: bytes | None,
                      env_key: str) -> None:
        """A reconnecting daemon reports a live worker from before the
        head restart: rebuild its head-side handle without spawning,
        and re-bind a RESTARTING actor record to its surviving
        incarnation (state preserved)."""
        # Keep future worker indexes clear of adopted ones. Two
        # daemons re-registering concurrently race on the read-then-
        # replace, so the bump runs under the pool lock (duplicate
        # indexes would cross-wire _remote_workers entries).
        with self._pool_lock:
            current = next(WorkerHandle._counter)
            WorkerHandle._counter = itertools.count(
                max(widx + 1, current))
        w = RemoteWorkerHandle.__new__(RemoteWorkerHandle)
        w.index = widx
        w.env_key = env_key or "adopted"
        w.node_id = node.node_id
        w.node = node
        w.lease_queue = deque()
        w.lease_lock = threading.Lock()
        w.busy = True
        w.is_actor = bool(is_actor)
        w.actor_id = (ActorID(actor_id_bytes)
                      if actor_id_bytes else None)
        w.dead = False
        w.last_idle = time.monotonic()
        w.sent_fn_ids = set()
        w.log_path = None
        w._runtime = self
        w.proc = _RemoteProc(w)
        w.conn = ("remote", node.node_id)
        w.card_hold = None
        self._remote_workers[widx] = w
        with self._pool_lock:
            self._workers.append(w)
        if w.is_actor and w.actor_id is not None:
            with self._actor_lock:
                rec = self._actors.get(w.actor_id)
                bind = (rec is not None and rec.worker is None
                        and rec.state in ("RESTARTING", "PENDING"))
                if bind:
                    rec.worker = w
                    rec.node_id = node.node_id
            if bind:
                # The surviving incarnation holds its resources on the
                # revived node: account them (no acquire ran).
                need = self._effective_resources(rec.options)
                with self._res_cv:
                    self._take_from_node(node, need)
                    # Its cards are those its env key names
                    # (_card_env): the incarnation keeps them.
                    _, _, ids = w.env_key.rpartition("/gpu")
                    ids = tuple(i for i in ids.split(",")
                                if i in node.cards)
                    if ids and need.get("GPU", 0) > 0:
                        share = min(need["GPU"], 1.0)
                        for i in ids:
                            node.cards[i] -= share
                        rec.card_hold = CardHold(node.node_id, ids,
                                                 share)
                w.card_hold = rec.card_hold
                rec.state = "ALIVE"
                rec.ready_event.set()
            else:
                # Unknown incarnation (not in the snapshot), or a
                # fresh restart already claimed the record (transient
                # link drop, not a head restart): exactly one
                # incarnation may live — drop this one.
                w.proc.terminate()
        else:
            # Pooled worker: make it reusable.
            w.busy = False
            with self._pool_lock:
                self._idle.setdefault(
                    (node.node_id, w.env_key), []).append(w)

    # ---------------- lineage reconstruction ----------------

    def _lineage_put(self, task_id: TaskID,
                     lin: LineageRecord) -> None:
        lin.live_returns = set(lin.return_ids)
        with self._lineage_lock:
            self._lineage[task_id] = lin
            self._lineage_bytes += lin.nbytes
            budget = self.config.lineage_cache_max_bytes
            while self._lineage_bytes > budget and self._lineage:
                _tid, old = self._lineage.popitem(last=False)
                self._lineage_bytes -= old.nbytes

    def _lineage_release_return(self, oid: ObjectID) -> None:
        """A return object was reclaimed: once every return of the
        creating task is gone, drop its lineage record so the pinned
        argument refs can be released (reference: lineage released
        when the produced objects go out of scope,
        task_manager.h:560-602)."""
        if oid.is_put_object():
            return
        with self._lineage_lock:
            lin = self._lineage.get(oid.task_id())
            if lin is None:
                return
            lin.live_returns.discard(oid)
            if lin.live_returns:
                return
            self._lineage.pop(oid.task_id(), None)
            self._lineage_bytes -= lin.nbytes

    def _try_reconstruct(self, oid: ObjectID) -> bool:
        """Re-submit the task that created ``oid`` (transitively
        recovering lost arguments). Returns True when a rebuild is in
        flight — dependents keep waiting on the object's location
        instead of seeing an error. ray.put objects embed a nil task
        id and are never reconstructable, matching the reference."""
        if oid.is_put_object():
            return False
        task_id = oid.task_id()
        with self._lineage_lock:
            lin = self._lineage.get(task_id)
            if lin is None:
                return False
            if lin.reconstructions >= self.config.max_reconstructions:
                return False
            with self._task_lock:
                if task_id in self._tasks:
                    return True      # already being re-executed
            if lin.rebuilding:
                return True          # another thread is on it
            lin.rebuilding = True
        try:
            return self._launch_reconstruction(task_id, lin)
        finally:
            with self._lineage_lock:
                lin.rebuilding = False

    def _launch_reconstruction(self, task_id: TaskID,
                               lin: LineageRecord) -> bool:
        # Clear stale state for every return that no longer has a
        # healthy copy, so gets/deps wait for the re-execution.
        unhealthy = []
        with self._obj_cv:
            for rid in lin.return_ids:
                loc = self._obj_locations.get(rid)
                healthy = loc in ("mem", "shm") or (
                    isinstance(loc, tuple)
                    and (n := self._nodes.get(loc[1])) is not None
                    and n.alive)
                if not healthy:
                    self._obj_locations.pop(rid, None)
                    self._errors.pop(rid, None)
                    unhealthy.append(rid)
        # Outside _obj_cv: dropping a cached value can cascade into
        # ref finalizers that re-enter the object plane.
        for rid in unhealthy:
            self._deser_cache.invalidate(rid)
        # Recover lost arguments first (transitive lineage walk,
        # bounded by each task's own reconstruction budget).
        for aref in lin.arg_refs:
            loc = self._obj_locations.get(aref.id)
            lost = loc is None or (
                isinstance(loc, tuple)
                and ((n := self._nodes.get(loc[1])) is None
                     or not n.alive))
            if loc == "err":
                blob = self._errors.get(aref.id)
                try:
                    lost = blob is not None and isinstance(
                        ser.loads(blob), ObjectLostError)
                except Exception:  # noqa: BLE001
                    lost = False
                if lost:
                    with self._obj_cv:
                        self._obj_locations.pop(aref.id, None)
                        self._errors.pop(aref.id, None)
            if lost and not self._try_reconstruct(aref.id):
                return False        # an argument is unrecoverable
        try:
            env_key, env_vars = self._env_for_options_cached(lin.options)
        except Exception:  # noqa: BLE001
            return False
        rec = TaskRecord(
            task_id=task_id, fn_id=lin.fn_id, name=lin.name,
            args_blob=lin.args_blob, arg_refs=list(lin.arg_refs),
            options=lin.options, return_ids=list(lin.return_ids),
            submitted_at=time.time(), env_key=env_key,
            env_vars=env_vars)
        with self._task_lock:
            if task_id in self._tasks:
                return True
            self._tasks[task_id] = rec
        # Charge the budget only for a rebuild that actually launched.
        with self._lineage_lock:
            lin.reconstructions += 1
        self.lineage_reconstructions += 1
        self._event(rec, "RECONSTRUCTING")
        with self._res_cv:
            self._pending_add_locked(rec)
            self._res_cv.notify_all()
        return True

    def _loads_options_cached(self, opts_blob: bytes) -> TaskOptions:
        """Wire submits carry a pickled TaskOptions per call; a remote
        handle sends the IDENTICAL blob every time. Deserializing it
        per task both burned CPU and defeated the per-instance
        _env_cache (every call got a fresh instance). Cache by blob
        bytes so repeat calls share one instance — and its env/sched
        caches. submit_task never mutates options."""
        cached = self._opts_blob_cache.get(opts_blob)
        if cached is None:
            cached = ser.loads(opts_blob)
            if len(self._opts_blob_cache) >= 512:
                self._opts_blob_cache.clear()
            self._opts_blob_cache[opts_blob] = cached
        return cached

    def _env_for_options_cached(self, options: TaskOptions
                                ) -> tuple[str, dict]:
        """Options instances are shared across the calls of one remote
        handle (remote_function template) — identical options resolve
        to identical env, and the sha1-over-env hashing showed up in
        submit profiles. Keyed on the runtime identity so a template
        surviving shutdown/init re-resolves."""
        cache = getattr(options, "_env_cache", None)
        if cache is None or cache[0]() is not self:
            ek, ev = self._env_for_options(options)
            # weakref: options templates outlive runtimes (module
            # globals) — a strong ref here would pin a dead runtime
            # after shutdown until the handle's next submit.
            cache = (weakref.ref(self), ek, ev)
            options._env_cache = cache
        return cache[1], cache[2]

    def _env_for_options(self, options: TaskOptions) -> tuple[str, dict]:
        from ray_tpu_torch.runtime_env import (
            build_runtime_env, merge_runtime_envs,
        )
        env_vars: dict[str, str] = {}
        need = self._effective_resources(options)
        if need.get("GPU", 0) <= 0:
            # CPU-only workers must never see the GPU: no CUDA
            # context of theirs lands on the card. (A GPU holder sees
            # its own cards: _card_env.)
            env_vars["CUDA_VISIBLE_DEVICES"] = ""
            env_vars[GPU_IDS_ENV] = ""
            # Also clear the configured plugin bootstrap vars so an
            # ambient sitecustomize doesn't eagerly import a device
            # runtime at interpreter start. Flag-driven: deployment
            # images with such hooks set cpu_worker_clear_env.
            for name in self.config.cpu_worker_clear_env.split(","):
                if name.strip():
                    env_vars[name.strip()] = ""
        merged = merge_runtime_envs(self.job_runtime_env,
                                    options.runtime_env)
        # Plugin build happens driver-side (the per-node agent analog,
        # reference runtime_env_agent.py:161); failures surface at
        # submission as RuntimeEnvSetupError, not inside the worker.
        ctx = build_runtime_env(merged)
        env_vars.update(ctx.to_env_vars())
        key = hashlib.sha1(
            ser.dumps(sorted(env_vars.items()))).hexdigest()[:12]
        return key, env_vars

    def _make_worker(self, env_key: str, env_vars: dict,
                     node_id: str):
        """Spawn a worker on the given node: a local subprocess for
        the head/logical nodes, a daemon-hosted process for real
        remote nodes (same exec-channel contract either way)."""
        node = self._nodes.get(node_id)
        if node is not None and node.is_daemon:
            return RemoteWorkerHandle(self, node, env_key, env_vars)
        return WorkerHandle(self, env_key, env_vars, node_id=node_id)

    def _take_worker(self, env_key: str, env_vars: dict,
                     node_id: str = "",
                     spawn: bool = True) -> WorkerHandle | None:
        node_id = node_id or self.head_node_id
        with self._pool_lock:
            pool = self._idle.get((node_id, env_key), [])
            while pool:
                w = pool.pop()
                if not w.dead:
                    w.busy = True
                    return w
            if not spawn:
                node = self._nodes.get(node_id)
                if not (node is not None and node.is_daemon):
                    # A local spawn would fork a process while
                    # holding _pool_lock — the no-spawn caller (an
                    # inline dispatch on a recv thread) hands back
                    # instead. Daemon nodes spawn remotely (a cheap
                    # channel send), so they are always allowed.
                    return None
            w = self._make_worker(env_key, env_vars, node_id)
            w.busy = True
            self._workers.append(w)
            return w

    def _return_worker(self, w: WorkerHandle) -> None:
        if w.dead:
            return
        with self._pool_lock:
            w.busy = False
            w.last_idle = time.monotonic()
            self._idle.setdefault((w.node_id, w.env_key), []).append(w)

    def _reap_idle_workers(self) -> None:
        # Rate-limited: the dispatcher calls this on every condvar
        # wakeup, which under load is every task completion — a
        # native pin scan plus a pool sweep per finished task showed
        # up as ~4% of head CPU in profiling. Once a second serves
        # both purposes (idle TTLs are tens of seconds; dead-pin
        # reclamation is correctness-deferred, not latency-bound).
        now = time.monotonic()
        if now - self._last_reap_ts < 1.0:
            return
        self._last_reap_ts = now
        # Also reclaim reader pins left by SIGKILLed processes
        # (plasma's client-disconnect release analog).
        reap = getattr(self.shm_store, "reap_dead_pins", None)
        if reap is not None:
            try:
                reap()
            except Exception:  # noqa: BLE001
                pass
        ttl = self.config.idle_worker_ttl_s
        with self._pool_lock:
            # Keep ONE warm worker, on the head node only — a warm
            # worker pinned to an autoscaled node would keep that node
            # "busy" forever and block scale-down.
            head_workers = sum(
                1 for w in self._workers
                if w.node_id == self.head_node_id)
            for key, pool in self._idle.items():
                node_id = key[0] if isinstance(key, tuple) else ""
                keep = []
                for w in pool:
                    expendable = (node_id != self.head_node_id
                                  or head_workers > 1)
                    if now - w.last_idle > ttl and expendable:
                        self._workers.remove(w)
                        if node_id == self.head_node_id:
                            head_workers -= 1
                        threading.Thread(target=w.shutdown,
                                         daemon=True).start()
                    else:
                        keep.append(w)
                self._idle[key] = keep

    def _dispatch(self, rec: TaskRecord,
                  spawn_ok: bool = True) -> None:
        if rec.env_vars is None:
            rec.env_key, rec.env_vars = self._env_for_options_cached(
                rec.options)
        env_key, env_vars = self._card_env(rec.env_key, rec.env_vars,
                                           rec.card_hold)
        w = self._take_worker(env_key, env_vars, rec.node_id,
                              spawn=spawn_ok)
        if w is None:
            raise self._InlineNeedsSpawn()
        try:
            self._start_on(rec, w)
        except TaskCancelledError:
            self._return_worker(w)
            raise
        w.card_hold = rec.card_hold
        rec.started_at = time.time()
        rec.attempts += 1
        fn_blob = None
        if rec.fn_id not in w.sent_fn_ids:
            fn_blob = self._fn_cache[rec.fn_id]
            w.sent_fn_ids.add(rec.fn_id)
        is_remote = isinstance(w, RemoteWorkerHandle)
        resolved = self._resolve_args_payload(
            rec.args_blob, rec.arg_refs, remote=is_remote)
        if is_remote and rec.return_ids:
            # Return ids ride ahead of the task so the daemon can keep
            # large results in its local store (ND_STORED) instead of
            # shipping them to the head.
            w.node.node_send((P.ND_TASK_META, w.index,
                              rec.task_id.binary(),
                              [o.binary() for o in rec.return_ids]))
        with w.lease_lock:
            w.lease_queue.append(rec)
        try:
            w.send((P.EXEC_TASK, rec.task_id.binary(), rec.fn_id,
                    fn_blob, rec.args_blob, resolved,
                    rec.options.num_returns,
                    getattr(rec.options, "trace_ctx", None),
                    getattr(rec.options, "placement_group", None)))
        except BaseException:
            # The rec never reached the worker: it must not occupy
            # the lease queue (a live worker would otherwise never
            # drain back to the pool). Failure handling is the
            # caller's (_dispatch_picked retry/fail).
            with w.lease_lock:
                try:
                    w.lease_queue.remove(rec)
                except ValueError:
                    pass
            raise
        self._event(rec, "RUNNING")
        self._try_pipeline_extras(rec, w)

    @staticmethod
    def _pipelineable(rec: TaskRecord) -> bool:
        return (rec.options.placement_group is None
                and rec.options.scheduling_strategy == "DEFAULT"
                and rec.options.num_returns != "streaming")

    def _try_pipeline_extras(self, rec: TaskRecord,
                             w: WorkerHandle) -> None:
        """Lease pipelining (reference: one lease executes many
        same-shape tasks, normal_task_submitter.cc lease reuse):
        queue up to depth-1 additional same-sched-class pending tasks
        onto the worker just dispatched to. They run serially under
        the SAME resource acquisition (leased=True skips acquire and
        release), so per-message head/worker overhead amortizes
        without over-subscribing resources."""
        depth = self.config.worker_pipeline_depth
        if depth <= 1 or w.is_actor or not self._pipelineable(rec):
            return
        # Cheap unlocked pre-check: nothing pending means nothing to
        # pipeline — skip the _res_cv acquisition and node scan (this
        # runs on EVERY dispatch; a stale read just means one missed
        # pipelining opportunity that the normal path picks up).
        if not self._pending_count:
            return
        extras: list[TaskRecord] = []
        with self._res_cv:
            with w.lease_lock:
                room = depth - len(w.lease_queue)
            if room <= 0:
                return
            # Pipeline ONLY under saturation: if any node could still
            # place this class, the task belongs on a fresh worker in
            # PARALLEL — queueing it here would serialize work the
            # cluster has capacity to spread (the reference pipelines
            # onto a lease only past the backlog point).
            need = rec.need or self._effective_resources(rec.options)
            if any(self._fits_pool(n.avail, need)
                   and self._fits_pool(n.resources, need)
                   for n in self._schedulable_nodes()):
                return
            # The class index holds exactly the dep-free same-class
            # candidates the old full-queue walk was looking for:
            # take from its head while the front matches (stopping at
            # the first non-pipelineable head keeps the pop O(1) and
            # preserves in-class FIFO).
            q = self._ready_classes.get(rec.sched_class)
            while q and len(extras) < room:
                cand = q[0]
                if (cand.state == "FAILED"
                        or not self._pipelineable(cand)):
                    break
                self._ready_pop_locked(rec.sched_class, q)
                cand.node_id = rec.node_id
                cand.pg_bundle = -1
                cand.leased = True
                extras.append(cand)
        for i, cand in enumerate(extras):
            try:
                self._dispatch_leased(cand, w)
            except TaskCancelledError:
                # cancel(force=True) marked it once it left the queue;
                # the lease holds the resources, so nothing to release.
                self._prune_task(cand)
            except Exception:  # noqa: BLE001
                # Worker died mid-append: EVERY not-yet-dispatched
                # extra goes back to the pending queue (they were
                # already popped from it — dropping any would strand
                # its caller forever); the normal dispatch path owns
                # them from here, and drops those cancelled meanwhile.
                for c in extras[i:]:
                    c.leased = False
                    if not self._retry(c):
                        self._prune_task(c)
                return

    def _dispatch_leased(self, rec: TaskRecord, w: WorkerHandle) -> None:
        if rec.env_vars is None:
            rec.env_key, rec.env_vars = self._env_for_options_cached(
                rec.options)
        self._start_on(rec, w)
        rec.started_at = time.time()
        rec.attempts += 1
        fn_blob = None
        if rec.fn_id not in w.sent_fn_ids:
            fn_blob = self._fn_cache[rec.fn_id]
            w.sent_fn_ids.add(rec.fn_id)
        is_remote = isinstance(w, RemoteWorkerHandle)
        resolved = self._resolve_args_payload(
            rec.args_blob, rec.arg_refs, remote=is_remote)
        if is_remote and rec.return_ids:
            w.node.node_send((P.ND_TASK_META, w.index,
                              rec.task_id.binary(),
                              [o.binary() for o in rec.return_ids]))
        with w.lease_lock:
            w.lease_queue.append(rec)
        try:
            w.send((P.EXEC_TASK, rec.task_id.binary(), rec.fn_id,
                    fn_blob, rec.args_blob, resolved,
                    rec.options.num_returns,
                    getattr(rec.options, "trace_ctx", None),
                    getattr(rec.options, "placement_group", None)))
        except BaseException:
            with w.lease_lock:
                try:
                    w.lease_queue.remove(rec)
                except ValueError:
                    pass
            raise
        self._event(rec, "RUNNING")

    # ---------------- worker message handling ----------------

    def _on_worker_message(self, w: WorkerHandle, msg: tuple) -> None:
        kind = msg[0]
        if kind == P.EXEC_BATCH:
            # Coalesced frame from the worker's outbox: one reader
            # wakeup + one unpickle for a burst of replies.
            for m in msg[1]:
                self._on_worker_message(w, m)
            return
        if kind == P.RESULT_OK:
            _, task_id_bytes, results = msg
            task_id = TaskID(task_id_bytes)
            if w.is_actor:
                self._finish_actor_task(w, task_id, results, None)
            else:
                self._finish_task(w, task_id, results, None)
        elif kind == P.RESULT_ERR:
            _, task_id_bytes, err_blob = msg
            if w.is_actor and len(task_id_bytes) == ActorID.SIZE:
                # Actor __init__ failed: the id on the wire is the
                # 16-byte actor id, not a 24-byte task id. Surface the
                # real traceback as the creation error.
                rec = self._actors.get(ActorID(task_id_bytes))
                if rec is not None:
                    rec.creation_error = ser.loads(err_blob)
                    rec.state = "DEAD"
                    rec.ready_event.set()
                    self._journal_actor_remove(rec)
                return
            task_id = TaskID(task_id_bytes)
            if w.is_actor:
                self._finish_actor_task(w, task_id, None, err_blob)
            else:
                self._finish_task(w, task_id, None, err_blob)
        elif kind == P.RESULT_STREAM:
            _, task_id_bytes, index, entry = msg
            self._stream_item(TaskID(task_id_bytes), index,
                              _wire_to_serialized(entry))
        elif kind == P.RESULT_STREAM_END:
            _, task_id_bytes, _count = msg
            task_id = TaskID(task_id_bytes)
            self._finish_stream(task_id)
            if w.is_actor:
                self._finish_actor_task(w, task_id, [], None)
            else:
                self._finish_task(w, task_id, [], None)
        elif kind == P.RESULT_READY:
            if w.is_actor and w.actor_id is not None:
                rec = self._actors.get(w.actor_id)
                if rec is not None:
                    rec.state = "ALIVE"
                    rec.ready_event.set()

    def _store_result_entries(self, w, return_ids, entries) -> None:
        """Mixed result entries from a node daemon (ND_STORED):
        ("inline", wire) stores head-side; ("stored", oid, size, refs)
        registers the daemon-resident copy in the directory."""
        for oid, e in zip(return_ids, entries):
            if e[0] == "stored":
                self._store_remote(oid, w.node_id, e[2], e[3])
            else:
                self._store_value(oid, _wire_to_serialized(e[1]))

    def _finish_task(self, w: WorkerHandle, task_id: TaskID,
                     results, err_blob, entries=None) -> None:
        with self._task_lock:
            rec = self._tasks.get(task_id)
        if rec is None:
            return
        if err_blob is None:
            if entries is not None:
                self._store_result_entries(w, rec.return_ids, entries)
            else:
                vals = [_wire_to_serialized(e) for e in results]
                for oid, v in zip(rec.return_ids, vals):
                    self._store_value(oid, v)
            rec.state = "FINISHED"
        else:
            for oid in rec.return_ids:
                self._store_error(oid, err_blob)
            self._finish_stream(rec.task_id, err_blob)
            rec.state = "FAILED"
        rec.finished_at = time.time()
        self._event(rec, rec.state)
        # Lease pipelining: the worker's queue holds every task riding
        # this lease. Resources release (and the worker returns to the
        # pool) only when the LAST queued task finishes — all queue
        # members share one acquisition and one sched class, so
        # releasing with the final rec's params frees exactly what the
        # first acquisition took.
        with w.lease_lock:
            try:
                w.lease_queue.remove(rec)
            except ValueError:
                pass
            lease_live = bool(w.lease_queue)
        if not lease_live:
            self._release(self._effective_resources(rec.options),
                          rec.options.placement_group,
                          node_id=rec.node_id, bundle=rec.pg_bundle,
                          hold=w.card_hold)
            self._return_worker(w)
            self._prune_task(rec)
            # Fill the slot this completion just freed without a
            # condvar handoff to the dispatcher thread (see
            # _try_dispatch_inline).
            self._try_dispatch_inline(limit=1)
        else:
            self._prune_task(rec)
            # Keep the live lease's pipeline full: top up from the
            # pending queue (same class as the task that just left).
            if not w.dead and self._pipelineable(rec):
                self._try_pipeline_extras(rec, w)

    def _forget_worker(self, w: WorkerHandle) -> None:
        """Drop a worker from the pools without task-failure handling
        (used when it died before ever connecting; the task outcome is
        handled by the dispatch retry path)."""
        with self._pool_lock:
            if w in self._workers:
                self._workers.remove(w)
            for pool in self._idle.values():
                if w in pool:
                    pool.remove(w)

    def _on_worker_exit(self, w: WorkerHandle) -> None:
        if self._shutdown:
            return
        with self._pool_lock:
            if w in self._workers:
                self._workers.remove(w)
            for pool in self._idle.values():
                if w in pool:
                    pool.remove(w)
        if w.is_actor and w.actor_id is not None:
            self._on_actor_death(w.actor_id, worker=w)
            return
        # A pooled worker died mid-task: retry or fail every task it
        # held (reference: owner-side TaskManager retries,
        # task_manager.cc). With lease pipelining a worker can hold
        # several queued tasks under ONE resource acquisition, so the
        # release runs once for the whole set.
        with self._task_lock:
            victims = [rec for rec in self._tasks.values()
                       if rec.worker is w and rec.state in (
                           "RUNNING", "CANCELLED")]
        with w.lease_lock:
            w.lease_queue.clear()
        if not victims:
            return
        self._release(self._effective_resources(victims[0].options),
                      victims[0].options.placement_group,
                      node_id=victims[0].node_id,
                      bundle=victims[0].pg_bundle, hold=w.card_hold)
        for victim in victims:
            self._handle_worker_victim(w, victim)

    def _handle_worker_victim(self, w: WorkerHandle,
                              victim: TaskRecord) -> None:
        victim.leased = False
        if victim.state == "CANCELLED":
            # cancel(force=True): error already stored; never retry.
            self._prune_task(victim)
            return
        if getattr(w, "drain_preempted", False):
            # The worker was killed by a node drain, not a crash: the
            # preemption was anticipated, so the interrupted attempt
            # is refunded — retry budget is reserved for real
            # failures (reference: drained leases are rescheduled,
            # not failed).
            victim.attempts = max(0, victim.attempts - 1)
            self.drain_tasks_preempted += 1
        max_retries = (victim.options.max_retries
                       if victim.options.max_retries >= 0
                       else self.config.task_max_retries)
        # A streaming task that already yielded items cannot be
        # transparently retried (the consumer may have observed a
        # prefix); only retry when nothing was produced yet.
        streaming = victim.options.num_returns == "streaming"
        produced = 0
        if streaming:
            with self._stream_lock:
                st = self._streams.get(victim.task_id)
            produced = st.produced if st is not None else 0
        if victim.attempts <= max_retries and (not streaming
                                               or produced == 0):
            if not self._retry(victim):
                # cancel(force=True) marked it since: never retried.
                self._prune_task(victim)
        else:
            if victim.oom_killed:
                from ray_tpu_torch.core.exceptions import OutOfMemoryError
                err: Exception = OutOfMemoryError(
                    f"task {victim.name} was killed by the memory "
                    f"monitor after {victim.attempts} attempts")
            else:
                err = TaskError(
                    victim.name,
                    f"worker process died (pid={w.proc.pid}, "
                    f"exitcode={w.proc.returncode}) after "
                    f"{victim.attempts} attempts")
            blob = ser.dumps(err)
            for oid in victim.return_ids:
                self._store_error(oid, blob)
            self._finish_stream(victim.task_id, blob)
            victim.state = "FAILED"
            self._event(victim, "FAILED")
            self._prune_task(victim)

    def _prune_task(self, rec: TaskRecord) -> None:
        """Drop the payload of a finished task and evict the record to a
        bounded buffer — records otherwise accumulate for the process
        lifetime (the timeline keeps a ring-buffered view)."""
        rec.args_blob = b""
        rec.arg_refs = []
        rec.worker = None
        with self._task_lock:
            self._tasks.pop(rec.task_id, None)
            self._done_tasks.append(rec)

    # ---------------- actor plane (GCS actor manager analog) ----------

    def create_actor(self, cls_blob: bytes, cls_name: str,
                     args: tuple, kwargs: dict, options: TaskOptions,
                     name: str = "", max_restarts: int = 0,
                     max_concurrency: int = 1) -> ActorID:
        actor_id = ActorID.of(self.job_id)
        # Resolve eagerly: broken runtime_env raises here, at
        # ``Cls.remote()``, not inside the async start thread.
        env_key, env_vars = self._env_for_options_cached(options)
        args_blob, arg_refs = self._pack_args(args, kwargs)
        rec = ActorRecord(
            actor_id=actor_id, name=name, cls_name=cls_name,
            cls_blob=cls_blob, init_args_blob=args_blob,
            init_arg_refs=arg_refs, options=options,
            max_restarts=max_restarts, max_concurrency=max_concurrency,
            env_key=env_key, env_vars=env_vars)
        with self._actor_lock:
            if name:
                if name in self._named_actors:
                    raise ValueError(f"actor name {name!r} already taken")
                self._named_actors[name] = actor_id
            self._actors[actor_id] = rec
        if name:
            # Durable before the creator's ack: an immediately
            # SIGKILLed head must still know this named actor.
            self._journal({"op": "actor",
                           "row": self._actor_snapshot_row(name, rec)})
        threading.Thread(target=self._start_actor, args=(rec,),
                         daemon=True).start()
        return actor_id

    def _start_actor(self, rec: ActorRecord) -> None:
        placed = None
        w = None
        send_failed = False
        need = self._effective_resources(rec.options)
        try:
            placed = self.acquire_on_some_node(
                need, rec.options,
                timeout=self.config.actor_creation_timeout_s,
                holder=rec)
            if placed is None:
                raise TimeoutError(
                    f"could not acquire resources {need} for actor "
                    f"{rec.cls_name} within "
                    f"{self.config.actor_creation_timeout_s}s")
            rec.node_id, rec.pg_bundle = placed
            if rec.env_vars is None:
                rec.env_key, rec.env_vars = \
                    self._env_for_options_cached(
                    rec.options)
            _, env_vars = self._card_env(rec.env_key, rec.env_vars,
                                         rec.card_hold)
            w = self._make_worker(f"actor_{rec.actor_id.hex()[:8]}",
                                  env_vars, rec.node_id)
            w.card_hold = rec.card_hold
            w.is_actor = True
            w.actor_id = rec.actor_id
            w.busy = True
            rec.worker = w
            with self._pool_lock:
                self._workers.append(w)
            resolved = self._resolve_args_payload(
                rec.init_args_blob, rec.init_arg_refs,
                remote=isinstance(w, RemoteWorkerHandle))
            try:
                w.send((P.EXEC_ACTOR_INIT, rec.actor_id.binary(),
                        rec.cls_blob, rec.init_args_blob, resolved,
                        rec.max_concurrency,
                        getattr(rec.options, "placement_group", None)))
            except Exception:
                send_failed = True
                raise
        except Exception as e:  # noqa: BLE001
            # Death detection must not rely on poll() alone: a worker
            # mid-teardown raises Broken/closed-pipe errors from
            # send() milliseconds before the process reaps. But ONLY
            # send-path errors count — an OSError from, say, resolving
            # init args with a live worker is a logic error that must
            # surface, not park the actor waiting for a death that
            # never comes.
            worker_died = w is not None and (
                w.proc.poll() is not None
                or (send_failed
                    and isinstance(e, (WorkerDiedBeforeConnectError,
                                       BrokenPipeError,
                                       ConnectionError, EOFError,
                                       OSError))))
            if worker_died and w.conn is not None:
                # The worker attached before dying: its reader thread
                # owns death handling (_on_worker_exit ->
                # _on_actor_death releases resources and decides the
                # restart) — doing it here too would double-release
                # and double-boot.
                return
            if w is not None:
                # Pre-attach death, or a non-death failure (e.g. an
                # init arg's error) with a healthy worker: clean up
                # here. rec.worker is detached FIRST so the reader
                # thread's eventual _on_actor_death is a no-op (stale
                # worker check).
                rec.worker = None
                with self._pool_lock:
                    if w in self._workers:
                        self._workers.remove(w)
                try:
                    w.proc.terminate()
                except Exception:  # noqa: BLE001
                    pass
            if placed is not None:
                self._release(need, rec.options.placement_group,
                              node_id=rec.node_id, bundle=rec.pg_bundle,
                              hold=rec.card_hold)
            # Only worker deaths consume restart budget; logic errors
            # (bad init args, infeasible placement) would fail every
            # retry identically — surface them immediately.
            if (worker_died
                    and rec.restart_count < rec.max_restarts
                    and not self._shutdown):
                rec.restart_count += 1
                rec.state = "RESTARTING"
                rec.ready_event.clear()
                time.sleep(0.1)
                self._start_actor(rec)
                return
            rec.creation_error = e
            rec.state = "DEAD"
            rec.ready_event.set()
            self._journal_actor_remove(rec)

    def submit_actor_task(self, actor_id: ActorID, method: str,
                          args: tuple, kwargs: dict,
                          num_returns: int = 1, trace_ctx=None,
                          preminted: tuple | None = None,
                          packed: tuple | None = None):
        """``packed``: see submit_task — ref-free pre-encoded args."""
        rec = self._actors.get(actor_id)
        if rec is None:
            raise ActorDiedError(actor_id.hex(), "unknown actor")
        streaming = num_returns == "streaming"
        if preminted is not None:
            task_id, return_ids = preminted
        else:
            task_id = TaskID.for_actor_task(actor_id)
            return_ids = [] if streaming else [
                ObjectID.for_return(task_id, i)
                for i in range(num_returns)]
        if packed is not None:
            args_blob, arg_refs = packed
        else:
            args_blob, arg_refs = self._pack_args(args, kwargs)
        refs = [self.register_ref(ObjectRef(oid)) for oid in return_ids]
        if streaming:
            with self._stream_lock:
                self._streams[task_id] = _StreamState(
                    cv=threading.Condition())
        with rec.queue_cv:
            if rec.submit_queue is None:
                rec.submit_queue = deque()
            rec.submit_queue.append(
                (task_id, return_ids, method, args_blob, arg_refs,
                 num_returns, trace_ctx))
            if rec.pusher is None:
                rec.pusher = threading.Thread(
                    target=self._actor_push_loop, args=(rec,),
                    daemon=True,
                    name=f"actor_push_{rec.actor_id.hex()[:8]}")
                rec.pusher.start()
            rec.queue_cv.notify_all()
        if streaming:
            return ObjectRefGenerator(task_id.binary(), _owner=True)
        return refs

    def _actor_push_loop(self, rec: ActorRecord) -> None:
        """Single pusher per actor: drains the submit queue in FIFO
        order, waiting out starts/restarts (reference: client-side
        queueing while actor restarts, ActorTaskSubmitter). Everything
        queued at wakeup ships as ONE exec-channel frame
        (P.EXEC_BATCH) — a 100-call burst pays one pickle+send+worker
        wakeup instead of 100; an idle queue still sends per-call with
        no added latency."""
        while not self._shutdown:
            with rec.queue_cv:
                while not rec.submit_queue:
                    rec.queue_cv.wait(1.0)
                    if self._shutdown:
                        return
                items = []
                while rec.submit_queue and len(items) < 128:
                    items.append(rec.submit_queue.popleft())
            w = None
            msgs: list = []
            sent: list = []     # (task_id, return_ids, method) per msg

            def fail_call(task_id, return_ids, method, exc):
                rec.in_flight.pop(task_id, None)
                blob = ser.dumps(
                    exc if isinstance(exc, ActorDiedError) else
                    TaskError(method,
                              f"exec channel send failed: {exc!r}",
                              None))
                for oid in return_ids:
                    self._store_error(oid, blob)
                self._finish_stream(task_id, blob)

            def flush():
                nonlocal msgs, sent
                if not msgs:
                    return
                try:
                    w.send(msgs[0] if len(msgs) == 1
                           else (P.EXEC_BATCH, msgs))
                except ValueError:
                    # The aggregate frame was refused (oversized),
                    # but the actor is alive and each call may be
                    # individually sendable — never report a live
                    # actor dead for a batching artifact.
                    for m, (task_id, return_ids, method) in zip(
                            msgs, sent):
                        try:
                            w.send(m)
                        except Exception as e2:  # noqa: BLE001
                            fail_call(task_id, return_ids, method, e2)
                except Exception as e:  # noqa: BLE001
                    # Transport death: every call in the frame dies
                    # the way a single failed send would have.
                    err = e if isinstance(e, ActorDiedError) else \
                        ActorDiedError(
                            rec.actor_id.hex(),
                            f"exec channel send failed: {e!r}")
                    for task_id, return_ids, method in sent:
                        fail_call(task_id, return_ids, method, err)
                msgs, sent = [], []

            for item in items:
                (task_id, return_ids, method, args_blob, arg_refs,
                 num_returns, trace_ctx) = item
                try:
                    if not rec.ready_event.wait(
                            self.config.actor_creation_timeout_s):
                        raise ActorDiedError(
                            rec.actor_id.hex(),
                            "actor failed to start in time")
                    if rec.state == "DEAD":
                        raise rec.creation_error or ActorDiedError(
                            rec.actor_id.hex(), "actor is dead")
                    if rec.worker is not w:
                        # Mid-batch restart: everything prepared so
                        # far was resolved/meta-registered for the
                        # OLD incarnation — ship it there, never to
                        # the replacement.
                        flush()
                        w = rec.worker
                    if w is None:
                        # Mid-migration (node drain detached the
                        # worker after we passed the ready gate):
                        # re-park until the replacement is up.
                        parked = time.monotonic() + \
                            self.config.actor_creation_timeout_s
                        while w is None:
                            if not rec.ready_event.wait(0.2):
                                if time.monotonic() > parked:
                                    raise ActorDiedError(
                                        rec.actor_id.hex(),
                                        "actor failed to restart "
                                        "in time")
                                continue
                            if rec.state == "DEAD":
                                raise rec.creation_error or \
                                    ActorDiedError(
                                        rec.actor_id.hex(),
                                        "actor is dead")
                            w = rec.worker
                    if arg_refs:
                        # An arg may BE an earlier call's result from
                        # this very batch (x = a.f.remote();
                        # a.g.remote(x)): resolving would block on a
                        # frame still sitting unsent in msgs —
                        # deadlock. Ship everything queued first.
                        flush()
                    is_remote = isinstance(w, RemoteWorkerHandle)
                    resolved = self._resolve_args_payload(
                        args_blob, arg_refs, remote=is_remote)
                    rec.in_flight[task_id] = (return_ids, method)
                    if is_remote and return_ids:
                        w.node.node_send((
                            P.ND_TASK_META, w.index, task_id.binary(),
                            [o.binary() for o in return_ids]))
                    msgs.append((P.EXEC_ACTOR_CALL, task_id.binary(),
                                 method, args_blob, resolved,
                                 num_returns, trace_ctx))
                    sent.append((task_id, return_ids, method))
                except Exception as e:  # noqa: BLE001
                    rec.in_flight.pop(task_id, None)
                    blob = ser.dumps(
                        e if isinstance(e, ActorDiedError) else
                        TaskError(method, traceback.format_exc(), e))
                    for oid in return_ids:
                        self._store_error(oid, blob)
                    self._finish_stream(task_id, blob)
            flush()

    def _finish_actor_task(self, w: WorkerHandle, task_id: TaskID,
                           results, err_blob, entries=None) -> None:
        rec = self._actors.get(w.actor_id) if w.actor_id else None
        if rec is None:
            return
        entry = rec.in_flight.pop(task_id, None)
        if entry is None:
            return
        return_ids, _method = entry
        if err_blob is None:
            if entries is not None:
                self._store_result_entries(w, return_ids, entries)
            else:
                vals = [_wire_to_serialized(e) for e in results]
                for oid, v in zip(return_ids, vals):
                    self._store_value(oid, v)
        else:
            for oid in return_ids:
                self._store_error(oid, err_blob)
            self._finish_stream(task_id, err_blob)

    def _on_actor_death(self, actor_id: ActorID,
                        worker=None) -> None:
        rec = self._actors.get(actor_id)
        if rec is None:
            return
        if worker is not None and rec.worker is not worker:
            # A stale incarnation's delayed exit: the current worker
            # is someone else — releasing resources or restarting on
            # its behalf would double-count.
            return
        # The dead incarnation's direct-call listener died with it:
        # revoke the lease so new resolves head-route until the
        # replacement re-registers.
        self._direct_invalidate(actor_id)
        # A kill landing mid-restart must keep consuming restart
        # budget, not permanently kill the actor (reference: the GCS
        # actor FSM keeps retrying RESTARTING actors,
        # gcs_actor_manager.cc:1358).
        was_alive = rec.state in ("ALIVE", "RESTARTING")
        # Fail all in-flight calls.
        err = ActorDiedError(
            actor_id.hex(),
            f"node {rec.node_id} drained: {rec.drain_reason}"
            if rec.drain_reason else "actor process exited")
        blob = ser.dumps(err)
        for task_id, (return_ids, _m) in rec.in_flight.items():
            for oid in return_ids:
                self._store_error(oid, blob)
            self._finish_stream(task_id, blob)
        rec.in_flight.clear()
        self._release(self._effective_resources(rec.options),
                      rec.options.placement_group,
                      node_id=rec.node_id, bundle=rec.pg_bundle,
                      hold=rec.card_hold)
        if (was_alive and rec.restart_count < rec.max_restarts
                and not self._shutdown):
            # GCS actor restart state machine analog
            # (gcs_actor_manager.cc:1358 RestartActor).
            rec.restart_count += 1
            rec.state = "RESTARTING"
            rec.ready_event.clear()
            threading.Thread(target=self._start_actor, args=(rec,),
                             daemon=True).start()
        else:
            rec.state = "DEAD"
            # Keep the real __init__ traceback if the RESULT_ERR handler
            # already recorded one; only fall back to the generic death
            # error for a clean-state exit.
            rec.creation_error = rec.creation_error or err
            rec.ready_event.set()
            self._journal_actor_remove(rec)
            with self._actor_lock:
                if rec.name and self._named_actors.get(rec.name) == actor_id:
                    del self._named_actors[rec.name]

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        rec = self._actors.get(actor_id)
        if rec is None or rec.worker is None:
            return
        if no_restart:
            rec.max_restarts = rec.restart_count  # disable further restarts
        # Leave rec.state alone: _on_actor_death decides restart-vs-dead
        # from (state == ALIVE, restarts remaining); with no_restart the
        # capped max_restarts forces the permanent-death branch.
        rec.worker.proc.terminate()

    def get_named_actor(self, name: str) -> ActorID:
        with self._actor_lock:
            if name not in self._named_actors:
                raise ValueError(f"no actor named {name!r}")
            return self._named_actors[name]

    def actor_state(self, actor_id: ActorID) -> str:
        rec = self._actors.get(actor_id)
        return rec.state if rec else "DEAD"

    def wait_actor_ready(self, actor_id: ActorID,
                         timeout: float | None = None) -> None:
        rec = self._actors.get(actor_id)
        if rec is None:
            raise ActorDiedError(actor_id.hex(), "unknown actor")
        rec.ready_event.wait(timeout)
        if rec.state == "DEAD":
            raise rec.creation_error or ActorDiedError(
                actor_id.hex(), "actor failed to start")

    # ---------------- placement groups ----------------

    def create_placement_group(self, bundles: list[dict[str, float]],
                               strategy: str,
                               name: str = "") -> PlacementGroupID:
        pg_id = PlacementGroupID.from_random()
        rec = PGRecord(pg_id=pg_id, bundles=bundles, strategy=strategy,
                       name=name)
        with self._pg_lock:
            if name:
                # named PGs are unique among live groups (reference:
                # placement_group(name=...) raises on a taken name)
                for other in self._pgs.values():
                    if other.name == name:
                        raise ValueError(
                            f"placement group name {name!r} is taken")
            self._pgs[pg_id] = rec
        self._journal({"op": "pg", "row": {
            "id": pg_id.hex(), "bundles": bundles,
            "strategy": strategy, "name": name}})

        def reserve():
            # All-or-nothing bundle placement across nodes per strategy
            # (2-phase-commit analog: assignment is computed and
            # committed atomically under the resource lock —
            # gcs_placement_group_scheduler.cc).
            with self._res_cv:
                while not self._shutdown:
                    assignment = self._place_bundles_locked(
                        bundles, strategy)
                    if assignment is not None:
                        for bi, node_id in enumerate(assignment):
                            self._take_from_node(
                                self._nodes[node_id], bundles[bi])
                        rec.bundle_nodes = assignment
                        rec.bundle_avail = [dict(b) for b in bundles]
                        rec.created = True
                        self._res_cv.notify_all()
                        break
                    self._res_cv.wait(0.5)
            rec.ready.set()

        threading.Thread(target=reserve, daemon=True).start()
        return pg_id

    def _place_bundles_locked(self, bundles: list[dict[str, float]],
                              strategy: str) -> list[str] | None:
        """Map every bundle to a node (or None if impossible now).

        PACK / STRICT_PACK: all bundles on one node (STRICT_PACK fails
        otherwise; PACK falls back to spreading). SPREAD /
        STRICT_SPREAD: round-robin distinct-ish nodes (STRICT_SPREAD
        requires pairwise-distinct nodes). Reference: bundle strategies
        in gcs_placement_group_scheduler.cc.
        """
        # Not on a draining node: its bundles would die with it.
        nodes = self._schedulable_nodes()
        if not nodes:
            return None

        def node_fits_all(n: NodeRecord) -> bool:
            total: dict[str, float] = {}
            for b in bundles:
                for k, v in b.items():
                    total[k] = total.get(k, 0.0) + v
            return self._fits_pool(n.avail, total)

        if strategy in ("PACK", "STRICT_PACK"):
            for n in nodes:
                if node_fits_all(n):
                    return [n.node_id] * len(bundles)
            if strategy == "STRICT_PACK":
                return None
        # spread (and PACK fallback): greedy first-fit over a rotating
        # node order, tracking tentative consumption.
        tentative = {n.node_id: dict(n.avail) for n in nodes}
        assignment: list[str] = []
        used_nodes: set[str] = set()
        for bi, b in enumerate(bundles):
            placed_on = None
            order = nodes[bi % len(nodes):] + nodes[:bi % len(nodes)]
            for n in order:
                if strategy == "STRICT_SPREAD" and n.node_id in used_nodes:
                    continue
                if self._fits_pool(tentative[n.node_id], b):
                    placed_on = n.node_id
                    break
            if placed_on is None:
                return None
            for k, v in b.items():
                tentative[placed_on][k] = (
                    tentative[placed_on].get(k, 0.0) - v)
            used_nodes.add(placed_on)
            assignment.append(placed_on)
        return assignment

    def pg_ready(self, pg_id: PlacementGroupID,
                 timeout: float | None = None) -> bool:
        rec = self._pgs.get(pg_id)
        if rec is None:
            return False
        return rec.ready.wait(timeout)

    def remove_placement_group(self, pg_id: PlacementGroupID) -> None:
        with self._pg_lock:
            rec = self._pgs.pop(pg_id, None)
        if rec is not None:
            self._journal({"op": "pg_remove", "id": pg_id.hex()})
        if rec and rec.created:
            # Return only the unclaimed share of each bundle to its
            # node; resources held by still-running PG tasks flow back
            # to the node pool when they finish (after removal,
            # _release falls through to the node).
            for bi, pool in enumerate(rec.bundle_avail):
                self._release(pool, node_id=rec.bundle_nodes[bi])

    # ---------------- cancellation ----------------

    def cancel(self, ref: ObjectRef, force: bool = False) -> None:
        task_id = ref.id.task_id()
        with self._res_cv:
            # Rare path: a linear probe over both pending structures
            # is fine here (cancel is explicit and infrequent; the
            # hot-path scans are the indexed ones).
            rec = None
            dq = self._pending_deps
            for i in range(len(dq)):
                if dq[i].task_id == task_id:
                    rec = dq[i]
                    del dq[i]
                    break
            if rec is None:
                hit = None
                for klass, q in self._ready_classes.items():
                    for i in range(len(q)):
                        if q[i].task_id == task_id:
                            rec = q[i]
                            del q[i]
                            hit = klass
                            break
                    if rec is not None:
                        break
                if hit is not None and not self._ready_classes[hit]:
                    del self._ready_classes[hit]
            if rec is not None:
                self._pending_removed_locked(rec)
                blob = ser.dumps(TaskCancelledError(rec.name))
                for oid in rec.return_ids:
                    self._store_error(oid, blob)
                rec.state = "CANCELLED"
                return
        if force:
            # Running, its worker starting, or taken from the queue and
            # not yet started: marked under the lock that _start_on and
            # _retry check, so neither starts nor queues it again.
            with self._task_lock:
                rec = self._tasks.get(task_id)
                if rec is None or rec.state not in ("PENDING", "RUNNING"):
                    return
                rec.state = "CANCELLED"
                worker = rec.worker
            # The error is stored BEFORE terminating: _on_worker_exit and
            # _dispatch_picked see CANCELLED, not RUNNING, and release
            # the task's resources once without retrying it.
            blob = ser.dumps(TaskCancelledError(rec.name))
            for oid in rec.return_ids:
                self._store_error(oid, blob)
            if worker is not None:
                worker.proc.terminate()

    # ---------------- introspection ----------------

    # ---------------- internal KV (GCS KV analog) ----------------

    # ---------------- pubsub (long-poll channels) ----------------
    # Reference: src/ray/pubsub/ publisher/subscriber — a bounded
    # per-topic ring; subscribers long-poll from their cursor.

    _PUBSUB_RING = 1024
    _PUBSUB_TOPIC_TTL_S = 600.0
    # One poll round parks a handler thread at most this long — an
    # abandoned long poll (client died mid-wait) can't pin a head
    # thread forever; live subscribers simply re-poll.
    _PUBSUB_MAX_WAIT_S = 60.0

    def _pubsub_topic(self, topic: str):
        now = time.monotonic()
        with self._pubsub_lock:
            # Reap idle topics: first-touch creation means typo'd or
            # ephemeral names would otherwise accumulate forever,
            # each pinning up to a full ring of payloads.
            if len(self._pubsub) > 64:
                for name in [n for n, e in self._pubsub.items()
                             if now - e["last_used"]
                             > self._PUBSUB_TOPIC_TTL_S]:
                    self._pubsub.pop(name, None)
            ent = self._pubsub.get(topic)
            if ent is None:
                ent = self._pubsub[topic] = {
                    "buf": deque(maxlen=self._PUBSUB_RING),
                    "seq": 0,
                    # Epoch detects head restarts: seq resets with
                    # the process, and a stale high cursor would
                    # otherwise filter everything out forever.
                    "epoch": os.urandom(8).hex(),
                    "cv": threading.Condition(),
                    "last_used": now,
                }
            ent["last_used"] = now
            return ent

    def pubsub_publish(self, topic: str, blob: bytes) -> int:
        ent = self._pubsub_topic(topic)
        with ent["cv"]:
            ent["seq"] += 1
            ent["buf"].append((ent["seq"], bytes(blob)))
            ent["cv"].notify_all()
            return ent["seq"]

    def pubsub_cursor(self, topic: str):
        ent = self._pubsub_topic(topic)
        with ent["cv"]:
            return ent["epoch"], ent["seq"]

    def pubsub_poll(self, topic: str, epoch: str, cursor: int,
                    timeout: float | None = 1.0,
                    max_messages: int = 256):
        """-> (epoch, cursor, [blobs], dropped). An epoch mismatch
        (head restarted; this topic's seqs restarted with it) rewinds
        the cursor to the ring's start: at-least-once beats a
        subscriber going silently deaf behind a stale high cursor.

        ``dropped`` is the discontinuity indicator at-least-once
        consumers use to resync state instead of assuming continuity
        (advisor r3; reference subscribers surface publisher
        restarts/gaps the same way): >0 = that many seqs were evicted
        from the ring before this subscriber saw them; -1 = epoch
        changed under the subscriber (head restart or topic reaped by
        the idle-TTL sweep), so an UNKNOWN number of old-epoch
        messages is gone and ring re-delivery may duplicate."""
        ent = self._pubsub_topic(topic)
        timeout = (self._PUBSUB_MAX_WAIT_S if timeout is None
                   else min(timeout, self._PUBSUB_MAX_WAIT_S))
        deadline = time.monotonic() + timeout
        with ent["cv"]:
            rewound = epoch != ent["epoch"]
            if rewound:
                cursor = 0
            while True:
                buf = ent["buf"]
                # Seqs are contiguous: the unseen tail length is
                # arithmetic, not an O(ring) scan under the lock.
                behind = max(ent["seq"] - cursor, 0)
                n_new = min(len(buf), behind)
                if n_new:
                    dropped = -1 if rewound else behind - n_new
                    n = min(n_new, max_messages)
                    start = len(buf) - n_new
                    out = list(itertools.islice(buf, start,
                                                start + n))
                    return (ent["epoch"], out[-1][0],
                            [b for _s, b in out], dropped)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return (ent["epoch"], cursor, [],
                            -1 if rewound else 0)
                ent["cv"].wait(remaining)

    def kv_put(self, key: bytes, value: bytes,
               namespace: str = "", overwrite: bool = True) -> bool:
        """Atomic put; with overwrite=False this is the GCS KV's
        PutIfAbsent (exactly one concurrent caller wins)."""
        from ray_tpu_torch.core.oplog import b64e
        waiter = None
        with self._kv_lock:
            k = (namespace, bytes(key))
            if not overwrite and k in self._kv:
                return False
            self._kv[k] = bytes(value)
            # Enqueue under the mutation lock: log order must match
            # memory order for same-key writes. The fsync wait
            # happens after release.
            waiter = self._journal_async(
                {"op": "kv_put", "ns": namespace,
                 "k": b64e(key), "v": b64e(value)})
        if waiter is not None:
            waiter()
        return True

    def kv_get(self, key: bytes, namespace: str = "") -> bytes | None:
        with self._kv_lock:
            return self._kv.get((namespace, bytes(key)))

    def kv_del(self, key: bytes, namespace: str = "") -> bool:
        from ray_tpu_torch.core.oplog import b64e
        waiter = None
        with self._kv_lock:
            hit = self._kv.pop((namespace, bytes(key)), None) \
                is not None
            if hit:
                waiter = self._journal_async(
                    {"op": "kv_del", "ns": namespace,
                     "k": b64e(key)})
        if waiter is not None:
            waiter()
        return hit

    def kv_exists(self, key: bytes, namespace: str = "") -> bool:
        with self._kv_lock:
            return (namespace, bytes(key)) in self._kv

    def kv_keys(self, prefix: bytes = b"",
                namespace: str = "") -> list[bytes]:
        with self._kv_lock:
            return [k for (ns, k) in self._kv
                    if ns == namespace and k.startswith(prefix)]

    def request_resources(self, bundles: list[dict]) -> None:
        """Explicit autoscaler demand floor (reference:
        ray.autoscaler.sdk.request_resources): the request REPLACES
        any previous one and persists until overridden — the
        reconciler scales up to accommodate it and will not idle-kill
        capacity it needs."""
        self._explicit_requests = [dict(b) for b in bundles]

    def explicit_resource_requests(self) -> list[dict]:
        return [dict(b)
                for b in getattr(self, "_explicit_requests", [])]

    def resource_demand(self) -> list[dict[str, float]]:
        """Unmet resource requests (autoscaler input — reference:
        resource demand in autoscaler.proto / GcsAutoscalerStateManager):
        one dict per pending task, pending actor, and unplaced PG
        bundle."""
        out: list[dict[str, float]] = []
        with self._res_cv:
            for rec in self._pending_deps:
                out.append(dict(self._effective_resources(rec.options)))
            for q in self._ready_classes.values():
                for rec in q:
                    out.append(dict(
                        self._effective_resources(rec.options)))
        # Lease backlogs: tasks queued on a worker beyond the one
        # executing are demand the cluster could not spread — without
        # this the pipeline would HIDE load from the autoscaler
        # (reference: NormalTaskSubmitter backlog reporting feeding
        # the resource demand view).
        with self._pool_lock:
            workers = list(self._workers)
        for w in workers:
            lq = getattr(w, "lease_queue", None)
            if lq is None:
                continue
            with w.lease_lock:
                queued = list(lq)[1:]
            for rec in queued:
                out.append(dict(self._effective_resources(rec.options)))
        with self._actor_lock:
            for arec in self._actors.values():
                if arec.state == "PENDING" and not arec.node_id:
                    out.append(dict(
                        self._effective_resources(arec.options)))
        with self._pg_lock:
            for pg in self._pgs.values():
                if not pg.created:
                    out.extend(dict(b) for b in pg.bundles)
        return out

    def available_resources(self) -> dict[str, float]:
        out: dict[str, float] = {}
        with self._res_cv:
            for n in self._alive_nodes():
                for k, v in n.avail.items():
                    out[k] = out.get(k, 0.0) + v
        return out

    def cluster_resources(self) -> dict[str, float]:
        out: dict[str, float] = {}
        with self._res_cv:
            for n in self._alive_nodes():
                for k, v in n.resources.items():
                    out[k] = out.get(k, 0.0) + v
        return out

    def nodes(self) -> list[dict]:
        with self._res_cv:
            recs = list(self._nodes.values())
        with self._pool_lock:
            per_node = {}
            for w in self._workers:
                per_node[w.node_id] = per_node.get(w.node_id, 0) + 1
        return [{
            "NodeID": n.node_id,
            "Alive": n.alive,
            "IsHead": n.is_head,
            "Draining": n.draining,
            "DrainReason": n.drain_reason,
            "Resources": dict(n.resources),
            "Available": dict(n.avail),
            "Labels": dict(n.labels),
            "alive_workers": per_node.get(n.node_id, 0),
            "Observed": dict(n.observed),
        } for n in recs]

    def list_state(self, kind: str, filters=None):
        """State-API read usable from the driver process (workers
        reach the same tables through OP_STATE)."""
        from ray_tpu_torch.util import state as state_api
        if kind == "raw_nodes":
            return self.nodes()
        if kind == "tasks_detail":
            return state_api.list_tasks(filters, detail=True)
        if kind == "cluster_metrics":
            return self.observability.prometheus_text()
        if kind == "memory_summary":
            opts = filters if isinstance(filters, dict) else {}
            return self.memory_summary(
                top_n=int(opts.get("top_n", 20)))
        if kind == "cluster_status":
            return self.cluster_status()
        if kind == "trace":
            opts = filters if isinstance(filters, dict) else {}
            return self.get_trace(str(opts.get("trace_id", "")))
        if kind == "traces":
            opts = filters if isinstance(filters, dict) else {}
            return self.list_traces(
                limit=int(opts.get("limit", 50)),
                slowest=bool(opts.get("slowest", False)))
        if kind == "trace_export":
            opts = filters if isinstance(filters, dict) else {}
            return self.observability.export_trace(
                str(opts.get("trace_id", "")),
                str(opts.get("format", "chrome")))
        if kind == "timeseries":
            return self.observability.signals.query(filters)
        if kind == "alerts":
            return self.observability.alerts()
        if kind == "deployment_signals":
            opts = filters if isinstance(filters, dict) else {}
            return self.observability.deployment_signals(
                str(opts.get("name", "")),
                window_s=opts.get("window"))
        fns = {
            "tasks": state_api.list_tasks,
            "actors": state_api.list_actors,
            "objects": state_api.list_objects,
            "nodes": state_api.list_nodes,
            "placement_groups": state_api.list_placement_groups,
        }
        return fns[kind](filters)

    def _event(self, rec: TaskRecord, state: str) -> None:
        # Raw tuple on the hot path (3 appends per task); formatted
        # into dicts lazily by task_events() at read time.
        now = time.time()
        self._events.append((rec.task_id, rec.name, state, now))
        self.observability.record_head_event(rec, state, now)

    @staticmethod
    def _format_event(ev) -> dict:
        if isinstance(ev, dict):
            return ev
        tid, name, state, ts = ev
        return {"task_id": tid.hex(), "name": name,
                "state": state, "ts": ts}

    def task_events(self) -> list[dict]:
        return [self._format_event(e) for e in list(self._events)]

    def timeline(self) -> list[dict]:
        # Chrome-trace "X" events derived from task records
        # (reference: chrome_tracing_dump, _private/state.py:438),
        # plus the cluster half: worker-side execution slices pushed
        # through the observability plane and every collected span —
        # one trace covers driver, head workers, and remote nodes.
        out = []
        with self._task_lock:
            records = list(self._done_tasks) + list(self._tasks.values())
        for rec in records:
            if rec.started_at and rec.finished_at:
                out.append({
                    "name": rec.name, "ph": "X", "pid": 0,
                    "tid": rec.worker_index,
                    "ts": rec.started_at * 1e6,
                    "dur": (rec.finished_at - rec.started_at) * 1e6,
                    "cat": "task",
                })
        out.extend(self.observability.timeline_events())
        return out

    # ---------------- introspection / profiling plane -----------------
    # (SURVEY §L6: the ray status / ray memory / ray stack + dashboard
    # flame-graph surface, served over OP_STATE / OP_PROFILE.)

    def memory_summary(self, top_n: int = 20) -> dict:
        """Per-node object-store usage + top-N objects by size with
        owner, ref counts, and primary/replica/pinned/spilled state
        (reference: ray memory / memory_summary)."""
        from ray_tpu_torch.observability.introspect import memory_summary
        return memory_summary(self, top_n=top_n)

    def cluster_status(self) -> dict:
        """Per-node resources/drain state, task/actor/worker counts,
        and autoscaler intent (reference: ray status)."""
        from ray_tpu_torch.observability.introspect import cluster_status
        return cluster_status(self)

    def get_trace(self, trace_id: str) -> dict | None:
        """One assembled trace tree with critical-path analysis (the
        'where did this request go?' surface; spans from every plane
        — head, workers, serve — joined by trace_id)."""
        return self.observability.get_trace(trace_id)

    def list_traces(self, limit: int = 50,
                    slowest: bool = False) -> list[dict]:
        """Assembled-trace summaries, newest first (or slowest first
        with ``slowest=True``)."""
        return self.observability.list_traces(
            limit=limit, slowest=slowest)

    # ------------- direct actor-call plane (location leases) ----------

    def _count_client_op(self, op: str) -> None:
        with self._op_count_lock:
            self.client_op_counts[op] = \
                self.client_op_counts.get(op, 0) + 1

    def _direct_register(self, info: dict) -> None:
        """A hosting worker announced its direct-call listener.
        Accepted whenever the actor record exists — RESULT_READY (exec
        channel) and this notify (client channel) race, and a lease is
        only ever GRANTED for an ALIVE actor."""
        try:
            actor_id = ActorID(info["actor_id"])
            addr = tuple(info["addr"])
            token = str(info["token"])
        except (KeyError, TypeError, ValueError):
            return
        if self._actors.get(actor_id) is None:
            return
        with self._direct_reg_lock:
            epoch = self._direct_epoch.get(actor_id, 0) + 1
            self._direct_epoch[actor_id] = epoch
            self._direct_registry[actor_id] = (addr, token, epoch)

    def _direct_invalidate(self, actor_id: ActorID) -> None:
        """Drop an actor's location lease (death, kill, restart,
        drain migration): new resolves head-route until the next
        incarnation's worker re-registers; existing callers notice
        the closed socket and fall back on their own."""
        with self._direct_reg_lock:
            if self._direct_registry.pop(actor_id, None) is not None:
                self._direct_epoch[actor_id] = \
                    self._direct_epoch.get(actor_id, 0) + 1

    def actor_location_lease(self, actor_id: ActorID):
        """(addr, token_hex, epoch) for a direct-callable actor, or
        None (caller keeps head routing). Draining nodes grant no
        leases: mid-migration calls must park in the head's pusher,
        not race the incarnation swap."""
        if not self.config.direct_calls_enabled:
            return None
        rec = self._actors.get(actor_id)
        if rec is None or rec.state != "ALIVE":
            return None
        node = self._nodes.get(rec.node_id)
        if node is not None and getattr(node, "draining", False):
            return None
        with self._direct_reg_lock:
            return self._direct_registry.get(actor_id)

    # ------------- profiling plane ------------------------------------

    def _profile_register(self, info: dict, push_fn) -> int:
        """A worker client connection announced it can execute
        profile upcalls; push_fn ships one SRV_REQ frame down it."""
        peer_id = next(self._profile_peer_seq)
        with self._profile_peers_lock:
            self._profile_peers[peer_id] = {
                "push": push_fn,
                "pid": int(info.get("pid") or 0),
                "node_id": str(info.get("node_id") or "")
                or self.head_node_id,
                "worker_id": str(info.get("worker_id") or ""),
            }
        return peer_id

    def _profile_unregister(self, peer_id: int | None) -> None:
        if peer_id is None:
            return
        with self._profile_peers_lock:
            self._profile_peers.pop(peer_id, None)

    def _on_profile_result(self, token: str, payload) -> None:
        with self._profile_results_lock:
            entry = self._profile_results.pop(token, None)
        if entry is not None:
            event, slot = entry
            slot.append(payload)
            event.set()

    def _profile_target_match(self, target, node_id: str,
                              kind: str, pid: int) -> bool:
        """``target`` selects processes: None/"" = everything,
        "head" = the head process, a node id (prefix) = that node's
        daemon + workers, "pid:<n>" = one process."""
        if not target:
            return True
        t = str(target)
        if t == "head":
            return kind == "head"
        if t.startswith("pid:"):
            return pid == int(t[4:])
        return node_id.startswith(t)

    def _profile_fanout(self, op: str, args: dict,
                        target=None) -> list[dict]:
        """Run one profile op on every matching process — the head
        itself (inline thread), node daemons (ND_CALL), and
        registered worker connections (SRV_REQ push) — and collect
        ``{node_id, kind, pid, ok, value|error}`` rows."""
        from ray_tpu_torch.observability import profiler as prof
        duration_s = float(args.get("duration_s", 2.0))
        wait_s = duration_s + 30.0
        rows: list[dict] = []
        threads: list[threading.Thread] = []

        def run(row, fn):
            def _go():
                try:
                    row["value"] = fn()
                    row["ok"] = True
                except BaseException as e:  # noqa: BLE001
                    row["ok"] = False
                    row["error"] = f"{type(e).__name__}: {e}"
            t = threading.Thread(target=_go, daemon=True,
                                 name="profile_fanout")
            t.start()
            threads.append(t)

        if self._profile_target_match(target, self.head_node_id,
                                      "head", os.getpid()):
            row = {"node_id": self.head_node_id, "kind": "head",
                   "pid": os.getpid()}
            rows.append(row)
            run(row, lambda: prof.handle_profile_op(op, args))
        with self._res_cv:
            daemons = [n for n in self._nodes.values()
                       if n.alive and n.is_daemon]
        for node in daemons:
            if not self._profile_target_match(target, node.node_id,
                                              "daemon", node.pid):
                continue
            row = {"node_id": node.node_id, "kind": "daemon",
                   "pid": node.pid}
            rows.append(row)
            run(row, lambda n=node: self._node_call(
                n, op, args, timeout=wait_s))
        with self._profile_peers_lock:
            peers = list(self._profile_peers.values())
        for peer in peers:
            if not self._profile_target_match(
                    target, peer["node_id"], "worker", peer["pid"]):
                continue
            row = {"node_id": peer["node_id"], "kind": "worker",
                   "pid": peer["pid"]}
            rows.append(row)
            run(row, lambda p=peer: self._profile_peer_call(
                p, op, args, wait_s))
        deadline = time.monotonic() + wait_s
        for t in threads:
            t.join(max(0.1, deadline - time.monotonic()))
        for row in rows:
            if "ok" not in row:
                row["ok"] = False
                row["error"] = "timed out"
        return rows

    def _profile_peer_call(self, peer: dict, op: str, args: dict,
                           wait_s: float):
        """One SRV_REQ round trip to a registered worker: push the
        request down its client channel, wait for the OP_PROFILE
        ("result", token, ...) notify."""
        import uuid
        token = uuid.uuid4().hex
        event = threading.Event()
        slot: list = []
        with self._profile_results_lock:
            self._profile_results[token] = (event, slot)
        try:
            peer["push"](token, op, args)
        except BaseException:
            with self._profile_results_lock:
                self._profile_results.pop(token, None)
            raise
        if not event.wait(wait_s):
            with self._profile_results_lock:
                self._profile_results.pop(token, None)
            raise GetTimeoutError(
                f"profile upcall to pid {peer['pid']} timed out")
        payload = slot[0]
        if isinstance(payload, dict) and payload.get("__error__"):
            raise RuntimeError(payload["__error__"])
        return payload

    def profile_cluster(self, duration_s: float = 2.0,
                        hz: float = 100.0, target=None) -> dict:
        """Sample stacks across the cluster and merge them into one
        flame graph (reference: the dashboard's py-spy flame-graph
        capture, cluster-wide). One capture at a time — concurrent
        captures would contend the per-process samplers and
        double-count."""
        from ray_tpu_torch.observability import profiler as prof
        if not self._profile_session_lock.acquire(blocking=False):
            raise prof.ProfilerBusyError(
                "a cluster profile capture is already in progress")
        try:
            args = {"duration_s": float(duration_s),
                    "hz": float(hz)}
            rows = self._profile_fanout("profile", args, target)
            merged: dict[str, int] = {}
            procs = []
            for row in rows:
                proc = {"node_id": row["node_id"],
                        "kind": row["kind"], "pid": row["pid"],
                        "ok": row["ok"]}
                if row["ok"] and isinstance(row.get("value"), dict):
                    val = row["value"]
                    prefix = (f"{row['kind']}:"
                              f"{row['node_id'][:12]}:pid"
                              f"{val.get('pid', row['pid'])}")
                    merged = prof.merge_collapsed(
                        [merged,
                         prof.merge_collapsed([val["collapsed"]],
                                              prefix=prefix)])
                    proc["samples"] = val.get("samples", 0)
                    proc["threads"] = val.get("threads", 0)
                    proc["collapsed"] = val.get("collapsed", {})
                else:
                    proc["error"] = row.get("error", "")
                procs.append(proc)
            return {"collapsed": merged, "procs": procs,
                    "duration_s": float(duration_s),
                    "hz": float(hz)}
        finally:
            self._profile_session_lock.release()

    def stack_dump(self, target=None) -> list[dict]:
        """Current stack traces of matching processes (reference:
        ``ray stack``)."""
        rows = self._profile_fanout("stack", {"duration_s": 0.0},
                                    target)
        return [{"node_id": r["node_id"], "kind": r["kind"],
                 "pid": r["pid"], "ok": r["ok"],
                 ("stacks" if r["ok"] else "error"):
                 (r.get("value") if r["ok"]
                  else r.get("error", ""))} for r in rows]

    def profile_device(self, logdir: str | None = None,
                       duration_s: float = 5.0,
                       target=None) -> list[dict]:
        """Trigger a ``torch.profiler`` capture on matching node
        processes onto ``logdir`` (remote device profiling hook)."""
        return self._profile_fanout(
            "profile_device",
            {"logdir": logdir or temp_path("ray_tpu_torch_profile"),
             "duration_s": float(duration_s)},
            target or "head")

    # ---------------- client service (worker -> driver API) -----------

    def _register_pending_worker(self, w: WorkerHandle) -> None:
        with self._pending_workers_lock:
            self._pending_workers[w.token] = w

    def ensure_tcp_listener(self, host: str = "127.0.0.1",
                            port: int = 0) -> tuple[str, int]:
        """Start the cross-host TCP listener (idempotent). Node
        daemons and remote clients authenticate with the session's
        cluster_token (multiprocessing.connection HMAC handshake —
        the reference secures this hop with gRPC + cluster identity)."""
        if self._tcp_listener is not None:
            return self.tcp_address
        self._tcp_listener = wire.WireListener(
            (host, port), family="AF_INET",
            authkey=self.cluster_token, kind=wire.K_CLIENT,
            crosses_nodes=True)
        self.tcp_address = self._tcp_listener.address
        threading.Thread(
            target=self._accept_loop, args=(self._tcp_listener,),
            daemon=True, name="tcp_accept").start()
        return self.tcp_address

    def _accept_loop(self, listener=None) -> None:
        listener = listener or self._listener
        while not self._shutdown:
            try:
                conn = listener.accept()
            except Exception:  # noqa: BLE001
                # Bad token (AuthenticationError) or a dropped dial
                # must not kill the accept loop; a closed listener
                # (shutdown() flips the flag first) ends it.
                if self._shutdown:
                    return
                continue
            t = threading.Thread(target=self._handshake, args=(conn,),
                                 daemon=True)
            t.start()
            self._client_threads.append(t)

    def _handshake(self, conn) -> None:
        # First message identifies the connection: ("hello", "exec",
        # token) pairs an exec channel with its WorkerHandle;
        # ("hello", "client", _) starts an API-proxy session;
        # ("hello", "node", _) registers a node daemon (the connection
        # becomes that node's control channel).
        try:
            # Hello deadline: an accepted connection whose dialer
            # never speaks (half-open, frozen wire) must not pin this
            # handshake thread forever.
            if not conn.poll(self.config.connect_timeout_s):
                conn.close()
                return
            hello = conn.recv()
        except (EOFError, OSError):
            return
        if not (isinstance(hello, tuple) and len(hello) == 3
                and hello[0] == "hello"):
            conn.close()
            return
        _, kind, token = hello
        if kind == "exec":
            conn.set_peer(kind=wire.K_EXEC)
            with self._pending_workers_lock:
                w = self._pending_workers.pop(token, None)
            if w is None:
                conn.close()
                return
            w.attach_conn(conn)
        elif kind == "node":
            conn.set_peer(kind=wire.K_NODE)
            self._serve_node(conn)
        else:
            hint = self.admission.reject_dial(self._pending_count)
            if hint is not None:
                # Severe overload (depth past the dial-reject
                # factor): turn the NEW client away with a busy hint
                # instead of adding another reader thread — the wire
                # layer records the hint and the client's next dial
                # honors it. Exec/node channels above are never
                # turned away (workers finishing tasks is how the
                # queue drains).
                conn.send_busy(hint)
                conn.close()
                return
            self._serve_client(conn)

    # Submit-class ops the admission gate may answer ST_BUSY (serve's
    # 503 semantics on the task/actor/PG planes). OP_SUBMIT_ACTOR_OWNED
    # is deliberately absent: per-caller actor-call ORDER is part of
    # the actor contract, and shedding call N while admitting N+1
    # would invert it — clients pace those from the busy hint instead.
    _SHEDDABLE_OPS = (P.OP_SUBMIT, P.OP_SUBMIT_OWNED,
                      P.OP_CREATE_ACTOR, P.OP_SUBMIT_ACTOR,
                      P.OP_PG_CREATE)

    def _serve_client(self, conn) -> None:
        send_lock = threading.Lock()
        client_key = f"client-{next(self._client_key_seq)}"

        def reply(req_id, status, payload):
            try:
                with send_lock:
                    conn.send((req_id, status, payload))
            except (OSError, BrokenPipeError):
                pass

        def try_shed(req_id, op) -> bool:
            # Admission gate, checked BEFORE dd bookkeeping (a shed
            # op was never applied, so its eventual replay must not
            # hit a cached result). req_id -1 has no reply path to
            # carry ST_BUSY down — admit those (they are rare:
            # notifies, not submits).
            if req_id == -1 or op not in self._SHEDDABLE_OPS:
                return False
            hint = self.admission.check(self._pending_count,
                                        client_key, op)
            if hint is None:
                return False
            reply(req_id, P.ST_BUSY, (hint, self._pending_count))
            return True

        def handle(req_id, op, payload):
            dd, payload = P.unwrap_dd(payload)
            if dd is not None:
                cached = self._dd_begin(dd)
                if cached is not None:
                    reply(req_id, *cached)
                    return
            try:
                out = (P.ST_OK, self._handle_client_op(
                    op, payload, client_key=client_key))
            except BaseException as e:  # noqa: BLE001
                out = (P.ST_ERR, ser.dumps(e))
            if dd is not None:
                self._dd_finish(dd, out)
            reply(req_id, *out)

        # Live borrows owed by THIS connection: when the peer dies
        # (crash, SIGTERM, OOM kill) its release finalizers never run,
        # so the residual counts are released here on disconnect —
        # otherwise every killed worker would pin its borrowed
        # objects for the life of the session.
        conn_borrows: dict = {}
        # Direct puts this connection started but hasn't committed:
        # aborted on disconnect so a crashed worker can't leak
        # reserved arena slots.
        conn_direct: set = set()
        # Profile registration owed by THIS connection (a worker that
        # announced it executes SRV_REQ profile upcalls): dropped on
        # disconnect so captures never wait on a dead process.
        profile_peer = [None]

        def do_profile_notify(payload) -> None:
            try:
                action = payload[0]
                if action == "register":
                    if profile_peer[0] is None:
                        profile_peer[0] = self._profile_register(
                            payload[1],
                            lambda token, op, args: reply(
                                -1, P.SRV_REQ, (token, op, args)))
                elif action == "result":
                    self._on_profile_result(payload[1], payload[2])
            except Exception:  # noqa: BLE001 — a malformed frame
                pass           # must not kill the reader

        def record_conn_borrow(oid: ObjectID) -> None:
            # Implicit borrow taken during an owned submit (the head
            # registers the client's copy itself — one wire message
            # instead of submit + borrow-add): still owed by THIS
            # connection, so disconnect cleanup releases it.
            conn_borrows[oid] = conn_borrows.get(oid, 0) + 1

        def do_borrow(req_id, payload):
            try:
                if isinstance(payload, tuple):
                    action, oid_bytes, *rest = payload
                else:
                    action, oid_bytes, rest = "escape", payload, ()
                nonce = rest[0] if rest else None
                oid = ObjectID(oid_bytes)
                if action == "add":
                    conn_borrows[oid] = conn_borrows.get(oid, 0) + 1
                    self.on_borrow_add(oid, nonce)
                elif action == "release":
                    if conn_borrows.get(oid, 0) > 0:
                        conn_borrows[oid] -= 1
                    self.on_borrow_release(oid)
                else:
                    self.on_ref_escaped(oid, nonce)
                if req_id != -1:
                    reply(req_id, P.ST_OK, None)
            except BaseException as e:  # noqa: BLE001
                if req_id != -1:
                    reply(req_id, P.ST_ERR, ser.dumps(e))
        def handle_one(req_id, op, payload):
            self._count_client_op(op)
            if op == P.OP_DIRECT and req_id == -1:
                # Fire-and-forget direct-call listener announcement.
                try:
                    if payload and payload[0] == "register":
                        self._direct_register(payload[1])
                except Exception:  # noqa: BLE001 — malformed frame
                    pass           # must not kill the reader
                return
            if op == P.OP_PUT_DIRECT:
                dd, dp = P.unwrap_dd(payload)
                if dd is not None:
                    cached = self._dd_begin(dd)
                    if cached is not None:
                        reply(req_id, *cached)
                        return
                try:
                    out = (P.ST_OK, self._handle_direct_put(
                        dp, conn_direct))
                except BaseException as e:  # noqa: BLE001
                    out = (P.ST_ERR, ser.dumps(e))
                if dd is not None:
                    self._dd_finish(dd, out)
                reply(req_id, *out)
                return
            if op in (P.OP_SUBMIT_OWNED,
                      P.OP_SUBMIT_ACTOR_OWNED):
                # Ownership-model submits (reference: owner-minted
                # object ids; the submit RPC is off the caller's
                # critical path). Fire-and-forget, handled INLINE:
                # a later get on this connection cannot overtake
                # the registration, and per-caller actor-call
                # ORDER (part of the actor contract) follows
                # connection order. Failures land as errors ON
                # the preminted return ids.
                if try_shed(req_id, op):
                    return
                handler = (self._handle_owned_submit
                           if op == P.OP_SUBMIT_OWNED
                           else self._handle_owned_actor_submit)
                dd, sp = P.unwrap_dd(payload)
                if dd is None or self._dd_begin(dd) is None:
                    handler(sp, on_borrowed=record_conn_borrow,
                            client_key=client_key)
                    if dd is not None:
                        self._dd_finish(dd, (P.ST_OK, None))
                if req_id != -1:
                    reply(req_id, P.ST_OK, None)
                return
            if op == P.OP_BORROW:
                # Order-sensitive per connection: handle inline
                # (a thread-per-message race could run a release
                # before its add and free a live object). No
                # reply for fire-and-forget req_id -1.
                do_borrow(req_id, payload)
                return
            if op == P.OP_NOTIFY_BATCH:
                # Coalesced fire-and-forget notifies: same inline
                # ordering guarantee, one reader wakeup for the
                # whole burst.
                for sub_op, sub_payload in payload:
                    self._count_client_op(sub_op)
                    if sub_op == P.OP_BORROW:
                        do_borrow(-1, sub_payload)
                    elif sub_op == P.OP_DIRECT:
                        try:
                            if sub_payload and \
                                    sub_payload[0] == "register":
                                self._direct_register(sub_payload[1])
                        except Exception:  # noqa: BLE001
                            pass
                    elif sub_op == P.OP_METRICS_PUSH:
                        try:
                            self.observability.ingest_push(
                                sub_payload)
                        except Exception:  # noqa: BLE001 — a bad
                            pass           # frame must not kill the
                                           # connection's reader
                    elif sub_op == P.OP_PROFILE:
                        do_profile_notify(sub_payload)
                return
            if op == P.OP_METRICS_PUSH and req_id == -1:
                # Fire-and-forget exporter flush that arrived solo
                # (unbatched notify): ingest without a reply frame.
                try:
                    self.observability.ingest_push(payload)
                except Exception:  # noqa: BLE001
                    pass
                return
            if op == P.OP_PROFILE and req_id == -1:
                # Fire-and-forget profile plumbing (register/result);
                # blocking capture requests fall through to the pool.
                do_profile_notify(payload)
                return
            if try_shed(req_id, op):
                return
            self._client_op_pool.submit(handle, req_id, op, payload)

        def handle_submit_run(subs) -> None:
            """A CONSECUTIVE run of OP_SUBMIT_OWNED triples from one
            REQ_BATCH: dd bookkeeping stays per-item; the survivors
            register through the batch transaction (one lock pass,
            one dispatcher wakeup). Replies (rare — submits are
            fire-and-forget) are sent after the transaction, which a
            later get on this connection cannot overtake because the
            reader thread is still here."""
            to_run: list = []
            dds: list = []
            acks: list = []
            for req_id, _op, payload in subs:
                self._count_client_op(_op)
                if try_shed(req_id, _op):
                    # Shed BEFORE dd bookkeeping: the client re-sends
                    # the same dd-tagged op after its backoff and it
                    # must apply then, not hit a cached no-op.
                    continue
                if req_id != -1:
                    acks.append(req_id)
                dd, sp = P.unwrap_dd(payload)
                if dd is not None and self._dd_begin(dd) is not None:
                    dd = None          # replayed: cached, skip run
                    sp = None
                if sp is not None:
                    to_run.append(sp)
                    dds.append(dd)
            if to_run:
                if len(to_run) == 1 or self.local_mode:
                    # local_mode has no dispatcher thread — only
                    # submit_task's _execute_local branch (reached
                    # via the scalar handler) runs the task.
                    for sp in to_run:
                        self._handle_owned_submit(
                            sp, on_borrowed=record_conn_borrow,
                            client_key=client_key)
                else:
                    self._handle_owned_submit_many(
                        to_run, on_borrowed=record_conn_borrow,
                        client_key=client_key)
                for dd in dds:
                    if dd is not None:
                        self._dd_finish(dd, (P.ST_OK, None))
            for req_id in acks:
                reply(req_id, P.ST_OK, None)

        try:
            while True:
                req_id, op, payload = conn.recv()
                if op == P.OP_REQ_BATCH:
                    # Coalesced requests from the client's outbox:
                    # processed strictly in order, exactly as if each
                    # triple had arrived as its own message —
                    # consecutive owned submits additionally share
                    # one registration transaction.
                    run: list = []
                    for sub in payload:
                        if sub[1] == P.OP_SUBMIT_OWNED:
                            run.append(sub)
                            continue
                        if run:
                            handle_submit_run(run)
                            run = []
                        handle_one(*sub)
                    if run:
                        handle_submit_run(run)
                    continue
                handle_one(req_id, op, payload)
        except (EOFError, OSError):
            pass
        finally:
            for oid_bytes in conn_direct:
                # Do NOT free immediately: a client whose connection
                # dropped may still be memcpying through its mapped
                # view — freeing now could hand the extent to another
                # put mid-write (cross-object corruption). Orphans
                # are reaped after a grace window (or committed by a
                # dd-replayed commit on reconnect).
                self._orphan_direct[oid_bytes] = time.monotonic()
            for oid, count in conn_borrows.items():
                for _ in range(count):
                    try:
                        self.on_borrow_release(oid)
                    except Exception:  # noqa: BLE001
                        pass
            self._profile_unregister(profile_peer[0])

    # ---------------- node daemon channel (raylet link) ---------------

    def _node_map_rows(self) -> list[tuple]:
        from ray_tpu_torch.core.ids import owner_tag_of
        return [(n.node_id, owner_tag_of(n.node_id).hex(),
                 n.object_addr)
                for n in self._nodes.values()
                if n.alive and n.is_daemon]

    def _broadcast_node_map(self) -> None:
        """Push the owner routing table to every daemon (and the
        pubsub topic for other subscribers) on membership change —
        the decentralized-resource-view seam (reference: ray_syncer
        versioned snapshots, ray_syncer.h:88; scope-reduced to the
        node/owner map daemons need for ownership routing)."""
        rows = self._node_map_rows()
        try:
            self.pubsub_publish("__cluster_nodes__", ser.dumps(rows))
        except Exception:  # noqa: BLE001
            pass
        for n in list(self._nodes.values()):
            if n.alive and n.is_daemon and n.conn is not None:
                try:
                    n.node_send((P.ND_NODEMAP, rows))
                except Exception:  # noqa: BLE001
                    pass
        # Seed the resource view alongside membership changes so a
        # fresh daemon can serve resource queries locally right away
        # instead of waiting out the first sync period.
        self._rview_broadcast(force=True)

    def _ensure_health_thread(self) -> None:
        """Active daemon health checking (reference:
        GcsHealthCheckManager, gcs_health_check_manager.h:39 — the
        GCS pings every raylet; EOF-only detection misses wedged
        processes: SIGSTOP, half-open TCP). A node that misses
        ``health_check_failure_threshold`` periods gets its channel
        closed, which drives the ordinary node-death failover."""
        with self._pool_lock:
            if getattr(self, "_health_thread", None) is not None:
                return
            self._health_thread = threading.Thread(
                target=self._health_loop, daemon=True,
                name="node_health")
            self._rview_thread = threading.Thread(
                target=self._rview_loop, daemon=True,
                name="rview_sync")
        self._health_thread.start()
        self._rview_thread.start()

    def _safe_ping(self, node: NodeRecord) -> None:
        try:
            node.node_send((P.ND_PING,))
        except Exception:  # noqa: BLE001
            pass           # send failure surfaces via the serve loop
        finally:
            node.ping_inflight = False

    def _health_loop(self) -> None:
        period = self.config.health_check_period_s
        thresh = self.config.health_check_failure_threshold
        while not self._shutdown:
            t0 = time.monotonic()
            time.sleep(period)
            # Head loop lag: how late this thread woke vs. what it
            # asked for. Under head saturation (GIL contention from a
            # task storm) EVERY deadline in this process slips by
            # about this much — the daemons pong'd on time, WE
            # processed late — so the liveness deadline stretches
            # with it instead of declaring false-positive deaths
            # (same shape as the PR 9 load-gated chaos fixtures).
            overshoot = max(0.0, (time.monotonic() - t0) - period)
            self._head_loop_lag_s = (0.7 * self._head_loop_lag_s
                                     + 0.3 * overshoot)
            lag_allowance = thresh * self._head_loop_lag_s
            try:
                self.admission.export_gauges(self._pending_count,
                                             self._head_loop_lag_s)
            except Exception:  # noqa: BLE001 — gauges must never
                pass           # kill the health checker
            now = time.monotonic()
            for node in list(self._nodes.values()):
                if not (node.alive and node.is_daemon):
                    continue
                if now - node.last_pong > period * thresh \
                        + lag_allowance:
                    print(f"ray_tpu_torch: node {node.node_id} missed "
                          f"{thresh} health checks — declaring it "
                          f"dead", flush=True)
                    node.last_pong = now   # one declaration only
                    # shutdown(SHUT_RDWR), not close(): closing an fd
                    # does NOT wake a thread blocked in recv on it;
                    # shutdown does, and the serve loop's EOF handler
                    # then runs the single node-death failover path.
                    try:
                        import socket as _s
                        sd = _s.fromfd(node.conn.fileno(), _s.AF_INET,
                                       _s.SOCK_STREAM)
                        try:
                            sd.shutdown(_s.SHUT_RDWR)
                        finally:
                            sd.close()
                    except Exception:  # noqa: BLE001
                        pass
                    continue
                if not node.ping_inflight:
                    # Own thread per ping: a wedged daemon's full
                    # socket must not block the checker itself.
                    node.ping_inflight = True
                    threading.Thread(target=self._safe_ping,
                                     args=(node,),
                                     daemon=True).start()

    def _signals_loop(self) -> None:
        """Head signals cadence: one SignalStore sample + SLO
        evaluation per ``signals_sample_interval_s``. Reads the
        plane's live-tunable interval each lap so tests can crank the
        cadence on a running head."""
        while not self._shutdown:
            time.sleep(max(0.05,
                           self.observability.signals_interval))
            try:
                self.observability.signals_tick(force=True)
            except Exception:  # noqa: BLE001 — sampling must never
                pass           # kill the loop

    # ---------------- resource-view sync (ray_syncer analog) ----------

    def _rview_snapshot(self) -> dict:
        with self._res_cv:
            return {
                n.node_id: {
                    "alive": n.alive,
                    "total": dict(n.resources),
                    "avail": dict(n.avail),
                    "observed": dict(n.observed),
                }
                for n in self._nodes.values() if n.alive
            }

    def _rview_broadcast(self, force: bool = False) -> None:
        """Snapshot + version + send, atomically vs other callers.
        ``force`` skips delta suppression (membership seeds must
        reach a just-registered daemon even if the totals happen to
        match the previous snapshot)."""
        with self._rview_lock:
            try:
                view = self._rview_snapshot()
            except Exception:  # noqa: BLE001
                return
            if not force and view == self._rview_last:
                return
            self._rview_last = view
            self._rview_version += 1
            self._rview_broadcasts += 1
            msg = (P.ND_RVIEW, self._rview_version, view)
            for node in list(self._nodes.values()):
                if node.alive and node.is_daemon \
                        and node.conn is not None:
                    # Per-node: one dead connection must not abort
                    # seeding for the daemons after it.
                    try:
                        node.node_send(msg)
                    except Exception:  # noqa: BLE001
                        pass

    def _rview_loop(self) -> None:
        """Versioned cluster-resource broadcast (reference: RaySyncer
        bidirectional versioned streams, ray_syncer.h:88 — scoped to
        a hub-and-spoke topology since the head is the allocator).
        Daemons serve resource queries from the received view with no
        head round trip; unchanged snapshots are suppressed."""
        period = self.config.rview_period_s
        while not self._shutdown:
            time.sleep(period)
            self._rview_broadcast()

    def _serve_node(self, conn) -> None:
        """Serve one node daemon's control channel for its lifetime.
        EOF (daemon crash/SIGKILL) is node death: fail over workers,
        lose node-homed objects, re-home PG bundles (reference:
        GcsNodeManager::OnNodeFailure, gcs_node_manager.cc:408)."""
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        if not (isinstance(msg, tuple) and msg[0] == P.ND_REGISTER):
            conn.close()
            return
        info = msg[1] or {}
        resources = dict(info.get("resources") or {"CPU": 1.0})
        prior_id = info.get("node_id") or ""
        with self._res_cv:
            try:
                node_id = self._add_node_locked_free(
                    resources, info.get("labels"), node_id=prior_id,
                    gpu_ids=self._daemon_cards(resources,
                                               info.get("gpu_ids")),
                    hostname=str(info.get("hostname", "")) or "?")
            except ValueError as e:
                refused = str(e)
            else:
                refused = ""
        if refused:
            print(f"ray_tpu_torch: refused a node daemon: {refused}",
                  flush=True)
            try:
                conn.send(("refused", refused))
            except (OSError, BrokenPipeError):
                pass
            conn.close()
            return
        with self._res_cv:
            node = self._nodes[node_id]
            node.alive = True
            node.conn = conn
            node.send_lock = threading.Lock()
            node.pid = int(info.get("pid", 0))
            node.hostname = str(info.get("hostname", ""))
            node.object_addr = info.get("object_addr")
            node.last_pong = time.monotonic()
            node.ping_inflight = False
            self._rehome_bundles_locked()
            self._res_cv.notify_all()
        # A (re)registered node is a live scrape target again.
        self.observability.mark_node_live(node_id)
        if hasattr(conn, "set_peer"):
            conn.set_peer(peer=f"node {node_id[:12]}",
                          peer_node=node_id)
            conn.crosses_nodes = True
        self._ensure_health_thread()
        try:
            # The registration ack MUST be the first message on the
            # channel — adoption below may emit ND_WKILL, which would
            # otherwise arrive inside the daemon's handshake recv.
            node.node_send(("registered", node_id))
            self._broadcast_node_map()
            # Re-registration after a head restart: rebuild the
            # directory entries for objects the daemon still stores
            # and re-adopt its surviving workers/actors (raylet
            # resync after NotifyGCSRestart, node_manager.proto:383).
            for ent in info.get("objects", []):
                if isinstance(ent, tuple):
                    oid_bytes, size, refs = ent
                else:      # legacy bare-oid report
                    oid_bytes, size, refs = ent, 0, []
                self._store_remote(ObjectID(oid_bytes), node_id,
                                   size, refs)
            for went in info.get("workers", []):
                widx, is_actor, actor_id_bytes, env_key = went
                try:
                    self._adopt_worker(node, int(widx),
                                       bool(is_actor),
                                       actor_id_bytes, env_key or "")
                except Exception:  # noqa: BLE001
                    traceback.print_exc()
            while True:
                msg = conn.recv()
                kind = msg[0]
                # ANY frame proves the round trip (daemon send path +
                # our recv path), not just an explicit pong — a busy
                # channel must never be declared dead for answering
                # pings late behind bulk traffic.
                node.last_pong = time.monotonic()
                if kind == P.ND_PONG:
                    pass
                elif kind == P.ND_RSYNC:
                    _, version, report = msg
                    # Stale reports (reordered behind a reconnect)
                    # must not regress the view (reference: syncer
                    # version checks).
                    if version > node.report_version:
                        node.report_version = version
                        node.observed = dict(report)
                elif kind == P.ND_WMSG:
                    _, widx, wmsg = msg
                    w = self._remote_workers.get(widx)
                    if w is not None:
                        try:
                            self._on_worker_message(w, wmsg)
                        except Exception:  # noqa: BLE001
                            traceback.print_exc()
                elif kind == P.ND_WEXIT:
                    _, widx, rc = msg
                    w = self._remote_workers.pop(widx, None)
                    if w is not None and not w.dead:
                        w.dead = True
                        w.proc.returncode = rc if rc is not None else -1
                        try:
                            self._on_worker_exit(w)
                        except Exception:  # noqa: BLE001
                            traceback.print_exc()
                elif kind == P.ND_STORED:
                    _, widx, task_id_bytes, entries = msg
                    w = self._remote_workers.get(widx)
                    if w is None:
                        continue
                    task_id = TaskID(task_id_bytes)
                    try:
                        if w.is_actor:
                            self._finish_actor_task(
                                w, task_id, None, None, entries=entries)
                        else:
                            self._finish_task(
                                w, task_id, None, None, entries=entries)
                    except Exception:  # noqa: BLE001
                        traceback.print_exc()
                elif kind == P.ND_REPLY:
                    _, fid, status, payload = msg
                    with self._node_calls_lock:
                        entry = self._node_calls.pop(fid, None)
                    if entry is not None:
                        event, slot, _nid = entry
                        slot.append((status, payload))
                        event.set()
                elif kind == P.ND_DRAIN:
                    # The daemon saw a termination notice (SIGTERM /
                    # preemption metadata): drain on its behalf, then
                    # terminate it — remove_node's ND_SHUTDOWN is the
                    # "drain complete, you may exit" ack.
                    _, reason, deadline_s = msg
                    threading.Thread(
                        target=self.drain_node, args=(node_id,),
                        kwargs={"reason": reason,
                                "deadline_s": deadline_s,
                                "remove": True},
                        daemon=True,
                        name=f"drain_{node_id[:12]}").start()
                elif kind == P.ND_UPCALL:
                    _, fid, op, payload = msg
                    threading.Thread(
                        target=self._handle_node_upcall,
                        args=(node, fid, op, payload),
                        daemon=True).start()
        except (EOFError, OSError):
            pass
        finally:
            self._on_node_disconnect(node_id)

    def _handle_node_upcall(self, node: NodeRecord, fid: int, op: str,
                            payload) -> None:
        try:
            if op == "agent_report":
                # Per-node agent stats (reference: reporter module →
                # dashboard head aggregation).
                payload = dict(payload or {})
                payload["node_id"] = node.node_id
                self._agent_stats[node.node_id] = payload
                result = None
            elif op == "metrics_push":
                # The daemon's own exporter flush (its process-local
                # registry + events), attributed to its node.
                self.observability.ingest_push(
                    payload, node_id_hint=node.node_id)
                result = None
            elif op == "put_loc_at":
                oid_bytes, size, refs, *pn = payload
                oid = ObjectID(oid_bytes)
                self._store_remote(oid, node.node_id, size, refs)
                self.on_ref_escaped(oid, pn[0] if pn else None)
                result = None
            elif op == "locate":
                # Directory lookup for a daemon's p2p pull: where does
                # this object live right now? ("node", id, obj_addr)
                # lets the asker pull straight from the holder;
                # ("head",) means the head itself serves it;
                # ("pending",) tells the asker to re-poll (bounded
                # wait keeps the upcall thread from parking forever).
                oid_bytes, timeout = payload
                self.locate_calls += 1
                deadline = (None if timeout is None
                            else time.monotonic() + timeout)
                try:
                    loc = self._wait_location(ObjectID(oid_bytes),
                                              deadline)
                except GetTimeoutError:
                    result = ("pending",)
                else:
                    if isinstance(loc, tuple):
                        holder = self._nodes.get(loc[1])
                        if (holder is not None and holder.alive
                                and holder.object_addr):
                            result = ("node", loc[1],
                                      tuple(holder.object_addr))
                        else:
                            result = ("head",)
                    else:
                        result = ("head",)
            elif op == "cache_loc":
                # A daemon cached a p2p-pulled copy. Record the
                # replica — unless the object is already gone, in
                # which case the daemon must drop the copy (it raced
                # the delete).
                oid = ObjectID(payload)
                with self._obj_cv:
                    loc = self._obj_locations.get(oid)
                    if (isinstance(loc, tuple)
                            and loc[1] != node.node_id):
                        self._obj_replicas.setdefault(
                            oid, set()).add(node.node_id)
                        result = "ok"
                    elif isinstance(loc, tuple):
                        # The asker became the PRIMARY between its
                        # pull and this upcall (lineage re-ran the
                        # producer there, or a promotion landed):
                        # it must keep the copy — deleting would
                        # orphan the directory entry.
                        result = "primary"
                    else:
                        result = "stale"
            else:
                raise ValueError(f"unknown node upcall {op!r}")
            status, out = P.ST_OK, result
        except BaseException as e:  # noqa: BLE001
            status, out = P.ST_ERR, ser.dumps(e)
        if fid == -1:
            return
        try:
            node.node_send((P.ND_UPREPLY, fid, status, out))
        except (OSError, BrokenPipeError):
            pass

    def _node_call(self, node: NodeRecord, op: str, payload,
                   timeout: float | None = 60.0):
        """Request/response over a node daemon channel (fetch/chunk/
        free). Replies are demuxed by fid in _serve_node."""
        fid = next(self._node_fid)
        event = threading.Event()
        slot: list = []
        with self._node_calls_lock:
            self._node_calls[fid] = (event, slot, node.node_id)
        try:
            node.node_send((P.ND_CALL, fid, op, payload))
        except (OSError, BrokenPipeError) as e:
            with self._node_calls_lock:
                self._node_calls.pop(fid, None)
            raise ObjectLostError(
                f"node {node.node_id} unreachable") from e
        if not event.wait(timeout):
            with self._node_calls_lock:
                self._node_calls.pop(fid, None)
            raise GetTimeoutError(
                f"node {node.node_id} op {op} timed out")
        status, result = slot[0]
        if status == P.ST_ERR:
            raise ser.loads(result)
        return result

    def _on_node_disconnect(self, node_id: str) -> None:
        if self._shutdown:
            return
        # Fail any in-flight node calls against this node.
        with self._node_calls_lock:
            stale = [fid for fid, (_e, _s, nid)
                     in self._node_calls.items() if nid == node_id]
            for fid in stale:
                event, slot, _nid = self._node_calls.pop(fid)
                slot.append((P.ST_ERR, ser.dumps(ObjectLostError(
                    f"node {node_id} disconnected"))))
                event.set()
        self._agent_stats.pop(node_id, None)
        self._handle_node_death(node_id)

    def _fetch_from_node(self, node_id: str, oid: ObjectID,
                         deadline: float | None) -> SerializedObject:
        """Pull one node-homed object over the daemon channel's chunk
        plane (ObjectManager pull analog, object_manager.h:117)."""
        node = self._nodes.get(node_id)
        if node is None or not node.alive or not node.is_daemon:
            raise ObjectLostError(oid.hex())
        def remaining() -> float | None:
            if deadline is None:
                return None
            left = deadline - time.monotonic()
            if left <= 0:
                raise GetTimeoutError(oid.hex())
            return left

        meta = self._node_call(node, "fetch", oid.binary(),
                               remaining())
        if meta[0] == "inline":
            return SerializedObject(data=meta[1],
                                    buffers=list(meta[2]))

        def fetch_chunk(tid, i):
            piece = self._node_call(node, "chunk", (tid, i),
                                    remaining())
            self._relay_chunks += 1
            return piece

        # The node channel is fid-demuxed, so up to ``window`` chunk
        # requests ride it concurrently (request k+1..k+W while
        # assembling chunk k).
        return ser.reassemble_chunked(
            meta, fetch_chunk,
            lambda tid: node.node_send((P.ND_CALL, -1, "end", tid)),
            window=max(1, self.config.object_transfer_window))

    def _store_remote(self, oid: ObjectID, node_id: str, size: int,
                      refs) -> None:
        """Directory entry for an object living in a node daemon's
        local store (reference: ownership_based_object_directory.cc).
        refs: [(ref_id_bytes, nonce)] nested inside the stored value —
        container-pinned exactly like locally stored objects."""
        with self._obj_cv:
            existing = self._obj_locations.get(oid)
            if (isinstance(existing, tuple) and existing[1] != node_id
                    and self._nodes.get(existing[1]) is not None
                    and self._nodes[existing[1]].alive):
                # Another live node already homes this object (e.g.
                # both the primary and a p2p-replica holder re-report
                # after a head restart): record a replica, don't
                # re-pin or flip the primary.
                self._obj_replicas.setdefault(oid, set()).add(node_id)
                return
        if refs:
            shim = SerializedObject(
                data=b"", buffers=[],
                contained_refs=[(ObjectID(b), n) for b, n in refs])
            self._register_contained_refs(oid, shim)
        with self._obj_cv:
            self._obj_locations[oid] = ("node", node_id)
            self._obj_sizes[oid] = int(size or 0)
            self._node_objects.setdefault(node_id, set()).add(oid)
            self._obj_cv.notify_all()
        with self._res_cv:
            self._res_cv.notify_all()

    # ---- direct (same-host, plasma-style) puts -----------------------
    # A worker that can map the arena writes object bytes itself; the
    # head only assigns the id, runs the spill check, and records the
    # directory entry at commit (reference: plasma clients write shm
    # directly; the store only manages allocation/sealing).

    def direct_put_start(self, total: int, refs) -> tuple | None:
        from ray_tpu_torch.core.object_store import NativeSharedMemoryStore
        store = self.shm_store
        if not isinstance(store, NativeSharedMemoryStore):
            return None
        if total < self.config.max_direct_call_object_size:
            return None               # small objects: memory store
        self._reap_orphan_direct()
        oid = ObjectID.for_put(next(self._put_counter))
        store.direct_prepare(total)
        self._pending_direct[oid] = (total, list(refs or ()))
        return (oid.binary(), store.name)

    _ORPHAN_DIRECT_GRACE_S = 60.0

    def _reap_orphan_direct(self) -> None:
        """Free slots of direct puts whose writer disconnected more
        than a grace window ago and never committed (lazy — runs on
        each new direct-put start)."""
        now = time.monotonic()
        for oid_bytes, ts in list(self._orphan_direct.items()):
            oid = ObjectID(oid_bytes)
            if oid not in self._pending_direct:
                # Committed after reconnect (dd replay) or already
                # aborted: nothing to free.
                self._orphan_direct.pop(oid_bytes, None)
                continue
            if now - ts > self._ORPHAN_DIRECT_GRACE_S:
                self._orphan_direct.pop(oid_bytes, None)
                try:
                    self.direct_put_abort(oid_bytes)
                except Exception:  # noqa: BLE001
                    pass

    def direct_put_commit(self, oid_bytes: bytes,
                          nonce: str | None = None) -> bytes:
        oid = ObjectID(oid_bytes)
        entry = self._pending_direct.pop(oid, None)
        if entry is None:
            # Unknown/aborted/duplicate commit (e.g. a replay after
            # the disconnect cleanup freed the slot): fail closed —
            # fabricating success would register a location whose
            # bytes are gone.
            raise KeyError(
                f"no in-flight direct put for {oid.hex()}")
        total, refs = entry
        self.shm_store.direct_seal(oid, total)
        if refs:
            shim = SerializedObject(
                data=b"", buffers=[],
                contained_refs=[(ObjectID(b), n) for b, n in refs])
            self._register_contained_refs(oid, shim)
        with self._obj_cv:
            self._obj_locations[oid] = "shm"
            self._obj_sizes[oid] = int(total)
            self._obj_cv.notify_all()
        self.on_ref_escaped(oid, nonce)
        with self._res_cv:
            self._res_cv.notify_all()
        return oid_bytes

    def direct_put_abort(self, oid_bytes: bytes) -> None:
        oid = ObjectID(oid_bytes)
        if self._pending_direct.pop(oid, None) is None:
            # Not in flight: either already aborted, or the commit
            # actually executed server-side and only the client's view
            # of it failed (reply lost after reconnect-replay gave up,
            # or its event.wait timed out). Deleting here would tear
            # committed — and possibly pinned — bytes out from under
            # the directory entry (advisor r3).
            return
        self.shm_store.delete(oid)

    def _handle_owned_submit(self, payload, on_borrowed=None,
                             client_key: str = "") -> None:
        """Register a client-minted task. Any failure — bad env, bad
        pickle, unknown options — is stored as the error of every
        preminted return id: the client already returned refs to its
        caller and will observe the failure at get().

        ``on_borrowed``: the head registers the client's borrow of
        each return ref AT SUBMISSION (escape pin taken and consumed
        in one step) instead of waiting for a separate borrow-add
        notify — one wire message per task saved; the callback lets
        the serving connection record the borrow for disconnect
        cleanup."""
        (fn_id, fn_blob, fn_name, args_kwargs_blob, opts_blob,
         tid_bytes, rid_bytes, nonces) = payload
        return_ids = [ObjectID(b) for b in rid_bytes]
        with self._task_lock:
            if TaskID(tid_bytes) in self._tasks:
                # dd-evicted replay of a live task: the original
                # execution took the nonce pins; re-pinning here would
                # leak them forever (the client's borrow registration
                # consumed each nonce exactly once). Per-client ids +
                # per-connection inline handling make this the only
                # duplicate source.
                return
        try:
            from ray_tpu_torch.core.object_ref import rehydrate_stats
            c0 = rehydrate_stats.count
            args, kwargs = ser.loads(args_kwargs_blob)
            # Ref-free blob (no rehydrations during loads): reuse the
            # client's encoding verbatim — skips a full re-pickle per
            # submit. Ref-carrying blobs must be re-encoded (one-shot
            # nonces per hop).
            packed = ((args_kwargs_blob, [])
                      if rehydrate_stats.count == c0 else None)
            options = self._loads_options_cached(opts_blob)
            if options.num_returns == "streaming":
                # No preminted ids can carry generator state, and the
                # pin loop below would otherwise ITERATE the returned
                # ObjectRefGenerator (blocking this reader thread on
                # stream_next). The in-repo client routes streaming
                # via the synchronous submit op.
                raise RuntimeError(
                    "streaming returns cannot use the owned submit "
                    "op; use the synchronous submit")
            refs = self.submit_task(
                fn_id, fn_blob, fn_name, args, kwargs, options,
                preminted=(TaskID(tid_bytes), return_ids),
                packed=packed, client_key=client_key)
            # The remote client holds the only refs. The escape pin
            # and its consuming borrow-add are registered HERE in one
            # step (the client registers only the release finalizer):
            # same lifecycle as before, minus one notify per task.
            for r, nonce in zip(refs, nonces):
                self.on_ref_escaped(r.id, nonce)
                self.on_borrow_add(r.id, nonce)
                if on_borrowed is not None:
                    on_borrowed(r.id)
        except BaseException as e:  # noqa: BLE001
            err = e if isinstance(e, Exception) else \
                RuntimeError(repr(e))
            blob = ser.dumps(err)
            for oid in return_ids:
                self._store_error(oid, blob)

    def _handle_owned_submit_many(self, payloads: list,
                                  on_borrowed=None,
                                  client_key: str = "") -> None:
        """Batch transaction for a RUN of owned submits arriving in
        one client REQ_BATCH frame: per-item decode/record-build with
        per-item error isolation (failures land on that item's
        preminted return ids), then ONE task-lock acquisition
        registering every record and ONE _res_cv acquisition adding
        them all to the pending queue with a single dispatcher
        wakeup. A 50-task storm burst previously paid 50 lock
        round-trips and 50 notify_all context-switch kicks on this
        path. Semantics match per-item _handle_owned_submit exactly
        (connection order preserved — the caller batches only
        CONSECUTIVE submits)."""
        from ray_tpu_torch.core.object_ref import rehydrate_stats
        staged = []                       # (rec, return_ids, nonces)
        for payload in payloads:
            (fn_id, fn_blob, fn_name, args_kwargs_blob, opts_blob,
             tid_bytes, rid_bytes, nonces) = payload
            return_ids = [ObjectID(b) for b in rid_bytes]
            try:
                if fn_blob is not None:
                    self._fn_cache.setdefault(fn_id, fn_blob)
                c0 = rehydrate_stats.count
                args, kwargs = ser.loads(args_kwargs_blob)
                options = self._loads_options_cached(opts_blob)
                if options.num_returns == "streaming":
                    # Streaming returns need head-minted generator
                    # state and have no preminted return ids to carry
                    # them — the in-repo client routes them via the
                    # synchronous OP_SUBMIT; an owned streaming
                    # submit is a protocol error, stored as such.
                    raise RuntimeError(
                        "streaming returns cannot use the owned "
                        "submit op; use the synchronous submit")
                if rehydrate_stats.count == c0:
                    args_blob, arg_refs = args_kwargs_blob, []
                else:
                    args_blob, arg_refs = self._pack_args(args,
                                                          kwargs)
                env_key, env_vars = self._env_for_options_cached(
                    options)
                rec = TaskRecord(
                    task_id=TaskID(tid_bytes), fn_id=fn_id,
                    name=fn_name or "task", args_blob=args_blob,
                    arg_refs=arg_refs, options=options,
                    return_ids=return_ids,
                    submitted_at=time.time(),
                    env_key=env_key, env_vars=env_vars,
                    client_key=client_key)
                # Anything _pending_add_locked derives (scheduling
                # class, effective resources) is derived HERE, inside
                # this item's isolation, so a malformed options dict
                # (e.g. unsortable mixed-type resource keys) fails as
                # THIS item's error instead of blowing up later while
                # holding _res_cv. Same options-level cache as
                # _pending_add_locked.
                cache = getattr(options, "_sched_cache", None)
                if cache is None:
                    need = self._effective_resources(options)
                    cache = (need, self._sched_class(need, options))
                    options._sched_cache = cache
                rec.need, rec.sched_class = cache
                staged.append((rec, return_ids, nonces))
            except BaseException as e:  # noqa: BLE001
                err = e if isinstance(e, Exception) else \
                    RuntimeError(repr(e))
                blob = ser.dumps(err)
                for oid in return_ids:
                    self._store_error(oid, blob)
        if not staged:
            return
        fresh = []
        with self._task_lock:
            for rec, return_ids, nonces in staged:
                if rec.task_id in self._tasks:
                    continue              # dd-evicted replay
                self._tasks[rec.task_id] = rec
                fresh.append((rec, return_ids, nonces))

        def fail_item(rec, return_ids, e) -> None:
            # Per-item isolation through the bulk phases: mirror the
            # scalar path (error stored on the item's return ids) and
            # un-register so a dd replay can re-run it cleanly.
            with self._task_lock:
                self._tasks.pop(rec.task_id, None)
            blob = ser.dumps(e if isinstance(e, Exception)
                             else RuntimeError(repr(e)))
            for oid in return_ids:
                self._store_error(oid, blob)

        enqueued = []
        for item in fresh:
            rec, return_ids, nonces = item
            try:
                effective_retries = (rec.options.max_retries
                                     if rec.options.max_retries >= 0
                                     else self.config.task_max_retries)
                if (effective_retries > 0
                        and self.config.lineage_cache_max_bytes > 0):
                    self._lineage_put(rec.task_id, LineageRecord(
                        fn_id=rec.fn_id, name=rec.name,
                        args_blob=rec.args_blob,
                        arg_refs=list(rec.arg_refs),
                        options=rec.options,
                        return_ids=list(rec.return_ids),
                        nbytes=len(rec.args_blob) + 256))
                self._event(rec, "PENDING")
                enqueued.append(item)
            except BaseException as e:  # noqa: BLE001
                fail_item(rec, return_ids, e)
        with self._res_cv:
            kept = []
            for item in enqueued:
                try:
                    self._pending_add_locked(item[0])
                    kept.append(item)
                except BaseException as e:  # noqa: BLE001
                    fail_item(item[0], item[1], e)
            self._res_cv.notify_all()
        for rec, return_ids, nonces in kept:
            try:
                # Transient driver-side refs are registered FIRST and
                # kept alive through the escape+borrow registration
                # (their GC release is balanced by register_ref) —
                # same ordering as the scalar path via submit_task's
                # returned refs.
                refs = [self.register_ref(ObjectRef(oid))
                        for oid in return_ids]
                for r, nonce in zip(refs, nonces):
                    self.on_ref_escaped(r.id, nonce)
                    self.on_borrow_add(r.id, nonce)
                    if on_borrowed is not None:
                        on_borrowed(r.id)
            except BaseException as e:  # noqa: BLE001
                fail_item(rec, return_ids, e)

    def _handle_owned_actor_submit(self, payload, on_borrowed=None,
                                   client_key: str = "") -> None:
        """Register a client-minted actor call; failures (dead/unknown
        actor, bad pickle) land as errors on the preminted return ids
        — the caller observes them at get(). ``on_borrowed``: see
        _handle_owned_submit (implicit borrow registration)."""
        (actor_id_bytes, method, args_kwargs_blob, num_returns,
         trace_ctx, tid_bytes, rid_bytes, nonces) = payload
        return_ids = [ObjectID(b) for b in rid_bytes]
        task_id = TaskID(tid_bytes)
        with self._task_lock:
            if task_id in self._actor_owned_seen:
                return          # dd-evicted replay: pins already taken
            self._actor_owned_seen[task_id] = None
            while len(self._actor_owned_seen) > 65536:
                # Bounded memory: evict the OLDEST ids (insertion
                # order), which are far outside any replay window.
                self._actor_owned_seen.popitem(last=False)
        try:
            from ray_tpu_torch.core.object_ref import rehydrate_stats
            c0 = rehydrate_stats.count
            args, kwargs = ser.loads(args_kwargs_blob)
            packed = ((args_kwargs_blob, [])
                      if rehydrate_stats.count == c0 else None)
            refs = self.submit_actor_task(
                ActorID(actor_id_bytes), method, args, kwargs,
                num_returns, trace_ctx,
                preminted=(task_id, return_ids),
                packed=packed)
            for r, nonce in zip(refs, nonces):
                self.on_ref_escaped(r.id, nonce)
                self.on_borrow_add(r.id, nonce)
                if on_borrowed is not None:
                    on_borrowed(r.id)
        except BaseException as e:  # noqa: BLE001
            err = e if isinstance(e, Exception) else \
                RuntimeError(repr(e))
            blob = ser.dumps(err)
            for oid in return_ids:
                self._store_error(oid, blob)

    def _handle_direct_put(self, payload, conn_pending: set):
        action = payload[0]
        if action == "start":
            _a, total, refs = payload
            out = self.direct_put_start(int(total), refs)
            if out is not None:
                conn_pending.add(out[0])
            return out
        if action == "commit":
            conn_pending.discard(payload[1])
            return self.direct_put_commit(
                payload[1], payload[2] if len(payload) > 2 else None)
        conn_pending.discard(payload[1])      # "abort"
        self.direct_put_abort(payload[1])
        return None

    def _dd_begin(self, dd: str):
        """Returns the cached reply for a replayed mutating op, or
        None if this caller should execute it. A replay arriving while
        the original is still executing waits for its result instead
        of re-executing."""
        while True:
            with self._dd_lock:
                hit = self._dd_results.get(dd)
                if hit is not None:
                    return hit
                ev = self._dd_inflight.get(dd)
                if ev is None:
                    self._dd_inflight[dd] = threading.Event()
                    return None
            if not ev.wait(30.0):
                # Original wedged — execute rather than hang the
                # client forever (worst case we double-execute, which
                # is the pre-dedupe behavior).
                return None

    def _dd_finish(self, dd: str, out: tuple) -> None:
        with self._dd_lock:
            self._dd_results[dd] = out
            while len(self._dd_results) > 8192:
                self._dd_results.popitem(last=False)
            ev = self._dd_inflight.pop(dd, None)
        if ev is not None:
            ev.set()

    def _handle_client_op(self, op: str, payload,
                          client_key: str = "driver"):
        if op == P.OP_SUBMIT:
            fn_id, fn_blob, fn_name, args_kwargs_blob, opts_blob = payload
            args, kwargs = ser.loads(args_kwargs_blob)
            options = self._loads_options_cached(opts_blob)
            refs = self.submit_task(fn_id, fn_blob, fn_name, args,
                                    kwargs, options,
                                    client_key=client_key)
            if isinstance(refs, ObjectRefGenerator):
                # Ownership moves to the remote client: this local
                # generator object is about to be GC'd, and its owner
                # finalizer would drop the stream before the client's
                # first OP_STREAM_NEXT (the client-side generator
                # carries the drop-on-GC duty instead).
                refs._owner = False
                return ("stream", refs._task_id_bytes)
            # The only holder of these refs is the remote worker: pin
            # them so driver-side GC of the transient ObjectRef objects
            # doesn't delete the results out from under it.
            for r in refs:
                self.on_ref_escaped(r.id)
            return [r.id.binary() for r in refs]
        if op == P.OP_OWNED_FAILED:
            # The client's wire layer refused an owned submit (e.g.
            # oversized frame): the registration never arrived, so the
            # preminted return ids would dangle forever. Store the
            # client-reported error on each id — unless something is
            # already there (paranoia against a replay racing a real
            # registration).
            rid_bytes, err_blob = payload
            for b in rid_bytes:
                oid = ObjectID(b)
                if not self._object_available(oid):
                    self._store_error(oid, err_blob)
            return None
        if op == P.OP_PUT:
            ref = self.put_serialized(_wire_to_serialized(payload))
            # A remote process holds it; with a nonce (element 3) the
            # putter registers a borrow that consumes this pin, so the
            # ref's death reclaims the object. Legacy nonce-less puts
            # pin permanently.
            nonce = payload[3] if len(payload) > 3 else None
            self.on_ref_escaped(ref.id, nonce)
            return ref.id.binary()
        if op == P.OP_GET:
            oid_bytes, timeout, *rest = payload
            allow_desc = rest[0] if rest else True
            return self._serve_get_entry(ObjectID(oid_bytes), timeout,
                                         allow_desc)
        if op == P.OP_GET_MANY:
            oid_list, timeout, allow_desc = payload
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            oids = [ObjectID(ob) for ob in oid_list]
            # ONE batched availability wait for the whole list (the
            # serial per-entry loop blocked on each ref in turn), then
            # node-homed refs resolve concurrently on a bounded pool.
            # Entries are built per OCCURRENCE, not per unique id —
            # each "chunked" entry owns its transfer tid.
            locs = self._wait_locations_many(oids, deadline)

            def entry(oid: ObjectID):
                remaining = (None if deadline is None else
                             max(deadline - time.monotonic(), 0.0))
                return self._serve_get_entry(oid, remaining,
                                             allow_desc)

            remote_idx = [i for i, o in enumerate(oids)
                          if isinstance(locs.get(o), tuple)]
            outs: list = [None] * len(oids)
            if len(remote_idx) > 1:
                vals = _parallel_map_first_error(
                    lambda i: entry(oids[i]), remote_idx,
                    max(1, self.config.get_parallelism))
                for i, v in zip(remote_idx, vals):
                    outs[i] = v
            # Reply-frame byte budget: a fan-in of many large inline
            # objects must not pickle into one multi-tens-of-MiB
            # frame (a 64 MiB reply measured ~2.5x slower end-to-end
            # than 8 MiB frames — allocation + copy churn on both
            # sides). Local entries past the budget return ("defer",)
            # and the client re-requests them in a follow-up round;
            # at least one entry is served per round, so the loop
            # terminates. Already-fetched remote entries are exempt
            # (their cost is paid) but count toward the budget.
            budget = self.config.object_transfer_inline_max
            spent = sum(_entry_inline_bytes(v) for v in outs
                        if v is not None)
            served_local = False
            for i, o in enumerate(oids):
                if outs[i] is not None:
                    continue
                if spent > budget and served_local:
                    outs[i] = ("defer",)
                    continue
                outs[i] = entry(o)
                served_local = True
                spent += _entry_inline_bytes(outs[i])
            return outs
        if op == P.OP_PULL:
            action, tid, *prest = payload
            if action == "chunk":
                return self._transfer_chunk(tid, prest[0])
            self.transfer_plane.end(tid)   # "end"
            return None
        if op == P.OP_WAIT:
            oid_bytes_list, num_returns, timeout = payload
            done, rest = self.wait_available(
                [ObjectID(b) for b in oid_bytes_list], num_returns, timeout)
            return ([o.binary() for o in done], [o.binary() for o in rest])
        if op == P.OP_CREATE_ACTOR:
            (cls_blob, cls_name, args_kwargs_blob, opts_blob, name,
             max_restarts, max_concurrency) = payload
            args, kwargs = ser.loads(args_kwargs_blob)
            options = ser.loads(opts_blob)
            actor_id = self.create_actor(
                cls_blob, cls_name, args, kwargs, options, name,
                max_restarts, max_concurrency)
            return actor_id.binary()
        if op == P.OP_SUBMIT_ACTOR:
            (actor_id_bytes, method, args_kwargs_blob, num_returns,
             trace_ctx) = payload
            args, kwargs = ser.loads(args_kwargs_blob)
            refs = self.submit_actor_task(
                ActorID(actor_id_bytes), method, args, kwargs,
                num_returns, trace_ctx)
            if isinstance(refs, ObjectRefGenerator):
                # Ownership moves to the remote client: this local
                # generator object is about to be GC'd, and its owner
                # finalizer would drop the stream before the client's
                # first OP_STREAM_NEXT (the client-side generator
                # carries the drop-on-GC duty instead).
                refs._owner = False
                return ("stream", refs._task_id_bytes)
            for r in refs:
                self.on_ref_escaped(r.id)
            return [r.id.binary() for r in refs]
        if op == P.OP_STREAM_NEXT:
            task_id_bytes, timeout = payload
            ref = self.stream_next(task_id_bytes, timeout)
            if ref is None:
                return ("done",)
            self.on_ref_escaped(ref.id)
            return ("item", ref.id.binary())
        if op == P.OP_STREAM_DROP:
            self.drop_stream(payload)
            return None
        if op == P.OP_SPANS:
            self.observability.ingest_spans(payload)
            return None
        if op == P.OP_METRICS_PUSH:
            self.observability.ingest_push(payload)
            return None
        if op == P.OP_PUBSUB:
            action = payload[0]
            if action == "publish":
                return self.pubsub_publish(payload[1], payload[2])
            if action == "poll":
                _a, topic, epoch, cursor, timeout, mx = payload
                return self.pubsub_poll(topic, epoch, cursor,
                                        timeout, mx)
            if action == "cursor":
                return self.pubsub_cursor(payload[1])
            raise ValueError(f"unknown pubsub action {action!r}")
        if op == P.OP_KV:
            action, key, value, namespace = payload
            if action == "put":
                return self.kv_put(key, value, namespace)
            if action == "put_if_absent":
                return self.kv_put(key, value, namespace,
                                   overwrite=False)
            if action == "get":
                return self.kv_get(key, namespace)
            if action == "del":
                return self.kv_del(key, namespace)
            if action == "exists":
                return self.kv_exists(key, namespace)
            if action == "keys":
                return self.kv_keys(key, namespace)
            raise ValueError(f"unknown kv action {action!r}")
        if op == P.OP_ACTOR_LOCATION:
            return self.actor_location_lease(ActorID(payload))
        if op == P.OP_DIRECT:
            # Blocking form of the listener announcement (rare — the
            # notify path is the normal route).
            if payload and payload[0] == "register":
                self._direct_register(payload[1])
            return None
        if op == P.OP_DIRECT_RESULT:
            action, oid_bytes, body = payload
            oid = ObjectID(oid_bytes)
            # Ownership promotion of a caller-local direct result:
            # idempotent — replays and promote-vs-replay races keep
            # whichever copy landed first.
            if not self._object_available(oid):
                if action == "promote":
                    self._store_value(oid, _wire_to_serialized(body))
                else:                      # "promote_err"
                    self._store_error(oid, body)
            return None
        if op == P.OP_GET_ACTOR:
            name = payload
            return self.get_named_actor(name).binary()
        if op == P.OP_KILL:
            actor_id_bytes, no_restart = payload
            self.kill_actor(ActorID(actor_id_bytes), no_restart)
            return None
        if op == P.OP_CANCEL:
            oid_bytes, force = payload
            self.cancel(ObjectRef(ObjectID(oid_bytes)), force)
            return None
        if op == P.OP_BORROW:
            if isinstance(payload, tuple):
                action, oid_bytes, *rest = payload
            else:                      # legacy single-oid form
                action, oid_bytes, rest = "escape", payload, ()
            nonce = rest[0] if rest else None
            oid = ObjectID(oid_bytes)
            if action == "add":
                self.on_borrow_add(oid, nonce)
            elif action == "release":
                self.on_borrow_release(oid)
            else:
                self.on_ref_escaped(oid, nonce)
            return None
        if op == P.OP_RESOURCES:
            return (self.available_resources(), self.cluster_resources())
        if op == P.OP_STATE:
            kind, filters = payload
            from ray_tpu_torch.util import state as state_api
            fns = {
                "tasks": state_api.list_tasks,
                "actors": state_api.list_actors,
                "objects": state_api.list_objects,
                "nodes": state_api.list_nodes,
                "placement_groups": state_api.list_placement_groups,
            }
            if kind == "summary":
                return state_api.summarize_tasks()
            if kind == "timeline":
                return self.timeline()
            if kind == "tasks_detail":
                return state_api.list_tasks(filters, detail=True)
            if kind == "cluster_metrics":
                # Cluster-aggregated Prometheus text over the client
                # protocol — what the CLI scrapes without needing the
                # HTTP dashboard up.
                return self.observability.prometheus_text()
            if kind == "raw_nodes":
                # Full NodeID/Alive/Draining rows for consumers (e.g.
                # the serve controller actor) that need the real node
                # table, not the worker-side single-node stub.
                return self.nodes()
            if kind == "memory_summary":
                opts = filters if isinstance(filters, dict) else {}
                return self.memory_summary(
                    top_n=int(opts.get("top_n", 20)))
            if kind == "cluster_status":
                return self.cluster_status()
            if kind == "trace":
                opts = filters if isinstance(filters, dict) else {}
                return self.get_trace(str(opts.get("trace_id", "")))
            if kind == "traces":
                opts = filters if isinstance(filters, dict) else {}
                return self.list_traces(
                    limit=int(opts.get("limit", 50)),
                    slowest=bool(opts.get("slowest", False)))
            if kind == "trace_export":
                opts = filters if isinstance(filters, dict) else {}
                return self.observability.export_trace(
                    str(opts.get("trace_id", "")),
                    str(opts.get("format", "chrome")))
            if kind == "timeseries":
                # Signals-plane time-series queries (rate / windowed
                # quantile / delta / last-N / sparklines) over the
                # client protocol — what the CLI and the SLO-aware
                # serve autoscaler consume.
                return self.observability.signals.query(filters)
            if kind == "alerts":
                return self.observability.alerts()
            if kind == "deployment_signals":
                opts = filters if isinstance(filters, dict) else {}
                return self.observability.deployment_signals(
                    str(opts.get("name", "")),
                    window_s=opts.get("window"))
            return fns[kind](filters)
        if op == P.OP_PROFILE:
            action, spec = payload
            spec = dict(spec or {})
            if action == "capture":
                return self.profile_cluster(
                    duration_s=float(spec.get("duration_s", 2.0)),
                    hz=float(spec.get("hz", 100.0)),
                    target=spec.get("target"))
            if action == "stack":
                return self.stack_dump(target=spec.get("target"))
            if action == "device":
                return self.profile_device(
                    logdir=spec.get("logdir"),
                    duration_s=float(spec.get("duration_s", 5.0)),
                    target=spec.get("target"))
            raise ValueError(f"unknown profile action {action!r}")
        if op == P.OP_PG_CREATE:
            bundles, strategy, name = (payload if len(payload) == 3
                                       else (*payload, ""))
            return self.create_placement_group(
                bundles, strategy, name).binary()
        if op == P.OP_PG_REMOVE:
            self.remove_placement_group(PlacementGroupID(payload))
            return None
        raise ValueError(f"unknown client op: {op}")

    # ---------------- shutdown ----------------

    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        if self.memory_monitor is not None:
            self.memory_monitor.stop()
        if self.log_monitor is not None:
            # Final drain so prints from short-lived workers are not
            # lost between the last poll and shutdown.
            try:
                self.log_monitor.poll_once()
            except Exception:  # noqa: BLE001
                pass
            self.log_monitor.stop()
        with self._res_cv:
            self._res_cv.notify_all()
            daemons = [n for n in self._nodes.values()
                       if n.is_daemon and n.alive]
        for n in daemons:
            try:
                n.node_send((P.ND_SHUTDOWN,))
            except (OSError, BrokenPipeError):
                pass
        with self._pool_lock:
            workers = list(self._workers)
            self._workers.clear()
            self._idle.clear()
        for w in workers:
            if isinstance(w, RemoteWorkerHandle):
                continue     # its daemon tears it down
            w.shutdown(timeout=1.0)
        self._remote_workers.clear()
        try:
            self._listener.close()
        except OSError:
            pass
        if self._tcp_listener is not None:
            try:
                self._tcp_listener.close()
            except OSError:
                pass
        try:
            os.unlink(self.client_address)
        except OSError:
            pass
        self.shm_store.shutdown()
