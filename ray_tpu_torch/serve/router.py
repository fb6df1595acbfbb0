"""Request router: power-of-two-choices replica selection + the
request-level retry/replay plane.

Reference analogs: PowerOfTwoChoicesReplicaScheduler
(replica_scheduler/pow_2_scheduler.py:51) + LongPollClient
(long_poll.py:64) + handle retry semantics (router.py request
re-dispatch on replica failure). Routing state is PUSHED: one
process-wide LongPollClient keeps a single multiplexed
``listen_for_change`` call outstanding against the controller for ALL
routers in this process and swaps their cached snapshots when it
returns. The steady-state request path (pick_replica) touches only
the cache and the two sampled replicas' queue-length probes: zero
controller RPCs per request.

Retry plane (``call``): each request gets an id + attempt budget; a
dispatch that dies with the replica (ActorDiedError / channel reset)
or is shed by a stopping/overloaded replica is re-dispatched to
another healthy replica, skipping the one that just failed. The id
rides to the replica's executed-response ledger so a replay whose
first execution actually finished is answered from the ledger, not
re-run. An EMPTY routing table (rolling redeploy gap) is waited out
under ``serve_no_replica_wait_s`` without charging attempts. With
``serve_retry_enabled`` off the dispatch path is byte-for-byte the
pre-retry one — no ids, no pending accounting (the ≤5% overhead
guardrail in tests/test_perf.py compares the two).
"""

from __future__ import annotations

import random
import threading
import time
import uuid

import ray_tpu_torch
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.serve.exceptions import (
    DeploymentOverloadedError,
    ReplicaOverloadedError,
    RequestDeadlineError,
    RequestRetriesExhaustedError,
    classify,
)


class NoReplicasError(RuntimeError):
    """The routing table is (still) empty — deployment coming up,
    scaled to zero, or mid-redeploy. Message kept compatible with the
    pre-retry RuntimeError."""


class LongPollClient:
    """One per (process, controller): multiplexes every local router's
    watch into a single outstanding long-poll so parked listeners on
    the controller scale with client processes, not handles."""

    _instances: dict = {}
    _instances_lock = threading.Lock()

    @classmethod
    def for_controller(cls, controller) -> "LongPollClient":
        key = getattr(controller, "_actor_id", id(controller))
        with cls._instances_lock:
            inst = cls._instances.get(key)
            if inst is None or inst._stop:
                inst = cls(controller)
                cls._instances[key] = inst
            return inst

    @classmethod
    def shutdown_all(cls) -> None:
        with cls._instances_lock:
            for inst in cls._instances.values():
                inst._stop = True
            cls._instances.clear()

    def __init__(self, controller):
        self._controller = controller
        self._routers: dict[str, list] = {}    # name -> [Router]
        self._lock = threading.Lock()
        self._stop = False
        self._m_reconnects = None   # lazy scrape counter
        self._have_routers = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="serve_longpoll")
        self._thread.start()

    def register(self, router: "Router") -> None:
        with self._lock:
            self._routers.setdefault(router._name, []).append(router)
        self._have_routers.set()

    def unregister(self, router: "Router") -> None:
        with self._lock:
            lst = self._routers.get(router._name, [])
            if router in lst:
                lst.remove(router)
            if not lst:
                self._routers.pop(router._name, None)
            if not self._routers:
                self._have_routers.clear()

    def _loop(self) -> None:
        backoff = 0.5
        while not self._stop:
            # Park (instead of spinning) until some router watches.
            if not self._have_routers.wait(timeout=1.0):
                continue
            with self._lock:
                known = {name: min(r._version for r in routers)
                         for name, routers in self._routers.items()
                         if routers}
            if not known:
                continue
            try:
                updates = ray_tpu_torch.get(
                    self._controller.listen_for_change.remote(known),
                    timeout=get_config().serve_longpoll_timeout_s)
                backoff = 0.5
            except Exception:  # noqa: BLE001 — controller down/busy
                if self._stop:
                    return
                # Counted onto the cluster scrape next to the wire
                # reset counters: a partitioned controller shows up
                # as long-poll churn here, channel resets there.
                try:
                    from ray_tpu_torch.util.metrics import Counter
                    if self._m_reconnects is None:
                        self._m_reconnects = Counter(
                            "ray_tpu_serve_longpoll_reconnects_total",
                            "serve long-poll error/reconnect cycles")
                    self._m_reconnects.inc()
                except Exception:  # noqa: BLE001
                    pass
                # Full jitter on the reconnect backoff: a fleet of
                # routers that all lost the same controller (restart,
                # head failover, drain) must not re-dial it in
                # lockstep — synchronized retries stampede a
                # controller that is still warming up.
                time.sleep(backoff * random.uniform(0.5, 1.5))
                backoff = min(backoff * 2, 5.0)
                continue
            with self._lock:
                for name, state in (updates or {}).items():
                    for r in self._routers.get(name, []):
                        r._apply(state)


class RequestContext:
    """Carries one routed request's retry state alongside its first
    object ref (attached to DeploymentResponse): the same request id
    (for ledger dedupe), the deadline, and the pending-count slot to
    release exactly once."""

    __slots__ = ("router", "method_name", "args", "kwargs",
                 "model_id", "request_id", "deadline_ts",
                 "_pending_key", "_done")

    def __init__(self, router, method_name, args, kwargs, model_id,
                 request_id, deadline_ts, pending_key):
        self.router = router
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs
        self.model_id = model_id
        self.request_id = request_id
        self.deadline_ts = deadline_ts
        self._pending_key = pending_key
        self._done = False

    def finish(self) -> None:
        if not self._done:
            self._done = True
            if self._pending_key is not None:
                self.router._pending_dec(self._pending_key)

    def retry(self, first_error, timeout=None):
        """Continue the attempt budget after the first (assign-path)
        dispatch failed retryably; same request id → ledger dedupe.
        The replica that just failed is excluded from the first
        re-dispatch so a shed/dropped request doesn't burn a retry
        attempt landing right back on it."""
        failed_key = self._pending_key
        self.finish()
        return self.router.call(
            self.method_name, self.args, self.kwargs,
            multiplexed_model_id=self.model_id, timeout=timeout,
            deadline_ts=self.deadline_ts, request_id=self.request_id,
            attempts_used=1, first_error=first_error,
            exclude={failed_key} if failed_key else None)


class Router:
    # One router per (controller, deployment) per process: handles are
    # created freely (serve.run, get_deployment_handle, __reduce__ on
    # every deserialization) and must share the cached snapshot
    # instead of each registering a fresh long-poll watcher.
    _cache: dict = {}
    _cache_lock = threading.Lock()

    @classmethod
    def for_deployment(cls, controller,
                       deployment_name: str) -> "Router":
        key = (getattr(controller, "_actor_id", id(controller)),
               deployment_name)
        with cls._cache_lock:
            r = cls._cache.get(key)
            if r is None:
                r = cls(controller, deployment_name)
                cls._cache[key] = r
            return r

    def __init__(self, controller, deployment_name: str):
        self._controller = controller
        self._name = deployment_name
        self._replicas: list = []
        self._model_map: dict[str, list[int]] = {}
        self._version = -1
        self._rng = random.Random()
        self._lock = threading.Lock()
        # Locally-dispatched-but-unresolved requests per replica key:
        # added to the probed queue depth so pow-2 sees work this
        # process has in flight before the replica even received it.
        self._pending: dict[str, int] = {}
        # Counts synchronous controller round-trips — steady state
        # must not grow this (asserted by tests/benchmarks).
        self.controller_rpcs = 0
        # Built-in observability: routed-request counter (the
        # router-side half of the serve request metrics; the
        # replica-side latency histogram is the other). Created lazily
        # so constructing a Router off a live session costs nothing.
        self._m_requests = None
        self._m_retries = None
        self._m_shed = None
        self._longpoll = LongPollClient.for_controller(controller)
        self._longpoll.register(self)

    def close(self) -> None:
        self._longpoll.unregister(self)

    # -- snapshot maintenance (push path) --

    def _apply(self, state) -> None:
        version, replicas, model_map = state
        with self._lock:
            if version < self._version:
                return    # stale in-flight response must not regress
            self._version = version
            self._replicas = replicas
            self._model_map = model_map

    def _refresh_sync(self) -> None:
        """Cold-start / error-recovery pull; never on the hot path
        once a snapshot exists."""
        self.controller_rpcs += 1
        self._apply(ray_tpu_torch.get(
            self._controller.get_routing_state.remote(self._name),
            timeout=get_config().serve_refresh_timeout_s))

    def _invalidate(self) -> None:
        with self._lock:
            self._version = -1

    # -- pending accounting (retry plane only) --

    @staticmethod
    def _key(replica) -> str:
        aid = getattr(replica, "_actor_id", None)
        return aid.hex() if hasattr(aid, "hex") else str(aid)

    def _pending_inc(self, key: str) -> None:
        with self._lock:
            self._pending[key] = self._pending.get(key, 0) + 1

    def _pending_dec(self, key: str) -> None:
        with self._lock:
            n = self._pending.get(key, 0) - 1
            if n > 0:
                self._pending[key] = n
            else:
                self._pending.pop(key, None)

    # -- hot path --

    def pick_replica(self, multiplexed_model_id: str = "",
                     exclude: set | None = None):
        with self._lock:
            replicas = self._replicas
            model_map = self._model_map
        if not replicas:
            # Deployment still coming up (or we raced a scale-from-
            # zero): one synchronous pull, then fail clearly.
            self._refresh_sync()
            with self._lock:
                replicas = self._replicas
                model_map = self._model_map
            if not replicas:
                raise NoReplicasError(
                    f"deployment {self._name!r} has no replicas")
        pool = replicas
        if exclude:
            pool = [r for r in pool if self._key(r) not in exclude]
            if not pool:
                raise NoReplicasError(
                    f"deployment {self._name!r} has no replicas "
                    f"outside the excluded set")
        if multiplexed_model_id:
            # Model-locality-aware pick (reference: multiplex-aware
            # pow-2): prefer replicas with the model resident, from
            # the pushed cached map — no extra hot-path RPC.
            idxs = model_map.get(multiplexed_model_id, [])
            with_model = [replicas[i] for i in idxs
                          if i < len(replicas)]
            if exclude:
                with_model = [r for r in with_model
                              if self._key(r) not in exclude]
            if with_model:
                pool = with_model
        if len(pool) == 1:
            return pool[0]
        a, b = self._rng.sample(pool, 2)
        try:
            qa, qb = ray_tpu_torch.get(
                [a.queue_len.remote(), b.queue_len.remote()],
                timeout=get_config().serve_queue_probe_timeout_s)
        except Exception:  # noqa: BLE001 — probe failure: let the
            # long-poll (or next cold refresh) repair the set
            self._invalidate()
            return a
        with self._lock:
            qa += self._pending.get(self._key(a), 0)
            qb += self._pending.get(self._key(b), 0)
        return a if qa <= qb else b

    def _count_request(self) -> None:
        if self._m_requests is None:
            from ray_tpu_torch.util.metrics import Counter
            self._m_requests = Counter(
                "ray_tpu_serve_router_requests_total",
                "requests routed per deployment",
                tag_keys=("deployment",))
        self._m_requests.inc(tags={"deployment": self._name})

    def _count_retry(self) -> None:
        if self._m_retries is None:
            from ray_tpu_torch.util.metrics import Counter
            self._m_retries = Counter(
                "ray_tpu_serve_request_retries_total",
                "request re-dispatches after a retryable failure",
                tag_keys=("deployment",))
        self._m_retries.inc(tags={"deployment": self._name})

    def _count_shed(self) -> None:
        if self._m_shed is None:
            from ray_tpu_torch.util.metrics import Counter
            self._m_shed = Counter(
                "ray_tpu_serve_requests_shed_total",
                "requests shed as overloaded (503/UNAVAILABLE)",
                tag_keys=("deployment",))
        self._m_shed.inc(tags={"deployment": self._name})

    @staticmethod
    def _default_deadline(deadline_ts: float) -> float:
        if deadline_ts:
            return deadline_ts
        d = get_config().serve_request_deadline_s
        return time.time() + d if d > 0 else 0.0

    def assign(self, method_name: str, args, kwargs,
               multiplexed_model_id: str = "", stream: bool = False):
        ref, _ctx = self.assign_ctx(
            method_name, args, kwargs,
            multiplexed_model_id=multiplexed_model_id, stream=stream)
        return ref

    def assign_ctx(self, method_name: str, args, kwargs,
                   multiplexed_model_id: str = "",
                   stream: bool = False, deadline_ts: float = 0.0):
        """Dispatch once, returning (ref, RequestContext|None). The
        context (non-streaming, retry plane on) lets
        DeploymentResponse.result() continue the attempt budget with
        the same request id if this first dispatch fails retryably."""
        self._count_request()
        cfg = get_config()
        retry_on = cfg.serve_retry_enabled and not stream
        deadline_ts = self._default_deadline(deadline_ts)
        request_id = uuid.uuid4().hex if retry_on else ""
        replica = self.pick_replica(multiplexed_model_id)
        method = replica.handle_request
        if stream:
            # Streaming response (reference: serve generators /
            # StreamingResponse): the user method returns a generator
            # and items flow back as they are produced. No replay:
            # a generator that died mid-stream is not re-dispatched.
            method = method.options(num_returns="streaming")
            return method.remote(
                method_name, args, kwargs,
                multiplexed_model_id=multiplexed_model_id,
                stream=True), None
        ctx = None
        if retry_on:
            key = self._key(replica)
            self._pending_inc(key)
            ctx = RequestContext(self, method_name, args, kwargs,
                                 multiplexed_model_id, request_id,
                                 deadline_ts, key)
        try:
            ref = method.remote(
                method_name, args, kwargs,
                multiplexed_model_id=multiplexed_model_id,
                stream=False, request_id=request_id,
                deadline_ts=deadline_ts)
        except BaseException:
            # Synchronous dispatch failure (e.g. arg serialization):
            # release the pending slot now or the pow-2 queue
            # estimate for this replica is skewed forever.
            if ctx is not None:
                ctx.finish()
            raise
        return ref, ctx

    def call(self, method_name: str, args, kwargs,
             multiplexed_model_id: str = "", timeout: float | None = None,
             deadline_ts: float = 0.0, retry: bool | None = None,
             request_id: str | None = None, attempts_used: int = 0,
             first_error=None, exclude: set | None = None):
        """Blocking request with the full retry/replay plane — the
        proxies' path, and DeploymentResponse.result()'s continuation
        path. Returns the response value or raises a terminal error
        (user exception, DeploymentOverloadedError,
        RequestRetriesExhaustedError, RequestDeadlineError)."""
        cfg = get_config()
        retry_on = cfg.serve_retry_enabled if retry is None else retry
        if attempts_used == 0:
            self._count_request()
        deadline_ts = self._default_deadline(deadline_ts)
        per_call = timeout if timeout is not None \
            else cfg.serve_call_timeout_s

        if not retry_on:
            # The measured "disabled path": one pick, one dispatch,
            # no ids, no pending accounting — pre-retry behavior.
            replica = self.pick_replica(multiplexed_model_id)
            ref = replica.handle_request.remote(
                method_name, args, kwargs,
                multiplexed_model_id=multiplexed_model_id,
                stream=False)
            return ray_tpu_torch.get(ref, timeout=per_call)

        if request_id is None:
            request_id = uuid.uuid4().hex
        from ray_tpu_torch.util.tracing import get_tracer
        with get_tracer().span(
                "serve.router",
                {"deployment": self._name, "request_id": request_id,
                 "attempts_used": attempts_used}):
            return self._call_with_retry(
                cfg, method_name, args, kwargs, multiplexed_model_id,
                deadline_ts, per_call, request_id, attempts_used,
                first_error, exclude)

    def _call_with_retry(self, cfg, method_name, args, kwargs,
                         multiplexed_model_id, deadline_ts, per_call,
                         request_id, attempts_used, first_error,
                         exclude):
        from ray_tpu_torch.util.tracing import get_tracer
        tr = get_tracer()
        overall_deadline = time.time() + per_call
        max_attempts = 1 + max(0, cfg.serve_request_max_retries)
        attempt = attempts_used
        last_err = first_error
        # None = no failure observed yet; thereafter ANDed across
        # failures — terminal overload (503) is only raised when every
        # attempt was shed by a full queue, never for deaths.
        overload_only: bool | None = None
        if first_error is not None:
            attempt = max(attempt, 1)
            kind = classify(first_error)
            overload_only = (kind == "replica_busy"
                             and _is_overload(first_error))
            if kind == "replica_died":
                self._invalidate()
            self._count_retry()
        excluded: set[str] = set(exclude or ())
        empty_until = None
        while attempt < max_attempts:
            now = time.time()
            if deadline_ts and now > deadline_ts:
                self._raise_deadline(request_id, last_err)
            if now > overall_deadline:
                break
            try:
                replica = self.pick_replica(multiplexed_model_id,
                                            exclude=excluded or None)
            except NoReplicasError as e:
                # Rolling-redeploy gap: wait it out (bounded, not
                # charged to the attempt budget) instead of failing
                # an accepted request because the table is briefly
                # empty between old replicas stopping and new ones
                # passing readiness.
                if empty_until is None:
                    empty_until = time.time() + \
                        cfg.serve_no_replica_wait_s
                if time.time() >= empty_until or \
                        (deadline_ts and time.time() > deadline_ts):
                    last_err = last_err or e
                    break
                excluded.clear()
                self._invalidate()
                time.sleep(0.1)
                continue
            empty_until = None
            key = self._key(replica)
            self._pending_inc(key)
            try:
                budget = overall_deadline - time.time()
                if deadline_ts:
                    budget = min(budget, deadline_ts - time.time())
                # Attempt span: the replica's execute span becomes its
                # child (the .remote() below propagates this context),
                # and a failed attempt carries the classifier verdict
                # the retry decision was made on.
                with tr.span("serve.attempt",
                             {"attempt": attempt, "replica": key,
                              "request_id": request_id}) as att:
                    try:
                        ref = replica.handle_request.remote(
                            method_name, args, kwargs,
                            multiplexed_model_id=multiplexed_model_id,
                            stream=False, request_id=request_id,
                            deadline_ts=deadline_ts)
                        return ray_tpu_torch.get(ref,
                                           timeout=max(0.01, budget))
                    except Exception as e:
                        if att is not None:
                            att.attributes["verdict"] = classify(e)
                        raise
            except Exception as e:  # noqa: BLE001 — classified below
                kind = classify(e)
                if kind == "deadline":
                    self._raise_deadline(request_id, e)
                if kind == "error":
                    if _is_get_timeout(e) and deadline_ts and \
                            time.time() > deadline_ts:
                        self._raise_deadline(request_id, e)
                    raise
                # Retryable: skip this replica, note the flavor, and
                # go around (replica death also invalidates the
                # cached table so the refreshed one drops it).
                last_err = e
                excluded.add(key)
                if kind == "replica_died":
                    self._invalidate()
                    overload_only = False
                else:
                    is_over = _is_overload(e)
                    overload_only = (is_over if overload_only is None
                                     else overload_only and is_over)
                attempt += 1
                self._count_retry()
                if attempt < max_attempts:
                    time.sleep(cfg.serve_retry_backoff_s
                               * (2 ** (attempt - 1))
                               * random.uniform(0.5, 1.5))
            finally:
                self._pending_dec(key)
        if overload_only:
            self._count_shed()
            raise DeploymentOverloadedError(
                f"deployment {self._name!r}: every replica shed "
                f"request {request_id} ({attempt} attempts) — "
                f"back off and retry") from last_err
        self._count_shed()
        raise RequestRetriesExhaustedError(
            f"deployment {self._name!r}: request {request_id} failed "
            f"after {attempt} attempts; last error: "
            f"{type(last_err).__name__ if last_err else 'n/a'}: "
            f"{str(last_err)[:300]}") from last_err

    @staticmethod
    def _raise_deadline(request_id: str, cause) -> None:
        if isinstance(cause, RequestDeadlineError):
            raise cause
        raise RequestDeadlineError(
            f"request {request_id} deadline expired") from cause


def _is_overload(exc) -> bool:
    if isinstance(exc, ReplicaOverloadedError):
        return True
    return "ReplicaOverloadedError" in \
        (getattr(exc, "traceback_str", "") or "")


def _is_get_timeout(exc) -> bool:
    return type(exc).__name__ in ("GetTimeoutError", "TimeoutError")
