"""Replica actor: hosts one copy of a deployment's user class.

Reference analog: serve replica (replica.py: UserCallableWrapper).
Runs with max_concurrency > 1 so the in-flight counter is meaningful
for power-of-two routing probes (pow_2_scheduler.py:51 probes queue
lengths the same way).

Request-plane robustness (zero-loss serving):

- **Executed-response ledger**: every routed request carries an id;
  a duplicate re-dispatch (the router replaying after a channel
  reset whose original execution actually finished) returns the
  recorded response instead of re-running a non-idempotent handler —
  at-most-once per replica, mirroring the direct-call result cache.
- **Admission gates**: a stopping replica (redeploy / scale-down /
  node drain, past its stale-router grace) sheds new requests with
  ``ReplicaStoppingError``; a full bounded queue sheds with
  ``ReplicaOverloadedError``; an expired deadline raises
  ``RequestDeadlineError`` without executing. All three fire BEFORE
  user code runs, so the router can re-dispatch safely.
- **probe()**: one RPC combining stats + the user ``check_health()``
  hook, used by the controller's health/readiness plane.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import ray_tpu_torch
from ray_tpu_torch.serve.replica_ctx import (     # noqa: F401 — re-export
    ReplicaContext, get_replica_context,
)


@ray_tpu_torch.remote
class Replica:
    def __init__(self, cls_or_fn, init_args, init_kwargs,
                 replica_tag: str, user_config=None,
                 max_queue_len: int | None = None):
        self.tag = replica_tag
        # Import at CALL time: this class ships by value (see
        # replica_ctx docstring), so only a runtime import reaches
        # the worker's real module — where user code reads from.
        from ray_tpu_torch.serve import replica_ctx
        replica_ctx.set_current(replica_ctx.ReplicaContext(
            deployment=replica_tag.split("#", 1)[0],
            replica_tag=replica_tag))
        from ray_tpu_torch.core.config import get_config
        cfg = get_config()
        self._inflight = 0
        self._lock = threading.Lock()
        self._total = 0
        self._stopping = False
        self._stop_ts = 0.0
        self._stop_grace = cfg.serve_drain_min_grace_s
        self._max_queue = (max_queue_len if max_queue_len is not None
                           else cfg.serve_max_queue_len_per_replica)
        # request_id -> ("ok" | "err", payload); bounded FIFO.
        self._ledger: OrderedDict[str, tuple] = OrderedDict()
        self._ledger_cap = max(1, cfg.serve_result_ledger_size)
        # request_id -> Event for executions still in flight, so a
        # concurrent duplicate waits for the first run instead of
        # racing it.
        self._executing: dict[str, threading.Event] = {}
        # Built-in observability (reference: serve_deployment_*
        # metrics recorded by every replica): request latency
        # histogram + live queue depth, tagged by deployment/replica.
        # Same-name registration across replicas in one process
        # shares the accumulators; each instance keeps its own
        # default tags. Shipped to the head by the worker's metrics
        # exporter.
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram
        dep = replica_tag.split("#", 1)[0]
        tags = {"deployment": dep, "replica": replica_tag}
        self._m_latency = Histogram(
            "ray_tpu_serve_request_latency_s",
            "serve request latency (seconds) observed at the replica",
            boundaries=[0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10],
            tag_keys=("deployment", "replica"),
        ).set_default_tags(tags)
        self._m_queue = Gauge(
            "ray_tpu_serve_replica_queue_depth",
            "in-flight requests on the replica",
            tag_keys=("deployment", "replica"),
        ).set_default_tags(tags)
        self._m_dedupe = Counter(
            "ray_tpu_serve_dedupe_hits_total",
            "duplicate re-dispatches answered from the response ledger",
            tag_keys=("deployment", "replica"),
        ).set_default_tags(tags)
        self._m_shed = Counter(
            "ray_tpu_serve_replica_shed_total",
            "requests shed by the replica (stopping or queue full)",
            tag_keys=("deployment", "replica"),
        ).set_default_tags(tags)
        if isinstance(cls_or_fn, type):
            self.callable = cls_or_fn(*init_args, **init_kwargs)
        else:
            self.callable = cls_or_fn
        if user_config is not None:
            self.reconfigure(user_config)

    def reconfigure(self, user_config) -> bool:
        """Apply a user_config (reference: Deployment user_config —
        the replica class defines ``reconfigure(config)``; called at
        startup with the initial config and again, WITHOUT a restart,
        on every redeploy that changes only user_config)."""
        fn = getattr(self.callable, "reconfigure", None)
        if fn is None:
            raise RuntimeError(
                f"deployment class {type(self.callable).__name__} "
                f"got a user_config but defines no reconfigure()")
        fn(user_config)
        return True

    def prepare_stop(self) -> int:
        """Enter the ``stopping`` state (graceful lifecycle): after
        the min-grace window (covering routers on a not-yet-refreshed
        table) new requests are shed with ReplicaStoppingError while
        in-flight ones drain; the controller reaps the replica once
        its queue is empty (or the drain deadline passes). Returns
        the current in-flight count."""
        import time as _time
        with self._lock:
            if not self._stopping:
                self._stopping = True
                self._stop_ts = _time.time()
            return self._inflight

    def _record(self, request_id: str, kind: str, payload) -> None:
        with self._lock:
            self._ledger[request_id] = (kind, payload)
            while len(self._ledger) > self._ledger_cap:
                self._ledger.popitem(last=False)
            ev = self._executing.pop(request_id, None)
        if ev is not None:
            ev.set()

    def _release_slot(self) -> None:
        """Undo a reserved admission slot for a request that will not
        execute here (ledger replay / duplicate waiter)."""
        with self._lock:
            self._inflight -= 1
            self._total -= 1
        self._m_queue.set(float(self._inflight))

    def _replay(self, hit: tuple, request_id: str = ""):
        # Ledger hit: the span marks "answered from the ledger, not
        # re-run" in the assembled trace — the causal explanation for
        # a retried request with only ONE execute span.
        from ray_tpu_torch.util.tracing import get_tracer
        with get_tracer().span(
                "serve.replica.ledger_replay",
                {"request_id": request_id, "replica": self.tag}):
            self._m_dedupe.inc()
            kind, payload = hit
            if kind == "err":
                raise payload
            return payload

    def _stream_wrapper(self, gen, multiplexed_model_id: str):
        """Owns the inflight count AND the model pin for a streaming
        response: handle_request hands its pin over (clearing its own
        ``pinned`` flag) so the request stays busy and the model stays
        pinned until the generator body finishes, not until
        handle_request returns the (unstarted) generator. Do not pin
        again here — pin_model is refcounted and a second pin with a
        single unpin would leak one pin per streaming request."""
        from ray_tpu_torch.serve.multiplex import (
            _set_current_model_id, unpin_model,
        )
        try:
            _set_current_model_id(multiplexed_model_id)
            yield from gen
        finally:
            if multiplexed_model_id:
                unpin_model(self.callable, multiplexed_model_id)
            with self._lock:
                self._inflight -= 1
            self._m_queue.set(float(self._inflight))

    def handle_request(self, method_name: str, args, kwargs,
                       multiplexed_model_id: str = "",
                       stream: bool = False,
                       request_id: str = "",
                       deadline_ts: float = 0.0):
        import inspect
        import time as _time

        from ray_tpu_torch.serve.exceptions import (
            ReplicaOverloadedError,
            ReplicaStoppingError,
            RequestDeadlineError,
        )
        from ray_tpu_torch.serve.multiplex import (
            _set_current_model_id, pin_model, unpin_model,
        )
        # Ledger fast path FIRST: a re-dispatch of an id this replica
        # already executed must succeed even while stopping — that is
        # exactly the drain/replay race the ledger exists for.
        # Streaming responses are exempt (generators aren't
        # replayable; the retry plane never replays them).
        dedupe = bool(request_id) and not stream
        if dedupe:
            with self._lock:
                hit = self._ledger.get(request_id)
            if hit is not None:
                return self._replay(hit, request_id)
        # Admission gates — all fire before user code runs.
        now = _time.time()
        with self._lock:
            shedding = (self._stopping
                        and (now - self._stop_ts) >= self._stop_grace)
        if shedding:
            self._m_shed.inc()
            raise ReplicaStoppingError(
                f"replica {self.tag} is stopping")
        if deadline_ts and now > deadline_ts:
            raise RequestDeadlineError(
                f"request {request_id or '<anon>'} deadline expired "
                f"{now - deadline_ts:.3f}s ago (not executed)")
        # Queue bound is check-AND-reserve under one lock hold:
        # concurrent calls must not all pass the check and overshoot
        # max_ongoing_requests. Paths below that turn out not to
        # execute (ledger replay, duplicate waiter) release the slot.
        with self._lock:
            depth = self._inflight
            admitted = depth < self._max_queue
            if admitted:
                self._inflight += 1
                self._total += 1
        if not admitted:
            self._m_shed.inc()
            raise ReplicaOverloadedError(
                f"replica {self.tag} queue full "
                f"({depth}/{self._max_queue})")
        self._m_queue.set(float(self._inflight))
        if dedupe:
            with self._lock:
                hit = self._ledger.get(request_id)
                waiter = (self._executing.get(request_id)
                          if hit is None else None)
                if hit is None and waiter is None:
                    self._executing[request_id] = threading.Event()
            if hit is not None:
                self._release_slot()
                return self._replay(hit, request_id)
            if waiter is not None:
                # Concurrent duplicate: only the first execution
                # occupies a queue slot — release ours, then wait it
                # out and answer from the ledger.
                self._release_slot()
                budget = (max(0.0, deadline_ts - _time.time())
                          if deadline_ts else self._wait_budget())
                waiter.wait(budget)
                with self._lock:
                    hit = self._ledger.get(request_id)
                if hit is not None:
                    return self._replay(hit, request_id)
                raise RequestDeadlineError(
                    f"duplicate of request {request_id} timed out "
                    f"waiting for the first execution")

        t_start = _time.perf_counter()
        _set_current_model_id(multiplexed_model_id)
        streaming = False
        pinned = False
        try:
            # Pin the request's model so concurrent eviction defers
            # unload until we're done with it (multiplex race fix).
            if multiplexed_model_id:
                pin_model(self.callable, multiplexed_model_id)
                pinned = True
            # Composition: DeploymentResponse args (type-preserved
            # through pickling) resolve to VALUES before user code
            # runs (reference: Serve resolves response arguments
            # before invoking the replica method). Plain ObjectRef
            # args pass through untouched — a deployment whose
            # contract is "receives a ref" keeps its ref.
            from ray_tpu_torch.serve.api import DeploymentResponse
            if any(isinstance(a, DeploymentResponse) for a in args):
                import ray_tpu_torch as _ray
                args = tuple(
                    _ray.get(a._to_object_ref())
                    if isinstance(a, DeploymentResponse) else a
                    for a in args)
            if kwargs and any(isinstance(v, DeploymentResponse)
                              for v in kwargs.values()):
                import ray_tpu_torch as _ray
                kwargs = {k: (_ray.get(v._to_object_ref())
                              if isinstance(v, DeploymentResponse)
                              else v)
                          for k, v in kwargs.items()}
            fn = (getattr(self.callable, method_name)
                  if hasattr(self.callable, method_name)
                  else self.callable)
            from ray_tpu_torch.util.tracing import get_tracer
            with get_tracer().span(
                    "serve.replica.execute",
                    {"request_id": request_id, "replica": self.tag,
                     "method": method_name}):
                result = fn(*args, **kwargs)
                if inspect.iscoroutine(result):
                    import asyncio
                    result = asyncio.run(result)
            if inspect.isgenerator(result):
                if not stream:
                    raise TypeError(
                        f"{method_name} returned a generator; call it "
                        f"through handle.options(stream=True)")
                streaming = True    # wrapper owns decrement + unpin
                pinned = False      # pin ownership transfers with it
                return self._stream_wrapper(result,
                                            multiplexed_model_id)
            if stream:
                raise TypeError(
                    f"stream=True but {method_name} returned "
                    f"{type(result).__name__}, not a generator")
            if dedupe:
                self._record(request_id, "ok", result)
            return result
        except BaseException as e:
            if dedupe and not streaming:
                # Record the USER failure too: the replay of a
                # request whose first run raised gets the same error
                # without a second side-effecting execution.
                self._record(request_id, "err", e)
            raise
        finally:
            if pinned:
                unpin_model(self.callable, multiplexed_model_id)
            if not streaming:
                with self._lock:
                    self._inflight -= 1
                if dedupe:
                    # Success path recorded already; make sure no
                    # waiter is left hanging if we exited via a path
                    # that didn't (TypeError before execution etc.).
                    with self._lock:
                        ev = self._executing.pop(request_id, None)
                    if ev is not None:
                        ev.set()
            self._m_latency.observe(_time.perf_counter() - t_start)
            self._m_queue.set(float(self._inflight))

    @staticmethod
    def _wait_budget() -> float:
        from ray_tpu_torch.core.config import get_config
        return get_config().serve_call_timeout_s

    def queue_len(self) -> int:
        return self._inflight

    def stats(self) -> dict:
        import os
        from ray_tpu_torch.serve.multiplex import resident_model_ids
        return {"tag": self.tag, "inflight": self._inflight,
                "total": self._total, "pid": os.getpid(),
                "stopping": self._stopping,
                "model_ids": resident_model_ids(self.callable)}

    def probe(self) -> dict:
        """One RPC for the controller's health/readiness plane:
        stats + the user ``check_health()`` hook. ``healthy=False``
        (with ``err``) counts toward the consecutive-failure
        ejection threshold; an unreachable replica fails the RPC
        itself."""
        out = self.stats()
        out["healthy"], out["err"] = True, ""
        if hasattr(self.callable, "check_health"):
            try:
                self.callable.check_health()
            except BaseException as e:
                out["healthy"] = False
                out["err"] = f"{type(e).__name__}: {e}"[:500]
        return out

    def health_check(self) -> str:
        if hasattr(self.callable, "check_health"):
            self.callable.check_health()
        return "ok"
