"""Serve request-plane exceptions.

Two families with different contracts:

- **Retryable replica signals** (``ReplicaUnavailableError`` subtree):
  a replica-local condition — the replica is stopping (redeploy /
  scale-down / node drain) or its bounded queue is full. The router
  re-dispatches the request to another replica transparently; user
  code never sees these.
- **Terminal request outcomes**: the retry budget is exhausted, the
  deployment is overloaded end-to-end, or the request's deadline
  expired. The proxies map these to proper transport codes — HTTP 503
  + ``Retry-After`` / gRPC ``UNAVAILABLE`` for overload, HTTP 504 /
  gRPC ``DEADLINE_EXCEEDED`` for deadlines — instead of a raw 500.

Replica-raised signals cross the wire wrapped in
``core.exceptions.ActorError`` whose ``__reduce__`` drops the cause,
so classification on the caller side matches the class name embedded
in the carried remote traceback (``classify``)."""

from __future__ import annotations

from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    RayTpuError,
    TaskError,
)


class ServeError(RayTpuError):
    """Base class for serve request-plane errors."""


class ReplicaUnavailableError(ServeError):
    """Retryable: this replica cannot take the request right now."""


class ReplicaStoppingError(ReplicaUnavailableError):
    """The replica is draining out (redeploy, scale-down, node drain)
    and past its stale-router grace window; re-dispatch elsewhere."""


class ReplicaOverloadedError(ReplicaUnavailableError):
    """The replica's bounded request queue (``max_ongoing_requests``)
    is full; re-dispatch elsewhere."""


class DeploymentOverloadedError(ServeError):
    """Every routing attempt hit a full replica queue (or the proxy's
    in-flight cap): shed with HTTP 503 + Retry-After / gRPC
    UNAVAILABLE — the client should back off and retry."""


class RequestRetriesExhaustedError(ServeError):
    """The request's attempt budget ran out without a successful
    execution; maps to 503/UNAVAILABLE (the condition is transient —
    replicas were dying/stopping — so a client retry is correct)."""


class RequestDeadlineError(ServeError):
    """The request's deadline expired before (or instead of)
    execution; maps to HTTP 504 / gRPC DEADLINE_EXCEEDED. Expired
    requests are cancelled, never executed."""


class ModelLoadError(ServeError):
    """A ``@serve.multiplexed`` loader raised: the model id is ejected
    (no poisoned LRU slot) and the cause is carried in the message."""


# Class names matched inside remote tracebacks (ActorError.__reduce__
# drops the cause object; the formatted traceback is the contract).
_RETRYABLE_MARKERS = ("ReplicaStoppingError", "ReplicaOverloadedError")
_OVERLOAD_MARKERS = ("ReplicaOverloadedError",
                     "DeploymentOverloadedError")
_DEADLINE_MARKERS = ("RequestDeadlineError",)


def _tb(exc) -> str:
    return getattr(exc, "traceback_str", "") or ""


def classify(exc) -> str:
    """Map any exception surfaced by a routed request to one of:

    - ``"replica_died"``   — retryable; also invalidates routing state
    - ``"replica_busy"``   — retryable (stopping/overloaded replica)
    - ``"overload"``       — terminal; 503/UNAVAILABLE
    - ``"deadline"``       — terminal; 504/DEADLINE_EXCEEDED
    - ``"error"``          — terminal; the request truly failed (user
                             exception — 500/INTERNAL)
    """
    if isinstance(exc, (DeploymentOverloadedError,
                        RequestRetriesExhaustedError)):
        return "overload"
    if isinstance(exc, RequestDeadlineError):
        return "deadline"
    if isinstance(exc, ReplicaUnavailableError):
        return "replica_busy"
    if isinstance(exc, ActorDiedError):
        return "replica_died"
    # NOT retryable: a get() timeout means the request may still be
    # EXECUTING — re-dispatching would double-run it. (TimeoutError
    # subclasses OSError since py3.3, so this must precede the
    # channel-death check below.)
    if isinstance(exc, TimeoutError):
        return "error"
    # Channel death (wire reset, direct-call fallback failure…)
    # surfaces as an OSError subclass by the wire contract.
    if isinstance(exc, (OSError, EOFError)):
        return "replica_died"
    if isinstance(exc, TaskError):
        tb = _tb(exc)
        if any(m in tb for m in _DEADLINE_MARKERS):
            return "deadline"
        if any(m in tb for m in _RETRYABLE_MARKERS):
            return "replica_busy"
        # A replica whose process died mid-execution can surface as a
        # TaskError wrapping the death.
        if "ActorDiedError" in tb:
            return "replica_died"
    return "error"


def is_retryable(exc) -> bool:
    return classify(exc) in ("replica_died", "replica_busy")
