"""Deployment autoscaling policies.

Reference analog: python/ray/serve/_private/{autoscaling_state,
autoscaling_policy}.py — replicas report ongoing requests; desired
replicas = ceil(total_ongoing / target_ongoing_requests), clamped to
[min_replicas, max_replicas], smoothed by upscale/downscale delays so
transient spikes don't thrash the replica set.

Two policies, duck-typed on ``record(total_ongoing)`` /
``decide(current_replicas)``:

- :class:`AutoscalingState` — the classic ongoing-requests policy.
- :class:`SloAwareAutoscalingPolicy` (``policy="slo_aware"``) — the
  monitoring-actuates closing of the loop: consumes the head signals
  plane's per-deployment digest (p99-over-window from the latency
  histogram, shed rate, head queue depth) and scales OUT while the
  tail-latency SLO is burning — i.e. *before* queue overflow starts
  shedding — and scales IN only on signal-proven idle (low ongoing
  AND p99 well under target across the window). With no signal data
  (signals disabled, store still warming) it falls back to the
  ongoing-requests policy, so it is never worse than the legacy one.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field

_POLICIES = ("ongoing_requests", "slo_aware")


@dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 8
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.0
    downscale_delay_s: float = 2.0
    look_back_period_s: float = 5.0
    # --- slo_aware policy knobs ---
    policy: str = "ongoing_requests"
    # p99-over-window objective; scale out while the observed p99
    # exceeds it. Required (> 0) when policy="slo_aware".
    target_p99_ms: float = 0.0
    # Scale in only when p99 <= this fraction of the target ("well
    # under", not merely under) AND ongoing load fits the smaller set.
    scale_in_p99_fraction: float = 0.5
    # Window for the p99/shed-rate digest fetched from the head.
    signal_window_s: float = 30.0

    def __post_init__(self) -> None:
        if self.min_replicas < 0 or self.max_replicas < 1:
            raise ValueError(
                f"autoscaling bounds must satisfy min>=0, max>=1 "
                f"(got min={self.min_replicas}, "
                f"max={self.max_replicas})")
        if self.min_replicas > self.max_replicas:
            raise ValueError(
                f"autoscaling min_replicas={self.min_replicas} > "
                f"max_replicas={self.max_replicas}")
        if self.target_ongoing_requests <= 0:
            raise ValueError(
                f"target_ongoing_requests must be > 0 "
                f"(got {self.target_ongoing_requests})")
        if self.policy not in _POLICIES:
            raise ValueError(
                f"unknown autoscaling policy {self.policy!r} "
                f"(choose from {_POLICIES})")
        if self.policy == "slo_aware" and self.target_p99_ms <= 0:
            raise ValueError(
                "policy='slo_aware' requires target_p99_ms > 0")

    @classmethod
    def from_dict(cls, d: dict) -> "AutoscalingConfig":
        return cls(**{k: v for k, v in d.items()
                      if k in cls.__dataclass_fields__})


@dataclass
class AutoscalingState:
    config: AutoscalingConfig
    # (ts, total_ongoing) samples; deque + popleft-expiry so each
    # record() is O(expired), not a full-window list rebuild.
    window: deque = field(default_factory=deque)
    _pending_since: float | None = None
    _pending_target: int | None = None

    def record(self, total_ongoing: float) -> None:
        now = time.monotonic()
        self.window.append((now, total_ongoing))
        cutoff = now - self.config.look_back_period_s
        while self.window and self.window[0][0] < cutoff:
            self.window.popleft()

    def avg_ongoing(self) -> float:
        if not self.window:
            return 0.0
        return sum(v for _, v in self.window) / len(self.window)

    def _apply_delay(self, target: int, current_replicas: int,
                     now: float | None = None) -> int:
        """Upscale/downscale-delay smoothing, shared by both
        policies: a changed target must persist for the matching
        delay before it is returned. Re-confirming the SAME pending
        target does NOT restart the timer — ``_pending_since`` is
        only (re)set when the target actually changes."""
        cfg = self.config
        if target == current_replicas:
            self._pending_since = None
            self._pending_target = None
            return current_replicas
        delay = (cfg.upscale_delay_s if target > current_replicas
                 else cfg.downscale_delay_s)
        now = time.monotonic() if now is None else now
        if self._pending_target != target:
            self._pending_target = target
            self._pending_since = now
        if now - self._pending_since >= delay:
            self._pending_since = None
            self._pending_target = None
            return target
        return current_replicas

    def decide(self, current_replicas: int) -> int:
        """Return the replica count the deployment should have now."""
        cfg = self.config
        if not self.window:
            return max(cfg.min_replicas,
                       min(current_replicas, cfg.max_replicas))
        raw = math.ceil(self.avg_ongoing()
                        / max(cfg.target_ongoing_requests, 1e-9))
        target = max(cfg.min_replicas, min(cfg.max_replicas, raw))
        return self._apply_delay(target, current_replicas)


class SloAwareAutoscalingPolicy:
    """Tail-latency-driven autoscaling over the head signals plane.

    ``fetch_signals`` is a zero-arg callable returning the head's
    per-deployment digest (the ``deployment_signals`` OP_STATE verb):
    ``{"p99_s", "samples", "shed_rate", "queue_depth", ...}`` or
    None/raising on any failure — every failure mode degrades to the
    ongoing-requests fallback, never to an exception in the
    controller's reconcile loop.
    """

    def __init__(self, config: AutoscalingConfig,
                 fetch_signals=None):
        self.config = config
        self.state = AutoscalingState(config=config)
        self._fetch = fetch_signals
        self.last_signals: dict | None = None
        self.last_reason = "init"

    def record(self, total_ongoing: float) -> None:
        self.state.record(total_ongoing)

    def _signals(self) -> dict | None:
        if self._fetch is None:
            return None
        try:
            sig = self._fetch()
        except Exception:  # noqa: BLE001 — head unreachable, etc.
            return None
        return sig if isinstance(sig, dict) else None

    def decide(self, current_replicas: int) -> int:
        cfg = self.config
        sig = self._signals()
        self.last_signals = sig
        p99 = (sig or {}).get("p99_s")
        samples = int((sig or {}).get("samples") or 0)
        if sig is None or p99 is None or samples < 1:
            # No trace-backed signal: never fly blind — fall back to
            # the ongoing-requests policy on the recorded window.
            self.last_reason = "no-signal:ongoing-fallback"
            return self.state.decide(current_replicas)
        target_s = cfg.target_p99_ms / 1e3
        ongoing = self.state.avg_ongoing()
        if p99 > target_s and current_replicas < cfg.max_replicas:
            # SLO burning: add capacity now, BEFORE queue overflow
            # starts shedding (scale-before-shed ordering; the shed
            # counter moving means we were already too late).
            target = current_replicas + 1
            self.last_reason = (
                f"p99 {p99 * 1e3:.1f}ms > target "
                f"{cfg.target_p99_ms:g}ms: scale out")
            return self.state._apply_delay(target, current_replicas)
        if (current_replicas > cfg.min_replicas
                and p99 <= cfg.scale_in_p99_fraction * target_s
                and ongoing <= cfg.target_ongoing_requests
                * (current_replicas - 1)):
            # Signal-proven idle: tail well under target AND the
            # remaining replicas can absorb the observed load.
            self.last_reason = (
                f"idle (p99 {p99 * 1e3:.1f}ms, ongoing "
                f"{ongoing:.2f}): scale in")
            return self.state._apply_delay(current_replicas - 1,
                                           current_replicas)
        self.last_reason = "within-slo:hold"
        return self.state._apply_delay(current_replicas,
                                       current_replicas)


__all__ = ["AutoscalingConfig", "AutoscalingState",
           "SloAwareAutoscalingPolicy"]
