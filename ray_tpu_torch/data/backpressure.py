"""Resource-aware streaming backpressure.

Reference analogs: the pluggable policy objects of
python/ray/data/_internal/execution/backpressure_policy/
(ConcurrencyCapBackpressurePolicy et al.) and the per-operator
accounting of execution/resource_manager.py. The streaming executor
consults a policy chain before EVERY task launch; policies see the
operator's usage and the live object-store occupancy, so a pipeline
with big blocks and a slow consumer stops launching producers instead
of OOM-ing the store.

Liveness rule (the reference reserves resources for at least one task
per operator for the same reason): a policy may always admit a launch
when the operator has NOTHING in flight — otherwise a consumer that
holds the over-budget bytes while waiting for the next block would
deadlock the pipeline. Store growth is thus bounded to ~one block per
operator past the budget, never unbounded.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field


@dataclass
class OpUsage:
    """Per-operator execution accounting (resource_manager.py's
    per-op usage rows)."""
    name: str
    in_flight: int = 0
    blocks_done: int = 0
    bytes_done: int = 0

    def avg_block_bytes(self, default: int = 1 << 20) -> int:
        if self.blocks_done == 0:
            return default
        return max(1, self.bytes_done // self.blocks_done)


class ResourceManager:
    """Process-wide registry of operator usages + store sampling."""

    def __init__(self):
        self._ops: list[OpUsage] = []
        self._lock = threading.Lock()
        self.peak_store_bytes = 0

    def register(self, name: str) -> OpUsage:
        u = OpUsage(name)
        with self._lock:
            self._ops.append(u)
            # Bounded history: one usage row per stage per execution
            # would otherwise grow for the life of the process.
            if len(self._ops) > 256:
                del self._ops[:len(self._ops) - 128]
        return u

    def op_usages(self) -> list[OpUsage]:
        with self._lock:
            return list(self._ops)

    def store_used_bytes(self) -> int:
        """Live shared-store occupancy (the budget the reference's
        resource manager guards)."""
        try:
            from ray_tpu_torch.core.api import get_runtime
            used = get_runtime().shm_store.used_bytes()
        except Exception:  # noqa: BLE001
            used = 0
        if used > self.peak_store_bytes:
            self.peak_store_bytes = used
        return used


def ref_nbytes(ref) -> int:
    """Best-effort stored size of a completed block ref (0 when the
    block lives in the in-process memory store or the size is not
    discoverable)."""
    try:
        from ray_tpu_torch.core.api import get_runtime
        lru = getattr(get_runtime().shm_store, "_lru", None)
        if lru is not None:
            return int(lru.get(ref.id, 0) or 0)
    except Exception:  # noqa: BLE001
        pass
    return 0


_manager: ResourceManager | None = None
_manager_lock = threading.Lock()


def get_resource_manager() -> ResourceManager:
    global _manager
    with _manager_lock:
        if _manager is None:
            _manager = ResourceManager()
        return _manager


class BackpressurePolicy:
    """One launch-admission rule; chained, all must admit."""

    def can_launch(self, usage: OpUsage,
                   manager: ResourceManager) -> bool:
        raise NotImplementedError


class ConcurrencyCapPolicy(BackpressurePolicy):
    """Static per-operator task cap (reference:
    concurrency_cap_backpressure_policy.py)."""

    def __init__(self, cap: int):
        self.cap = int(cap)

    def can_launch(self, usage: OpUsage,
                   manager: ResourceManager) -> bool:
        return usage.in_flight < self.cap

    def __repr__(self):
        return f"ConcurrencyCapPolicy(cap={self.cap})"


class StoreMemoryPolicy(BackpressurePolicy):
    """Admit a launch only while projected store occupancy stays
    under the budget (reference: the resource manager's object-store
    memory budget gating task submission). Projection = live usage +
    one average output block of this operator."""

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)

    def can_launch(self, usage: OpUsage,
                   manager: ResourceManager) -> bool:
        if usage.in_flight == 0:
            return True          # liveness: one task may always run
        if usage.blocks_done == 0:
            # Output size unknown: probe with a couple of tasks
            # before committing the fleet (reference: per-op
            # incremental usage is estimated from materialized
            # outputs; until then admission is conservative).
            return usage.in_flight < 2
        # In-flight tasks haven't hit the store yet — count them at
        # the operator's observed average output size, plus the one
        # being admitted.
        projected = (manager.store_used_bytes()
                     + (usage.in_flight + 1)
                     * usage.avg_block_bytes())
        return projected <= self.budget_bytes

    def __repr__(self):
        return f"StoreMemoryPolicy(budget={self.budget_bytes})"


def default_policies(max_in_flight: int) -> list[BackpressurePolicy]:
    """Policy chain from the DataContext knobs: always the
    concurrency cap; the store-memory guard when a budget is set."""
    from ray_tpu_torch.data.context import DataContext
    ctx = DataContext.get_current()
    chain: list[BackpressurePolicy] = [
        ConcurrencyCapPolicy(max_in_flight)]
    # The ExecutionOptions resource limit is read HERE (policy build
    # time), so the reference idiom of mutating the options in place
    # (ctx.execution_options.resource_limits.object_store_memory = N)
    # takes effect on the next execution — not only the assignment
    # form the property setter catches.
    opt_mem = ctx.execution_options.resource_limits.object_store_memory
    budget = (int(opt_mem) if opt_mem is not None
              else ctx.object_store_budget_bytes)
    if ctx.backpressure_policies is not None:
        chain.extend(ctx.backpressure_policies)
    elif budget > 0:
        chain.append(StoreMemoryPolicy(budget))
    return chain
