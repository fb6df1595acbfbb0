"""DataContext — per-process execution knobs for Datasets.

Reference analog: ray.data.DataContext / ExecutionOptions
(python/ray/data/context.py): a get_current() singleton whose fields
tune the streaming executor. Fields here map to the knobs our
executor actually honors.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field


@dataclass
class ExecutionResources:
    """Resource amounts for execution limits (reference:
    ray.data.ExecutionResources). ``object_store_memory`` is the knob
    this executor honors (bytes; it feeds the store-byte backpressure
    budget); cpu/gpu are recorded for compatibility."""

    cpu: float | None = None
    gpu: float | None = None
    object_store_memory: int | None = None


@dataclass
class ExecutionOptions:
    """(reference: ray.data.ExecutionOptions) Apply via
    ``DataContext.get_current().execution_options = opts``:
    ``resource_limits.object_store_memory`` maps onto the
    store-byte backpressure budget."""

    resource_limits: ExecutionResources = field(
        default_factory=ExecutionResources)
    locality_with_output: bool = False
    preserve_order: bool = True  # our executor yields in order
    verbose_progress: bool = False


@dataclass
class DataContext:
    # Max block tasks in flight per stage (streaming backpressure).
    max_in_flight: int = 16
    # Object-store occupancy budget for task launches (bytes; 0 =
    # unlimited). When set, stages stop launching while the store is
    # past the budget — see data.backpressure.StoreMemoryPolicy
    # (reference: resource_manager.py store memory gating).
    object_store_budget_bytes: int = 0
    # Full custom policy chain (list of BackpressurePolicy); None =
    # built from the knobs above (reference: the pluggable
    # backpressure_policy/ registry).
    backpressure_policies: list | None = None
    # Default parallelism for range/from_* sources.
    default_parallelism: int = 8
    # Hash-shuffle partition cap for groupby.
    groupby_num_partitions: int = 8
    # Device-prefetch depth for iter_device_batches.
    prefetch_batches: int = 2

    # Progress-bar toggle (reference: set_progress_bars) — consumed
    # by Dataset.stats()/iter wrappers that print progress.
    enable_progress_bars: bool = True

    _current = None
    _lock = threading.Lock()

    @classmethod
    def get_current(cls) -> "DataContext":
        with cls._lock:
            if cls._current is None:
                cls._current = cls()
            return cls._current

    @property
    def execution_options(self) -> ExecutionOptions:
        opts = getattr(self, "_execution_options", None)
        if opts is None:
            opts = ExecutionOptions()
            self._execution_options = opts
        return opts

    @execution_options.setter
    def execution_options(self, opts: ExecutionOptions) -> None:
        self._execution_options = opts
        mem = opts.resource_limits.object_store_memory
        if mem is not None:
            self.object_store_budget_bytes = int(mem)


def set_progress_bars(enabled: bool) -> bool:
    """(reference: ray.data.set_progress_bars) Returns the previous
    setting."""
    ctx = DataContext.get_current()
    prev = ctx.enable_progress_bars
    ctx.enable_progress_bars = bool(enabled)
    return prev


# Classic-name alias (reference kept both spellings alive).
DatasetContext = DataContext
