"""Usage stats + export events (counterpart of ``ray_tpu/util/usage.py``;
the opt-out variable keeps the JAX package's name,
``RAY_TPU_USAGE_STATS_ENABLED``).

Reference analogs (SURVEY.md §5.5): anonymized usage collection
(python/ray/_private/usage/usage_lib.py:95 — opt-out via env var) and
the export-event stream (src/ray/protobuf/export_api/): task/actor
lifecycle records written as JSONL for external pipelines.

Everything is LOCAL here: usage is summarized to a JSON file in the
session dir (never transmitted anywhere), and export events are an
opt-in JSONL sink over the runtime's event buffer.
"""

from __future__ import annotations

import json
import os
import time


def usage_stats_enabled() -> bool:
    """Opt-out switch (reference: RAY_USAGE_STATS_ENABLED)."""
    return os.environ.get("RAY_TPU_USAGE_STATS_ENABLED", "1") not in (
        "0", "false", "False")


def collect_usage(runtime=None) -> dict:
    """Anonymous, local-only usage summary of the current session."""
    if runtime is None:
        from ray_tpu_torch.core.api import get_runtime
        runtime = get_runtime()
    from ray_tpu_torch.util import state as state_api
    from ray_tpu_torch import __version__
    summary = state_api.summarize_tasks()
    total = {"FINISHED": 0, "FAILED": 0}
    for states in summary.get("tasks", {}).values():
        for k in total:
            total[k] += states.get(k, 0)
    return {
        "version": __version__,
        "collected_at": time.time(),
        "num_nodes": summary.get("node_count", 0),
        "cluster_resources": runtime.cluster_resources(),
        "tasks_finished": total["FINISHED"],
        "tasks_failed": total["FAILED"],
        "num_actors": len(state_api.list_actors()),
    }


def write_usage_report(path: str | None = None, runtime=None) -> str | None:
    if not usage_stats_enabled():
        return None
    if runtime is None:
        from ray_tpu_torch.core.api import get_runtime
        runtime = get_runtime()
    if path is None:
        path = os.path.join(
            os.path.dirname(runtime.client_address), "usage.json")
    with open(path, "w") as f:
        json.dump(collect_usage(runtime), f)
    return path


def export_events(path: str, runtime=None) -> int:
    """Dump the runtime's task lifecycle events as JSONL (the
    export-API sink). Returns the number of records written."""
    if runtime is None:
        from ray_tpu_torch.core.api import get_runtime
        runtime = get_runtime()
    for attempt in range(5):
        try:
            events = runtime.task_events()
            break
        except RuntimeError:     # deque mutated during iteration
            if attempt == 4:
                raise RuntimeError(
                    "could not snapshot the event buffer (runtime too "
                    "busy); retry when task churn settles")
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")
    return len(events)
