"""Core system metrics fed into the Prometheus registry.

Reference analog: the ~80 native OpenCensus metric definitions the
reference's components record (src/ray/stats/metric_defs.cc) and the
per-node reporter agent's system stats — surfaced through the same
``/metrics`` endpoint the dashboard already serves. Here a sampler
thread on the head reads the runtime's live state (scheduler queues,
actor table, object store, agent samples) into Gauges; user metrics
(ray_tpu_torch.util.metrics) share the registry, so one scrape sees
both. The gauge names are the JAX package's (``ray_tpu_*``).
"""

from __future__ import annotations

import threading

from ray_tpu_torch.util.metrics import Gauge

_SINGLETON_LOCK = threading.Lock()
_COLLECTOR = None


class SystemMetricsCollector:
    def __init__(self, runtime, period_s: float = 5.0):
        self._rt = runtime
        self._period = period_s
        g = {
            "nodes_alive": Gauge(
                "ray_tpu_nodes_alive", "alive cluster nodes"),
            "tasks_pending": Gauge(
                "ray_tpu_tasks_pending",
                "tasks queued for scheduling"),
            "tasks_running": Gauge(
                "ray_tpu_tasks_running", "tasks executing now"),
            "actors_alive": Gauge(
                "ray_tpu_actors_alive", "actors in ALIVE state"),
            "workers": Gauge(
                "ray_tpu_workers_total", "live worker processes"),
            "store_bytes": Gauge(
                "ray_tpu_object_store_bytes",
                "shared-memory store bytes in use"),
            "objects": Gauge(
                "ray_tpu_objects_total",
                "objects tracked by the owner directory"),
            "node_cpu": Gauge(
                "ray_tpu_node_cpu_percent",
                "per-node CPU utilization", tag_keys=("node",)),
            "node_mem": Gauge(
                "ray_tpu_node_mem_used_bytes",
                "per-node memory in use", tag_keys=("node",)),
            # Object plane (PR-1 counters surfaced as metrics).
            "deser_hits": Gauge(
                "ray_tpu_deser_cache_hits",
                "deserialization-cache hits (driver process)"),
            "deser_misses": Gauge(
                "ray_tpu_deser_cache_misses",
                "deserialization-cache misses (driver process)"),
            # Robustness / drain (PR-2 counters surfaced as metrics).
            "lineage_recon": Gauge(
                "ray_tpu_lineage_reconstructions",
                "lineage re-executions launched for object recovery"),
            "drains_started": Gauge(
                "ray_tpu_drains_started", "node drains started"),
            "drains_completed": Gauge(
                "ray_tpu_drains_completed", "node drains completed"),
            "drain_preempted": Gauge(
                "ray_tpu_drain_tasks_preempted",
                "tasks preempted (attempt refunded) by drains"),
            "drain_migrated": Gauge(
                "ray_tpu_drain_actors_migrated",
                "actors migrated off draining nodes"),
            "drain_evacuated": Gauge(
                "ray_tpu_drain_objects_evacuated",
                "primary objects evacuated off draining nodes"),
            # The observability plane watching itself.
            "obs_pushes": Gauge(
                "ray_tpu_metrics_pushes_ingested",
                "exporter flush frames ingested by the head"),
            "obs_tasks": Gauge(
                "ray_tpu_task_event_store_tasks",
                "distinct tasks tracked by the cluster event store"),
            "obs_stale": Gauge(
                "ray_tpu_metrics_stale_series",
                "series hidden from the scrape (owning node dead or "
                "draining)"),
            "spans_dropped": Gauge(
                "ray_tpu_tracing_spans_dropped",
                "tracing spans lost to ring overflow or bounded "
                "export-failure requeue (this process)"),
        }
        self._g = g
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="system_metrics")

    def start(self) -> "SystemMetricsCollector":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def sample_once(self) -> None:
        rt = self._rt
        g = self._g
        try:
            nodes = list(getattr(rt, "_nodes", {}).values())
            g["nodes_alive"].set(
                float(sum(1 for n in nodes if n.alive)))
            g["tasks_pending"].set(float(rt.pending_count()))
            with rt._task_lock:
                running = sum(1 for r in rt._tasks.values()
                              if r.state == "RUNNING")
            g["tasks_running"].set(float(running))
            with rt._actor_lock:
                alive = sum(1 for a in rt._actors.values()
                            if a.state == "ALIVE")
            g["actors_alive"].set(float(alive))
            with rt._pool_lock:
                g["workers"].set(float(len(rt._workers)))
            g["store_bytes"].set(float(rt.shm_store.used_bytes()))
            g["objects"].set(float(len(rt._obj_locations)))
            for node_id, stats in dict(
                    getattr(rt, "_agent_stats", {})).items():
                tag = {"node": node_id[:12]}
                if "cpu_percent" in stats:
                    g["node_cpu"].set(
                        float(stats["cpu_percent"]), tags=tag)
                if stats.get("mem_used"):
                    g["node_mem"].set(
                        float(stats["mem_used"]), tags=tag)
            g["deser_hits"].set(float(
                getattr(rt, "deser_cache_hits", 0)))
            g["deser_misses"].set(float(
                getattr(rt, "deser_cache_misses", 0)))
            g["lineage_recon"].set(float(
                getattr(rt, "lineage_reconstructions", 0)))
            g["drains_started"].set(float(
                getattr(rt, "drains_started", 0)))
            g["drains_completed"].set(float(
                getattr(rt, "drains_completed", 0)))
            g["drain_preempted"].set(float(
                getattr(rt, "drain_tasks_preempted", 0)))
            g["drain_migrated"].set(float(
                getattr(rt, "drain_actors_migrated", 0)))
            g["drain_evacuated"].set(float(
                getattr(rt, "drain_objects_evacuated", 0)))
            plane = getattr(rt, "observability", None)
            if plane is not None:
                g["obs_pushes"].set(float(plane.pushes_ingested))
                g["obs_tasks"].set(float(len(plane.task_events)))
                g["obs_stale"].set(float(
                    plane.aggregator.stale_series_count()))
            from ray_tpu_torch.util.tracing import get_tracer
            g["spans_dropped"].set(float(get_tracer().spans_dropped))
        except Exception:  # noqa: BLE001 — sampling must never kill
            pass           # the thread; partial samples are fine

    def _loop(self) -> None:
        while not self._stop.wait(self._period):
            self.sample_once()


def start_system_metrics(runtime,
                         period_s: float = 5.0
                         ) -> SystemMetricsCollector:
    """Idempotent: one collector per process."""
    global _COLLECTOR
    with _SINGLETON_LOCK:
        if _COLLECTOR is None or _COLLECTOR._rt is not runtime:
            if _COLLECTOR is not None:
                _COLLECTOR.stop()
            _COLLECTOR = SystemMetricsCollector(
                runtime, period_s).start()
        return _COLLECTOR
