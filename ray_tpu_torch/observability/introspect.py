"""Pull-side cluster state debugger: ``memory_summary`` and
``cluster_status`` builders.

Reference analogs (SURVEY §L6): ``ray memory`` /
``ray._private.internal_api.memory_summary`` (who owns which
object-store bytes, pinned/spilled, per node) and ``ray status`` (the
autoscaler status block: per-node usage, pending demand). The head
runtime owns every table these read — object directory, ref counts,
node records, task/actor tables — so a summary is a lock-scoped
snapshot plus formatting, served to remote clients over ``OP_STATE``
verbs and to HTTP via ``/api/v1/{memory,status}``.
"""

from __future__ import annotations

import time

__all__ = ["memory_summary", "cluster_status",
           "format_memory_summary", "format_cluster_status"]


def _loc_row(loc, head_node_id: str) -> tuple[str, str]:
    """(location kind, node_id) for one directory entry."""
    if isinstance(loc, tuple):          # ("node", node_id)
        return "node", loc[1]
    if loc == "err":
        return "error", head_node_id
    return loc, head_node_id            # "mem" | "shm" on the head


def memory_summary(rt, top_n: int = 20) -> dict:
    """Cluster object-store summary: per-node usage plus the top-N
    objects by size with owner, ref counts, pin state, and
    primary/replica/spill placement."""
    with rt._obj_cv:
        locs = dict(rt._obj_locations)
        sizes = dict(rt._obj_sizes)
        replicas = {oid: sorted(nodes)
                    for oid, nodes in rt._obj_replicas.items()}
    with rt._ref_lock:
        refcounts = dict(rt._refcounts)
        borrows = dict(rt._borrows)
        container_pins = dict(rt._container_pins)
        escapes = {oid: len(n) for oid, n in rt._escape_nonces.items()
                   if n}
    with rt._res_cv:
        node_recs = list(rt._nodes.values())

    object_info = getattr(rt.shm_store, "object_info", None)
    rows = []
    per_node: dict[str, dict] = {}
    for oid, loc in locs.items():
        kind, node_id = _loc_row(loc, rt.head_node_id)
        size = sizes.get(oid, 0)
        spilled = False
        if kind == "shm" and object_info is not None:
            info = object_info(oid)
            if info is not None:
                size = size or info[0]
                spilled = info[1]
        elif kind == "mem" and not size:
            obj = rt.memory_store.try_get(oid)
            if obj is not None:
                size = obj.total_size
        tag = oid.owner_tag()
        owner = (rt._owner_tags.get(tag) if tag is not None
                 else None) or rt.head_node_id
        pins = {
            "local_refs": refcounts.get(oid, 0),
            "borrows": borrows.get(oid, 0),
            "container": container_pins.get(oid, 0),
            "in_flight": escapes.get(oid, 0),
        }
        rows.append({
            "object_id": oid.hex(),
            "size": int(size),
            "location": "spilled" if spilled else kind,
            "node_id": node_id,
            "owner": owner,
            "primary": kind != "error",
            "replicas": replicas.get(oid, []),
            "pinned": any(pins.values()),
            "pins": pins,
        })
        agg = per_node.setdefault(node_id, {"objects": 0, "bytes": 0})
        agg["objects"] += 1
        agg["bytes"] += int(size)

    nodes = []
    for n in node_recs:
        usage = per_node.get(n.node_id, {"objects": 0, "bytes": 0})
        row = {
            "node_id": n.node_id,
            "is_head": n.is_head,
            "alive": n.alive,
            "draining": n.draining,
            "objects": usage["objects"],
            "object_bytes": usage["bytes"],
        }
        if n.is_head:
            row["store_used_bytes"] = rt.shm_store.used_bytes()
            row["store_capacity_bytes"] = getattr(
                rt.shm_store, "_capacity", 0)
        else:
            # The daemon's versioned load report (ND_RSYNC) carries
            # its local store occupancy.
            row["store_used_bytes"] = int(
                (n.observed or {}).get("store_bytes", 0))
        nodes.append(row)

    rows.sort(key=lambda r: (-r["size"], r["object_id"]))
    return {
        "ts": time.time(),
        "totals": {
            "objects": len(rows),
            "bytes": sum(r["size"] for r in rows),
            "pinned": sum(1 for r in rows if r["pinned"]),
            "spilled": sum(1 for r in rows
                           if r["location"] == "spilled"),
            "replicated": sum(1 for r in rows if r["replicas"]),
        },
        "nodes": nodes,
        "top_objects": rows[:max(0, int(top_n))],
    }


def _demand_shapes(demand: list[dict]) -> list[dict]:
    """Aggregate the per-task demand list into ``{shape, count}``
    rows (the ``ray status`` pending-demand block)."""
    by_shape: dict[tuple, int] = {}
    for d in demand:
        key = tuple(sorted(d.items()))
        by_shape[key] = by_shape.get(key, 0) + 1
    return [{"shape": dict(k), "count": v}
            for k, v in sorted(by_shape.items(),
                               key=lambda kv: -kv[1])]


def cluster_status(rt) -> dict:
    """``ray status`` analog: per-node resource usage and drain
    state, pending/running task and actor counts, worker pool, and
    the autoscaler's input/intent (unmet demand + explicit
    requests)."""
    with rt._res_cv:
        node_recs = list(rt._nodes.values())
        pending = rt.pending_count()
    with rt._task_lock:
        running = sum(1 for r in rt._tasks.values()
                      if r.state == "RUNNING")
        total_tracked = len(rt._tasks)
        finished = len(rt._done_tasks)
    actor_counts: dict[str, int] = {}
    with rt._actor_lock:
        for rec in rt._actors.values():
            actor_counts[rec.state] = actor_counts.get(rec.state,
                                                       0) + 1
    with rt._pool_lock:
        workers_total = len(rt._workers)
        idle = sum(len(v) for v in rt._idle.values())
        per_node_workers: dict[str, int] = {}
        for w in rt._workers:
            per_node_workers[w.node_id] = \
                per_node_workers.get(w.node_id, 0) + 1

    nodes = []
    for n in node_recs:
        state = ("DEAD" if not n.alive
                 else "DRAINING" if n.draining else "ALIVE")
        used = {k: round(v - n.avail.get(k, 0.0), 6)
                for k, v in n.resources.items()}
        nodes.append({
            "node_id": n.node_id,
            "state": state,
            "is_head": n.is_head,
            "hostname": n.hostname,
            "resources_total": dict(n.resources),
            "resources_available": dict(n.avail),
            "resources_used": used,
            "drain_reason": n.drain_reason,
            "workers": per_node_workers.get(n.node_id, 0),
            "observed": dict(n.observed or {}),
            "labels": dict(n.labels),
        })

    demand = rt.resource_demand()
    head = dict(rt.admission.snapshot(pending))
    head["loop_lag_ms"] = round(
        getattr(rt, "_head_loop_lag_s", 0.0) * 1000.0, 3)
    return {
        "ts": time.time(),
        "nodes": nodes,
        "tasks": {"pending": pending, "running": running,
                  "tracked": total_tracked, "finished": finished},
        "head": head,
        "actors": actor_counts,
        "workers": {"total": workers_total, "idle": idle},
        "autoscaler": {
            "pending_demand": _demand_shapes(demand),
            "demand_count": len(demand),
            "explicit_requests": rt.explicit_resource_requests(),
        },
        "observability": {
            "metric_pushes_ingested":
                rt.observability.pushes_ingested,
            "task_events_tracked": len(rt.observability.task_events),
            "tracestore": rt.observability.traces.self_health(),
            "signals": rt.observability.signals.stats(),
        },
        # SLO burn-rate verdicts from the signals plane (the
        # ``ray_tpu alerts`` payload's alert list, inlined here so
        # one status call answers "is anything on fire").
        "alerts": list(rt.observability.slo.last_alerts),
    }


# ---------------------------------------------------------------------------
# text rendering (CLI)
# ---------------------------------------------------------------------------

def _human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return (f"{n:.0f} {unit}" if unit == "B"
                    else f"{n:.1f} {unit}")
        n /= 1024
    return f"{n:.1f} TiB"


def format_memory_summary(ms: dict) -> str:
    t = ms["totals"]
    lines = [
        "== ray_tpu memory ==",
        f"objects: {t['objects']}  bytes: "
        f"{_human_bytes(t['bytes'])}  pinned: {t['pinned']}  "
        f"spilled: {t['spilled']}  replicated: {t['replicated']}",
        "",
        "per-node object store:",
    ]
    for n in ms["nodes"]:
        role = "head" if n["is_head"] else "node"
        extra = ""
        if n.get("store_capacity_bytes"):
            extra = (f" (store {_human_bytes(n['store_used_bytes'])}"
                     f" / {_human_bytes(n['store_capacity_bytes'])})")
        elif n.get("store_used_bytes"):
            extra = f" (store {_human_bytes(n['store_used_bytes'])})"
        lines.append(
            f"  {n['node_id'][:16]:<16} {role:<5} "
            f"{n['objects']:>6} objs  "
            f"{_human_bytes(n['object_bytes']):>10}{extra}")
    lines += ["", f"top {len(ms['top_objects'])} objects by size:"]
    lines.append(f"  {'object_id':<20} {'size':>10} {'loc':<8} "
                 f"{'node':<12} {'refs':>4} {'borrows':>7} "
                 f"{'pin':>3} replicas")
    for r in ms["top_objects"]:
        lines.append(
            f"  {r['object_id'][:20]:<20} "
            f"{_human_bytes(r['size']):>10} {r['location']:<8} "
            f"{r['node_id'][:12]:<12} {r['pins']['local_refs']:>4} "
            f"{r['pins']['borrows']:>7} "
            f"{'y' if r['pinned'] else 'n':>3} "
            f"{len(r['replicas'])}")
    return "\n".join(lines) + "\n"


def format_cluster_status(cs: dict) -> str:
    lines = ["== ray_tpu cluster status =="]
    alive = [n for n in cs["nodes"] if n["state"] == "ALIVE"]
    lines.append(f"nodes: {len(alive)} alive / {len(cs['nodes'])} "
                 f"total")
    for n in cs["nodes"]:
        res = ", ".join(
            f"{k} {n['resources_used'].get(k, 0):g}/"
            f"{n['resources_total'][k]:g}"
            for k in sorted(n["resources_total"]))
        drain = (f"  drain: {n['drain_reason']}"
                 if n["state"] == "DRAINING" else "")
        lines.append(
            f"  {n['node_id'][:16]:<16} {n['state']:<8} "
            f"workers={n['workers']:<3} {res}{drain}")
    t = cs["tasks"]
    lines.append(f"tasks: {t['pending']} pending, {t['running']} "
                 f"running, {t['finished']} finished")
    h = cs.get("head")
    if h:
        extra = ""
        if h.get("admissions_rejected"):
            extra = (f", rejected={h['admissions_rejected']}"
                     f" (dials={h.get('dials_rejected', 0)})")
        lines.append(
            f"head: queue {h['queue_depth']}/{h['high_water']} "
            f"admission={h['state']} "
            f"lag={h.get('loop_lag_ms', 0):g}ms{extra}")
    alerts = cs.get("alerts") or []
    if alerts:
        firing = [a for a in alerts if a["state"] != "OK"]
        lines.append(f"alerts: {len(firing)} firing / "
                     f"{len(alerts)} rules")
        for a in firing[:8]:
            lines.append(
                f"  [{a['state']}] {a['rule']}: "
                f"burn fast={a['burn_fast']:.2f} "
                f"slow={a['burn_slow']:.2f} "
                f"(value={a['value_fast']} target={a['target']:g})")
    ts = (cs.get("observability") or {}).get("tracestore")
    if ts:
        lines.append(
            f"tracestore: {ts['traces_retained']} retained, "
            f"{ts['traces_dropped']} dropped, "
            f"{ts['orphans_adopted']} orphans adopted, "
            f"{ts['spans_deduped']} deduped")
    if cs["actors"]:
        lines.append("actors: " + ", ".join(
            f"{k}={v}" for k, v in sorted(cs["actors"].items())))
    w = cs["workers"]
    lines.append(f"workers: {w['total']} total, {w['idle']} idle")
    a = cs["autoscaler"]
    if a["demand_count"]:
        lines.append(f"pending demand ({a['demand_count']} "
                     f"requests):")
        for row in a["pending_demand"][:8]:
            lines.append(f"  {row['count']:>5} x {row['shape']}")
    else:
        lines.append("pending demand: none")
    if a["explicit_requests"]:
        lines.append(
            f"explicit resource requests: {a['explicit_requests']}")
    return "\n".join(lines) + "\n"
