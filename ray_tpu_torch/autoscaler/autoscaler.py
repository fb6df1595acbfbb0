"""The autoscaler reconciler.

Reference analog: autoscaler v2 (python/ray/autoscaler/v2/
autoscaler.py:42 + instance_manager/reconciler.py:53 + scheduler.py):
each ``update()`` reads (demand, current nodes) and computes a target
instance set — launches what's missing, terminates what idled out.
Demand bin-packing mirrors resource_demand_scheduler.py: first-fit of
pending requests onto existing free capacity, then onto hypothetical
new nodes of configured types, cheapest-first.

GPU shape: a node type is an atomic host of cards; a gang request
(a whole placement group worth of bundles, e.g. four ``{"GPU": 1}``
bundles under ``STRICT_PACK``) either fits a node type or forces a
bigger one — a multi-card type is launched whole, never in part.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ray_tpu_torch.autoscaler.node_provider import NodeProvider


@dataclass
class NodeTypeConfig:
    name: str
    resources: dict[str, float]
    min_workers: int = 0
    max_workers: int = 10


@dataclass
class AutoscalerConfig:
    node_types: list[NodeTypeConfig]
    idle_timeout_s: float = 60.0
    update_interval_s: float = 1.0
    # Upper bound on nodes launched per update (reference:
    # upscaling_speed).
    max_launches_per_update: int = 8
    # Scale-down drains the victim node (migrating any straggler
    # work and evacuating its stored objects) before the provider
    # terminates it; this bounds that drain (reference: autoscaler
    # termination hooks run DrainNode first).
    drain_before_terminate: bool = True
    drain_deadline_s: float = 30.0


def _fits(avail: dict[str, float], need: dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) >= v - 1e-9 for k, v in need.items())


def _take(avail: dict[str, float], need: dict[str, float]) -> None:
    for k, v in need.items():
        avail[k] = avail.get(k, 0.0) - v


class Autoscaler:
    """Reconciles node count against observed resource demand."""

    def __init__(self, config: AutoscalerConfig,
                 provider: NodeProvider, runtime=None):
        if runtime is None:
            from ray_tpu_torch.core.api import get_runtime
            runtime = get_runtime()
        self.config = config
        self.provider = provider
        self.runtime = runtime
        self._idle_since: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.launched_total = 0
        self.terminated_total = 0

    # -- lifecycle --

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.config.update_interval_s):
            try:
                self.update()
            except Exception:  # noqa: BLE001 — reconciler must survive
                pass

    # -- one reconcile pass --

    def update(self) -> dict:
        demand = self.runtime.resource_demand()
        explicit = []
        getter = getattr(self.runtime, "explicit_resource_requests",
                         None)
        if getter is not None:
            explicit = getter()
        # request_resources is a floor on TOTAL capacity (reference:
        # resource_demand_scheduler packs the request against node
        # totals) — packing it against FREE capacity would relaunch a
        # node every pass once user work occupies the floor.
        floor = self._pack_onto_types(explicit)
        launched = self._scale_up(demand, floor)
        terminated = self._scale_down(floor)
        return {"demand": len(demand) + len(explicit),
                "launched": launched, "terminated": terminated}

    def _pack_onto_types(self, requests: list[dict]
                         ) -> dict[str, int]:
        """First-fit ``requests`` onto hypothetical empty nodes
        (cheapest type that fits, open nodes absorb later requests);
        returns nodes-per-type. Shared by the explicit-floor scale-up
        and the idle-protection check so they can never disagree."""
        need: dict[str, int] = {}
        if not requests:
            return need
        types = sorted(self.config.node_types,
                       key=lambda t: sum(t.resources.values()))
        open_nodes: list[dict] = []
        for req in requests:
            placed = False
            for avail in open_nodes:
                if _fits(avail, req):
                    _take(avail, req)
                    placed = True
                    break
            if placed:
                continue
            for nt in types:
                if _fits(nt.resources, req):
                    avail = dict(nt.resources)
                    _take(avail, req)
                    open_nodes.append(avail)
                    need[nt.name] = need.get(nt.name, 0) + 1
                    break
            # infeasible requests are skipped (matching _scale_up)
        return need

    def _counts_by_type(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for n in self.provider.non_terminated_nodes():
            counts[n.node_type] = counts.get(n.node_type, 0) + 1
        return counts

    def _scale_up(self, demand: list[dict[str, float]],
                  floor: dict[str, int] | None = None) -> int:
        # 1) satisfy min_workers AND the explicit request_resources
        #    floor (deficit vs TOTAL per-type count, busy or idle)
        counts = self._counts_by_type()
        launched = 0
        for nt in self.config.node_types:
            want = max(nt.min_workers, (floor or {}).get(nt.name, 0))
            want = min(want, nt.max_workers)
            while (counts.get(nt.name, 0) < want
                   and launched < self.config.max_launches_per_update):
                self.provider.create_node(nt.name, nt.resources)
                counts[nt.name] = counts.get(nt.name, 0) + 1
                launched += 1
                self.launched_total += 1
        if not demand:
            return launched

        # 2) first-fit pending demand onto current free capacity.
        # Draining nodes are about to disappear — counting their free
        # capacity would suppress the replacement launch until after
        # they die.
        free = [dict(n["Available"])
                for n in self.runtime.nodes()
                if n["Alive"] and not n.get("Draining")]
        unmet: list[dict[str, float]] = []
        for req in demand:
            for avail in free:
                if _fits(avail, req):
                    _take(avail, req)
                    break
            else:
                unmet.append(req)

        # 3) bin-pack what's left onto hypothetical new nodes,
        #    smallest node type that fits first (one request may open
        #    a node that then absorbs later requests).
        planned: list[tuple[NodeTypeConfig, dict[str, float]]] = []
        types = sorted(self.config.node_types,
                       key=lambda t: sum(t.resources.values()))
        for req in unmet:
            placed = False
            for _nt, avail in planned:
                if _fits(avail, req):
                    _take(avail, req)
                    placed = True
                    break
            if placed:
                continue
            for nt in types:
                if (counts.get(nt.name, 0)
                        + sum(1 for p, _ in planned if p is nt)
                        >= nt.max_workers):
                    continue
                if _fits(nt.resources, req):
                    avail = dict(nt.resources)
                    _take(avail, req)
                    planned.append((nt, avail))
                    break
            # infeasible requests are skipped (reference: infeasible
            # demand is reported, not crashed on)

        for nt, _avail in planned:
            if launched >= self.config.max_launches_per_update:
                break
            self.provider.create_node(nt.name, nt.resources)
            launched += 1
            self.launched_total += 1
        return launched

    def _scale_down(self, floor: dict[str, int] | None = None) -> int:
        now = time.monotonic()
        counts = self._counts_by_type()
        protected = floor or {}
        by_id = {n["NodeID"]: n for n in self.runtime.nodes()}
        terminated = 0
        for node in self.provider.non_terminated_nodes():
            info = by_id.get(node.node_id)
            if info is None or not info["Alive"]:
                self._idle_since.pop(node.node_id, None)
                continue
            busy = (info["Available"] != info["Resources"]
                    or info.get("alive_workers", 0) > 0)
            if not busy and counts.get(node.node_type, 0) <= \
                    protected.get(node.node_type, 0):
                # request_resources floor holds this capacity up even
                # while idle (reference: explicit requests persist)
                self._idle_since.pop(node.node_id, None)
                continue
            if busy:
                self._idle_since.pop(node.node_id, None)
                continue
            first_idle = self._idle_since.setdefault(node.node_id, now)
            nt = next((t for t in self.config.node_types
                       if t.name == node.node_type), None)
            at_min = (nt is not None
                      and counts.get(node.node_type, 0)
                      <= nt.min_workers)
            if not at_min and now - first_idle \
                    >= self.config.idle_timeout_s:
                # Drain first: the node looked idle at the last poll,
                # but work may have landed since (and its store may
                # hold task results other nodes still reference) —
                # terminating with anything in flight would burn
                # retry budget and trigger lineage reconstruction on
                # a failure we scheduled ourselves.
                if self.config.drain_before_terminate:
                    drain = getattr(self.runtime, "drain_node", None)
                    if drain is not None:
                        try:
                            drain(node.node_id,
                                  reason="autoscaler scale-down",
                                  deadline_s=self.config
                                  .drain_deadline_s)
                        except Exception:  # noqa: BLE001
                            pass
                self.provider.terminate_node(node.node_id)
                counts[node.node_type] = counts.get(
                    node.node_type, 1) - 1
                self._idle_since.pop(node.node_id, None)
                terminated += 1
                self.terminated_total += 1
        return terminated
