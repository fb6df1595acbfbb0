"""Fault-injection helpers for tests and chaos runs (counterpart of
``ray_tpu/util/chaos.py``).

The port runs one node: the ``worker``, ``actor`` and ``serve_replica``
kinds run; ``node``, ``preempt`` and ``partition`` act on node daemons
and raise NotImplementedError naming ROADMAP.md §1, item 7 (multi-node),
as the runtime's multi-node entry points do.

Reference analog (SURVEY.md §4.1(4)): ``ResourceKillerActor`` /
``WorkerKillerActor`` / ``kill_raylet`` in
python/ray/_private/test_utils.py — kill workers/actors/nodes on an
interval while a workload runs, asserting the system heals (task
retries, actor restarts, PG re-homing).
"""

from __future__ import annotations

import os
import random
import threading
import time


class ResourceKiller:
    """Periodically kills a random target while running.

    kind: "worker"  — SIGKILL a busy task worker process
          "actor"   — SIGKILL a random actor's worker process
          "node"    — remove a random non-head node (simulated node
                      failure; reference NodeKillerBase)
          "preempt" — gracefully drain-then-terminate a random
                      non-head node, exactly as a spot/preemption
                      termination notice would: work and objects
                      migrate off first, so a healthy drain path
                      shows ZERO user-visible failures and zero
                      lineage reconstructions
          "partition" — sever a random non-head node from the rest of
                      the cluster at the network level (one-way or
                      symmetric, chosen by the seeded RNG) for
                      ``partition_duration_s``, then heal. SILENT: no
                      RST, sends are swallowed, reads hang — the
                      failure mode the heartbeat/deadline hardening
                      exists for. Rules publish cluster-wide through
                      the ``RAY_TPU_CHAOS_FILE`` plan file (set the
                      env var BEFORE starting the cluster so every
                      daemon/worker polls it; pass ``plan_file`` to
                      override).
          "serve_replica" — SIGKILL a random READY serve replica
                      process (pid from the serve controller's
                      ``replica_pids()``). The serving zero-loss
                      contract is that in-flight requests on the
                      victim are re-dispatched by the router and the
                      controller respawns the replica.

    ``drain_deadline_s`` bounds each "preempt" drain (the kill loop
    blocks while it runs, mimicking the real notice-to-termination
    window).

    Determinism: every decision (victim, partition mode) is drawn
    only from the seeded RNG and the sorted candidate list, and is
    appended to ``self.decisions`` — the same seed over the same
    cluster membership replays the same kill/partition schedule
    (regression-tested in tests/test_partition_chaos.py).
    """

    _KINDS = ("worker", "actor", "node", "preempt", "partition",
              "serve_replica")
    # The kinds that act on node daemons.
    _MULTI_NODE = ("node", "preempt", "partition")
    _PARTITION_MODES = ("both", "send", "recv")

    def __init__(self, kind: str = "worker",
                 interval_s: float = 0.5,
                 max_kills: int | None = None,
                 seed: int | None = None, runtime=None,
                 drain_deadline_s: float = 10.0,
                 partition_duration_s: float = 2.0,
                 plan_file: str | None = None):
        if runtime is None:
            from ray_tpu_torch.core.api import get_runtime
            runtime = get_runtime()
        if kind not in self._KINDS:
            raise ValueError(f"unknown kill target {kind!r}")
        if kind in self._MULTI_NODE:
            from ray_tpu_torch.core.runtime import _multi_node
            raise _multi_node(f"ResourceKiller(kind={kind!r})")
        self.drain_deadline_s = drain_deadline_s
        self.kind = kind
        self.interval = interval_s
        self.max_kills = max_kills
        self.runtime = runtime
        self.kills = 0
        self.partition_duration_s = partition_duration_s
        self.plan_file = plan_file or os.environ.get(
            "RAY_TPU_CHAOS_FILE")
        if kind == "partition" and not self.plan_file:
            raise ValueError(
                "kind='partition' needs a chaos plan file: set "
                "RAY_TPU_CHAOS_FILE before starting the cluster (so "
                "daemons/workers inherit it) or pass plan_file=")
        # Audit trail for the deterministic-replay contract:
        # (kind, victim_node_id, mode) per fault.
        self.decisions: list[tuple] = []
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "ResourceKiller":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"chaos_{self.kind}")
        self._thread.start()
        return self

    def stop(self) -> int:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        return self.kills

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            if self.max_kills is not None and \
                    self.kills >= self.max_kills:
                return
            try:
                if self._kill_one():
                    self.kills += 1
            except Exception:  # noqa: BLE001 — chaos must not crash
                pass

    def _kill_one(self) -> bool:
        rt = self.runtime
        if self.kind == "serve_replica":
            return self._kill_serve_replica()
        if self.kind in ("node", "preempt", "partition"):
            # Sorted for determinism: the RNG draw must depend only
            # on the seed and the membership, never on dict order.
            nodes = sorted(
                (n["NodeID"] for n in rt.nodes()
                 if n["Alive"] and not n["IsHead"]
                 and not n.get("Draining")))
            if not nodes:
                return False
            victim = self._rng.choice(nodes)
            if self.kind == "partition":
                mode = self._rng.choice(self._PARTITION_MODES)
                self.decisions.append(("partition", victim, mode))
                self._partition(victim, mode)
                return True
            self.decisions.append((self.kind, victim, ""))
            if self.kind == "preempt":
                return bool(rt.drain_node(
                    victim, reason="chaos preemption notice",
                    deadline_s=self.drain_deadline_s, remove=True))
            rt.remove_node(victim)
            return True
        with rt._pool_lock:
            if self.kind == "worker":
                targets = [w for w in rt._workers
                           if not w.is_actor and w.busy and not w.dead]
            else:
                targets = [w for w in rt._workers
                           if w.is_actor and not w.dead]
        if not targets:
            return False
        victim = self._rng.choice(targets)
        try:
            victim.proc.kill()
        except Exception:  # noqa: BLE001
            return False
        return True

    def _kill_serve_replica(self) -> bool:
        """SIGKILL a random ready serve replica, chosen by the seeded
        RNG over the sorted (deployment, replica_tag) list so the same
        seed replays the same kill schedule."""
        import signal

        import ray_tpu_torch
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME
        try:
            controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            pids = ray_tpu_torch.get(controller.replica_pids.remote(),
                               timeout=5)
        except Exception:  # noqa: BLE001 — no serve controller yet
            return False
        candidates = sorted(
            (name, tag, pid)
            for name, tags in (pids or {}).items()
            for tag, pid in tags.items() if pid)
        if not candidates:
            return False
        name, tag, pid = self._rng.choice(candidates)
        self.decisions.append(("serve_replica", f"{name}/{tag}", ""))
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            return False
        return True

    def _partition(self, node_id: str, mode: str) -> None:
        """Silently sever ``node_id``'s network boundary for
        ``partition_duration_s``, then heal. ``mode``: "both" is a
        full isolation; "send"/"recv" are one-way links (the node can
        hear but not speak / speak but not hear). The loop blocks for
        the fault window, mirroring the real outage."""
        from ray_tpu_torch.core import wire
        rule = wire.FaultRule(
            "freeze", node=node_id, direction=mode,
            id=f"chaos-partition-{node_id[:12]}")
        wire.write_plan_file(self.plan_file, [rule])
        # Our own process must see the rule immediately too (the
        # driver's poll is best-effort otherwise).
        wire.fault_plan().maybe_refresh(force=True)
        try:
            deadline = time.monotonic() + self.partition_duration_s
            while not self._stop.wait(0.1):
                if time.monotonic() >= deadline:
                    break
        finally:
            wire.write_plan_file(self.plan_file, [])
            wire.fault_plan().maybe_refresh(force=True)
