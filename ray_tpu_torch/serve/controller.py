"""ServeController: the reconciling control plane.

Reference analog: ServeController (controller.py:86) + DeploymentState
reconcile (deployment_state.py:1232): desired state (deployments map)
vs live state (replica actors); a background loop starts/stops
replicas to converge, respawns dead ones, and bumps a version so
routers refresh their replica sets. Deployment autoscaling
(autoscaling_state.py) runs inside the same loop: replica queue
lengths recorded each pass drive the ceil(ongoing/target) policy.

Replica health plane (reference: DeploymentState health checking):

- **Readiness gating**: a spawned replica sits in ``starting`` —
  receiving NO traffic — until its first successful ``probe()``
  (stats + the user ``check_health()`` hook in one RPC) moves it into
  the pushed routing table. One that never passes within
  ``serve_replica_startup_timeout_s`` is torn down and respawned.
- **Ejection**: ready replicas are probed every
  ``serve_health_check_period_s``; ``serve_health_check_failure_threshold``
  consecutive failures (probe error, timeout, or check_health raising)
  eject the replica from the routing table, kill it, and respawn. A
  replica whose actor is already DEAD is ejected immediately — there
  is nothing to wait out.
- **Graceful stopping**: scale-down / redeploy / node-drain victims
  get ``prepare_stop()`` (replica sheds new work after a stale-router
  grace, drains in-flight) and are reaped once idle or at the drain
  deadline — both config knobs.
"""

from __future__ import annotations

import threading
import time

import ray_tpu_torch
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.exceptions import ActorDiedError
from ray_tpu_torch.serve.autoscaling import (AutoscalingConfig,
                                       AutoscalingState,
                                       SloAwareAutoscalingPolicy)
from ray_tpu_torch.serve.replica import Replica

CONTROLLER_NAME = "ray_tpu_serve_controller"


@ray_tpu_torch.remote
class ServeController:
    def __init__(self):
        # name -> spec dict(cls, args, kwargs, num_replicas, resources)
        self.desired: dict[str, dict] = {}
        self.replicas: dict[str, list] = {}
        # name -> [(replica, spawn_ts)] — spawned, not yet past the
        # readiness gate, receiving no traffic.
        self.starting: dict[str, list] = {}
        self.versions: dict[str, int] = {}
        # name -> policy object (AutoscalingState or
        # SloAwareAutoscalingPolicy), duck-typed record()/decide()
        self.autoscaling: dict = {}
        # name -> {model_id -> [replica indices]} from last probe
        self.model_map: dict[str, dict[str, list[int]]] = {}
        # name -> {actor_id hex -> consecutive failed probes}
        self.health: dict[str, dict[str, int]] = {}
        # name -> {replica tag -> pid} from last probe (chaos tooling
        # kills serve replicas by pid through this).
        self.pids: dict[str, dict[str, int]] = {}
        self._last_probe: dict[str, float] = {}
        # scale-down victims draining in-flight requests before kill:
        # name -> [(replica, deadline, not_before)]
        self.draining: dict[str, list] = {}
        self._stop = False
        self._rec_lock = threading.Lock()
        from ray_tpu_torch.util.metrics import Counter
        self._m_ejections = Counter(
            "ray_tpu_serve_health_ejections_total",
            "replicas ejected from routing by failed health probes",
            tag_keys=("deployment",))
        # Long-poll wakeups (reference: LongPollHost, long_poll.py:177)
        # — routers block in listen_for_change until a version bump.
        self._version_cv = threading.Condition()
        self._thread = threading.Thread(target=self._reconcile_loop,
                                        daemon=True)
        self._thread.start()

    def _bump_version(self, name: str) -> None:
        with self._version_cv:
            self.versions[name] = self.versions.get(name, 0) + 1
            self._version_cv.notify_all()

    # -- desired state --

    def deploy(self, name: str, cls_blob: bytes, init_args, init_kwargs,
               num_replicas: int, resources: dict,
               autoscaling_config: dict | None = None,
               user_config=None,
               max_ongoing_requests: int | None = None) -> bool:
        from ray_tpu_torch.core import serialization as ser
        old = self.desired.get(name)
        # ONE definition of "the replica-visible spec is unchanged":
        # both the lightweight-update test and the drain-replace test
        # below negate the same flag.
        same_spec = (old is not None
                     and old.get("cls_blob") == cls_blob
                     and old["args"] == init_args
                     and old["kwargs"] == init_kwargs
                     and old["resources"] == (resources or {})
                     and old.get("max_ongoing_requests")
                     == max_ongoing_requests)
        if same_spec and user_config != old.get("user_config"):
            # Lightweight update (reference: user_config semantics —
            # a redeploy changing ONLY user_config reconfigures live
            # replicas in place, no restart). APPLY first, commit
            # after: a raising reconfigure must not leave the desired
            # state carrying a config that crash-loops every future
            # replica spawn. Runs even when autoscaling_config ALSO
            # changed — skipping it left live replicas silently
            # serving the old user_config (the redeploy dead zone).
            # Starting replicas got the OLD config at construction,
            # so they reconfigure too.
            errs = []
            targets = list(self.replicas.get(name, [])) + \
                [r for (r, _) in self.starting.get(name, [])]
            for r in targets:
                try:
                    ray_tpu_torch.get(r.reconfigure.remote(user_config),
                                timeout=30)
                except Exception as e:  # noqa: BLE001
                    errs.append(str(e))
            if errs:
                raise RuntimeError(
                    f"reconfigure failed on {len(errs)} replica(s) "
                    f"(desired state keeps the previous user_config; "
                    f"replicas may be mixed until redeploy): "
                    f"{errs[0]}")
            old["user_config"] = user_config
            if (autoscaling_config or None) \
                    == old.get("autoscaling_raw"):
                if name not in self.autoscaling:
                    # an autoscaler owns the replica count; the static
                    # number must not clobber its decision
                    old["num_replicas"] = num_replicas
                self._bump_version(name)
                return True
            # autoscaling changed too: fall through to rebuild the
            # desired state and autoscaling below (same_spec holds, so
            # no drain-replace — replicas are already reconfigured).
        if old is not None and not same_spec:
            # CODE/arg change: existing replicas run the old
            # deployment — drain-replace them (reference: redeploys
            # roll replicas to the new version; without this a
            # redeploy silently keeps serving old code forever).
            # Under _rec_lock: the reconcile thread must not write a
            # stale `live` list back and resurrect popped replicas.
            # Starting replicas never served: killed outright.
            with self._rec_lock:
                for r in self.replicas.pop(name, []):
                    self._start_draining(name, r)
                for (r, _) in self.starting.pop(name, []):
                    self._kill_quietly(r)
                self.health.pop(name, None)
        self.desired[name] = {
            "cls": ser.loads(cls_blob),
            "cls_blob": cls_blob,
            "args": init_args, "kwargs": init_kwargs,
            "num_replicas": num_replicas,
            "resources": resources or {},
            "user_config": user_config,
            "autoscaling_raw": autoscaling_config or None,
            "max_ongoing_requests": max_ongoing_requests,
        }
        if autoscaling_config:
            cfg = AutoscalingConfig.from_dict(autoscaling_config)
            self.autoscaling[name] = self._make_policy(name, cfg)
            self.desired[name]["num_replicas"] = cfg.min_replicas
        else:
            self.autoscaling.pop(name, None)
        self.versions.setdefault(name, 0)
        self._reconcile_once()
        return True

    def _make_policy(self, name: str, cfg: AutoscalingConfig):
        """Per-deployment policy selection (duck-typed on
        record/decide). ``slo_aware`` closes the observability loop:
        each decide() pulls the head's per-deployment signals digest
        (p99-over-window, shed rate, queue depth) over OP_STATE."""
        if cfg.policy != "slo_aware":
            return AutoscalingState(config=cfg)

        def fetch_signals():
            rt = ray_tpu_torch.core.api.get_runtime()
            return rt.list_state(
                "deployment_signals",
                {"name": name, "window": cfg.signal_window_s})

        return SloAwareAutoscalingPolicy(cfg,
                                         fetch_signals=fetch_signals)

    def delete_deployment(self, name: str) -> bool:
        """Remove a deployment from the desired state; replicas drain
        then die via reconcile. Returns False for an unknown name so
        serve.delete can report honestly."""
        known = self.desired.pop(name, None) is not None
        if known:
            self._reconcile_once()
        return known

    # -- live state queries (router/long-poll surface) --

    def get_replicas(self, name: str):
        return self.versions.get(name, 0), list(
            self.replicas.get(name, []))

    def get_routing_state(self, name: str):
        """(version, replicas, model_map) in one call — the router's
        refresh payload."""
        return (self.versions.get(name, 0),
                list(self.replicas.get(name, [])),
                dict(self.model_map.get(name, {})))

    def listen_for_change(self, known: dict, timeout: float = 30.0):
        """Multiplexed long-poll: block until ANY watched deployment's
        version moves past its known value (or the timeout lapses),
        then return {name: routing_state} for the changed ones. Each
        client process keeps exactly ONE of these outstanding for all
        its routers (reference: LongPollHost.listen_for_change
        multiplexes keys the same way, long_poll.py:177), so parked
        listeners scale with processes — not handles — and the
        16-thread actor pool never starves control calls."""
        deadline = time.time() + timeout

        def changed() -> dict:
            return {name: self.get_routing_state(name)
                    for name, v in known.items()
                    if self.versions.get(name, 0) != v}
        with self._version_cv:
            while not self._stop:
                out = changed()
                if out:
                    return out
                remaining = deadline - time.time()
                if remaining <= 0:
                    return {}
                self._version_cv.wait(min(1.0, remaining))
        return changed()

    def get_model_replicas(self, name: str, model_id: str):
        """Replicas that had ``model_id`` resident at the last probe —
        the router's model-locality hint (reference: multiplex-aware
        pow-2 scheduling)."""
        idxs = self.model_map.get(name, {}).get(model_id, [])
        live = self.replicas.get(name, [])
        return [live[i] for i in idxs if i < len(live)]

    def list_deployments(self) -> dict:
        return {name: {"num_replicas": len(self.replicas.get(name, [])),
                       "starting": len(self.starting.get(name, [])),
                       "desired": spec["num_replicas"]}
                for name, spec in self.desired.items()}

    def replica_pids(self, name: str | None = None) -> dict:
        """Pids of READY replicas — the seeded chaos killer's target
        list (util/chaos.py kind="serve_replica"). One deployment:
        ``{tag: pid}``; all: ``{deployment: {tag: pid}}``."""
        if name is not None:
            return dict(self.pids.get(name, {}))
        return {n: dict(per) for n, per in self.pids.items()}

    # -- reconciliation --

    def _reconcile_loop(self):
        while not self._stop:
            try:
                self._reconcile_once()
            except Exception:  # noqa: BLE001
                pass
            time.sleep(0.5)

    def _reconcile_once(self):
        with self._rec_lock:
            self._reconcile_locked()

    @staticmethod
    def _draining_node_ids() -> set:
        """Nodes mid-drain (preemption notice / scale-down): their
        replicas must be replaced AHEAD of the node's termination so
        capacity never dips (reference: serve proactively migrates
        replicas off draining nodes)."""
        try:
            rt = ray_tpu_torch.core.api.get_runtime()
            return {n["NodeID"] for n in rt.nodes()
                    if n.get("Alive") and n.get("Draining")}
        except Exception:  # noqa: BLE001
            return set()

    @staticmethod
    def _replica_nodes() -> dict:
        """actor_id hex -> node_id for every live actor."""
        try:
            rt = ray_tpu_torch.core.api.get_runtime()
            return {row["actor_id"]: row["node_id"]
                    for row in rt.list_state("actors", None)}
        except Exception:  # noqa: BLE001
            return {}

    @staticmethod
    def _kill_quietly(replica) -> None:
        try:
            ray_tpu_torch.kill(replica)
        except Exception:  # noqa: BLE001
            pass

    def _eject(self, name: str, replica, reason: str) -> None:
        self.health.get(name, {}).pop(replica._actor_id.hex(), None)
        self._m_ejections.inc(tags={"deployment": name})
        self._kill_quietly(replica)

    def _reconcile_locked(self):
        cfg = get_config()
        # remove deleted deployments
        for name in list(self.replicas):
            if name not in self.desired:
                for r in self.replicas.pop(name):
                    self._kill_quietly(r)
                for (r, _) in self.starting.pop(name, []):
                    self._kill_quietly(r)
                self.health.pop(name, None)
                self.pids.pop(name, None)
                self._bump_version(name)
        for name in list(self.starting):
            if name not in self.desired:
                for (r, _) in self.starting.pop(name):
                    self._kill_quietly(r)
        drain_nodes = self._draining_node_ids()
        actor_nodes = self._replica_nodes() if drain_nodes else {}
        for name, spec in self.desired.items():
            live = self.replicas.setdefault(name, [])
            starting = self.starting.setdefault(name, [])
            health = self.health.setdefault(name, {})
            # Drain-replace: a replica on a draining node leaves the
            # routing set NOW (replacements spawn below on surviving
            # nodes — the scheduler already excludes draining nodes)
            # and dies only after its in-flight requests finish,
            # reusing the scale-down drain machinery. Starting
            # replicas on a draining node never served: just killed.
            if drain_nodes:
                keep = []
                for r in live:
                    nid = actor_nodes.get(r._actor_id.hex())
                    if nid in drain_nodes:
                        self._start_draining(name, r)
                    else:
                        keep.append(r)
                if len(keep) != len(live):
                    live = keep
                    self.replicas[name] = live
                    self._bump_version(name)
                keep_s = []
                for (r, ts) in starting:
                    if actor_nodes.get(r._actor_id.hex()) \
                            in drain_nodes:
                        self._kill_quietly(r)
                    else:
                        keep_s.append((r, ts))
                starting[:] = keep_s
            changed = False
            # Readiness gate: starting replicas are probed every pass;
            # the first successful healthy probe admits them to the
            # routing table. Never-ready ones are respawned after the
            # startup timeout.
            now = time.time()
            still_starting = []
            for (r, spawn_ts) in starting:
                try:
                    p = ray_tpu_torch.get(
                        r.probe.remote(),
                        timeout=cfg.serve_health_check_timeout_s)
                    if p.get("healthy"):
                        live.append(r)
                        health[r._actor_id.hex()] = 0
                        changed = True
                        continue
                except ActorDiedError:
                    changed = True      # crashed in __init__: respawn
                    continue
                except Exception:  # noqa: BLE001 — slow init: wait on
                    pass
                if now - spawn_ts > cfg.serve_replica_startup_timeout_s:
                    self._kill_quietly(r)
                    changed = True
                else:
                    still_starting.append((r, spawn_ts))
            starting[:] = still_starting
            # Health plane for READY replicas, on its own cadence:
            # consecutive probe failures up to the threshold keep the
            # replica serving (one slow probe must not flap the
            # table); a DEAD actor is ejected immediately.
            probe_due = (now - self._last_probe.get(name, 0.0)
                         >= cfg.serve_health_check_period_s)
            stats = None
            if probe_due and live:
                self._last_probe[name] = now
                alive, stats = [], []
                refs = [(r, r.probe.remote()) for r in live]
                for r, ref in refs:
                    key = r._actor_id.hex()
                    try:
                        p = ray_tpu_torch.get(
                            ref,
                            timeout=cfg.serve_health_check_timeout_s)
                        if p.get("healthy"):
                            health[key] = 0
                            alive.append(r)
                            stats.append(p)
                            continue
                        fails = health.get(key, 0) + 1
                    except ActorDiedError:
                        fails = cfg.serve_health_check_failure_threshold
                    except Exception:  # noqa: BLE001
                        fails = health.get(key, 0) + 1
                    if fails >= cfg.serve_health_check_failure_threshold:
                        self._eject(name, r, "failed health probes")
                        changed = True
                    else:
                        health[key] = fails
                        alive.append(r)     # still serving, on watch
                        # Placeholder keeps stats index-aligned with
                        # alive: model_map indices below must match
                        # the routing table's replica positions.
                        stats.append(None)
                live = alive
                self.pids[name] = {
                    s["tag"]: s["pid"] for s in stats
                    if s and "pid" in s}
                # autoscaling decision from observed load
                auto = self.autoscaling.get(name)
                if auto is not None:
                    auto.record(sum(s["inflight"] for s in stats if s))
                    spec["num_replicas"] = auto.decide(
                        spec["num_replicas"])
                # model-locality map for the router; a residency
                # change bumps the version so routers refresh their
                # cached copy.
                mmap: dict[str, list[int]] = {}
                for i, s in enumerate(stats):
                    if s is None:       # on-watch: no fresh probe
                        continue
                    for mid in s.get("model_ids", []):
                        mmap.setdefault(mid, []).append(i)
                if mmap != self.model_map.get(name):
                    changed = True
                self.model_map[name] = mmap
            while len(live) + len(starting) < spec["num_replicas"]:
                n = len(live) + len(starting)
                tag = f"{name}#{n}_{int(time.time()*1e3)%100000}"
                resources = dict(spec["resources"])
                max_q = (spec.get("max_ongoing_requests")
                         or cfg.serve_max_queue_len_per_replica)
                starting.append((Replica.options(
                    num_cpus=resources.pop("CPU", 1.0),
                    num_gpus=resources.pop("GPU", 0) or None,
                    resources=resources or None,
                    # headroom over the queue bound so probe/control
                    # calls never starve behind a full request queue
                    max_concurrency=max(8, min(max_q, 64) + 4),
                ).remote(spec["cls"], spec["args"], spec["kwargs"],
                         tag, spec.get("user_config"),
                         max_queue_len=spec.get("max_ongoing_requests")),
                    time.time()))
            while len(live) + len(starting) > spec["num_replicas"]:
                # Graceful scale-down: never-ready spares die first;
                # a serving victim stops routing NOW (version bump
                # below) but is only killed once its in-flight
                # requests drain — killing a busy replica fails user
                # requests.
                if starting:
                    r, _ = starting.pop()
                    self._kill_quietly(r)
                elif live:
                    victim = live.pop()
                    health.pop(victim._actor_id.hex(), None)
                    self._start_draining(name, victim)
                changed = True
            self.replicas[name] = live
            self._reap_draining(name)
            if changed:
                self._bump_version(name)

    def _start_draining(self, name: str, replica) -> None:
        """One definition of 'leave the routing set, die after
        draining' — used by scale-down, code-redeploy replacement AND
        node drain. prepare_stop() flips the replica to stopping:
        after the stale-router grace it sheds new requests (the retry
        plane re-dispatches them) while in-flight ones finish."""
        cfg = get_config()
        try:
            replica.prepare_stop.remote()    # fire-and-forget
        except Exception:  # noqa: BLE001 — already dead
            pass
        now = time.time()
        self.draining.setdefault(name, []).append(
            (replica, now + cfg.serve_drain_deadline_s,
             now + cfg.serve_drain_min_grace_s))

    def _reap_draining(self, name: str) -> None:
        still = []
        now = time.time()
        for entry in self.draining.get(name, []):
            victim, deadline, not_before = entry
            done = now > deadline
            if not done and now >= not_before:
                try:
                    done = ray_tpu_torch.get(
                        victim.queue_len.remote(),
                        timeout=get_config().serve_queue_probe_timeout_s
                    ) == 0
                except Exception:  # noqa: BLE001 — already dead
                    done = True
            if done:
                self._kill_quietly(victim)
            else:
                still.append(entry)
        if still:
            self.draining[name] = still
        else:
            self.draining.pop(name, None)

    def graceful_shutdown(self) -> bool:
        self._stop = True
        with self._version_cv:
            self._version_cv.notify_all()   # release parked listeners
        for name in list(self.desired):
            self.desired.pop(name)
        self._reconcile_once()
        return True
