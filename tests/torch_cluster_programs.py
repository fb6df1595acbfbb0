"""Multi-node user programs, each run once on ``ray_tpu`` and once on
``ray_tpu_torch`` through that package's own ``cluster_utils.Cluster``
of node daemons (tests/test_torch_cluster*.py).

Every program takes the package module (``rt``), starts the cluster it
needs and shuts it down, and uses the package's public API (plus the
runtime's counters where a program checks a path was taken), so the same
code runs on both. Nothing here imports either package at module level:
a worker that unpickles one of these functions loads numpy and the
package it runs in, and nothing of the other. Waits are on conditions
with deadlines, never on fixed pauses alone.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

TOKEN = "cd" * 16


def _mod(rt, name: str):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _runtime(rt):
    return _mod(rt, "core.api").get_runtime()


def _cluster(rt, cpus: int = 1):
    return _mod(rt, "cluster_utils").Cluster(
        initialize_head=True, head_node_args={"num_cpus": cpus})


def _pin(rt, node_id: str, soft: bool = False):
    return _mod(rt, "util.scheduling_strategies") \
        .NodeAffinitySchedulingStrategy(node_id, soft=soft)


def _until(cond, timeout: float, what: str, period: float = 0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = cond()
        if out:
            return out
        time.sleep(period)
    raise TimeoutError(f"{what} within {timeout}s")


def _node_dead(rt, node_id: str, timeout: float = 30.0) -> bool:
    runtime = _runtime(rt)
    return _until(lambda: not runtime._nodes[node_id].alive, timeout,
                  f"node {node_id} declared dead")


def _where(rt):
    @rt.remote(num_cpus=1)
    def where():
        return rt.get_runtime_context().get_node_id()
    return where


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in sys.path if p]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.update(extra)
    return env


# -- placement, objects, node death --------------------------------------


def placement_by_resources_and_labels(rt):
    """A custom resource places a task on the daemon that has it; a
    label, read from ``nodes()``, places one on the other by affinity."""
    c = _cluster(rt)
    try:
        a = c.add_node(num_cpus=1, resources={"accel_a": 1},
                       labels={"zone": "a"})
        b = c.add_node(num_cpus=1, labels={"zone": "b"})
        where = _where(rt)
        on_a = rt.get(where.options(resources={"accel_a": 1}).remote(),
                      timeout=60)
        zones = {n["Labels"]["zone"]: n["NodeID"] for n in rt.nodes()
                 if n["Alive"] and "zone" in n["Labels"]}
        on_b = rt.get(where.options(
            scheduling_strategy=_pin(rt, zones["b"])).remote(), timeout=60)
        total = rt.cluster_resources()
        return [on_a == a.node_id, on_b == b.node_id == zones["b"],
                sorted(zones), total["CPU"], total["accel_a"]]
    finally:
        c.shutdown()


def peer_pull_4mib(rt):
    """A 4 MiB return stays in its daemon's store (the head keeps a
    directory entry); the driver reads it, and a task on the other
    daemon pulls it from its peer."""
    c = _cluster(rt)
    try:
        a = c.add_node(num_cpus=1)
        b = c.add_node(num_cpus=1)

        @rt.remote(num_cpus=1)
        def produce():
            return np.random.default_rng(5).integers(
                0, 255, 4 << 20, dtype=np.uint8)

        @rt.remote(num_cpus=1)
        def consume(arr):
            return (_sha(arr), arr.nbytes,
                    rt.get_runtime_context().get_node_id())

        ref = produce.options(scheduling_strategy=_pin(rt, a.node_id)) \
            .remote()
        rt.wait([ref], timeout=60)
        loc = _runtime(rt)._obj_locations.get(ref.id)
        want = _sha(np.random.default_rng(5).integers(
            0, 255, 4 << 20, dtype=np.uint8))
        sha, nbytes, home = rt.get(consume.options(
            scheduling_strategy=_pin(rt, b.node_id)).remote(ref), timeout=60)
        return [list(loc) == ["node", a.node_id],
                _sha(rt.get(ref, timeout=60)) == want,
                sha == want, nbytes, home == b.node_id]
    finally:
        c.shutdown()


def node_killed_under_task(rt):
    """SIGKILL of a daemon under a running task: the task retries on
    the head."""
    c = _cluster(rt, cpus=2)
    mark = tempfile.mkdtemp()
    try:
        a = c.add_node(num_cpus=2)

        @rt.remote(num_cpus=1, max_retries=2)
        def slow(x, mark):
            node = rt.get_runtime_context().get_node_id()
            open(os.path.join(mark, node), "w").close()
            time.sleep(2.0)
            return x, node

        ref = slow.options(scheduling_strategy=_pin(rt, a.node_id, True)) \
            .remote(7, mark)
        _until(lambda: os.path.exists(os.path.join(mark, a.node_id)), 60,
               "the task started on the daemon")
        c.remove_node(a, allow_graceful=False)
        x, node = rt.get(ref, timeout=120)
        return [x, node == c.head_node.node_id]
    finally:
        c.shutdown()


def node_killed_under_actor(rt):
    """SIGKILL of a daemon under an actor with ``max_restarts=1``: it
    restarts, fresh, on the head."""
    c = _cluster(rt, cpus=2)
    try:
        a = c.add_node(num_cpus=2)

        @rt.remote(num_cpus=1, max_restarts=1)
        class Counter:
            def __init__(self):
                self.n = 0

            def bump(self):
                self.n += 1
                return self.n, rt.get_runtime_context().get_node_id()

        ctr = Counter.options(
            scheduling_strategy=_pin(rt, a.node_id, True)).remote()
        first = rt.get(ctr.bump.remote(), timeout=60)
        c.remove_node(a, allow_graceful=False)

        def bumped():
            try:
                return rt.get(ctr.bump.remote(), timeout=30)
            except rt.RayTpuError:
                return None
        second = _until(bumped, 90, "the actor answered after its node "
                        "died", period=0.5)
        return [[first[0], first[1] == a.node_id],
                [second[0], second[1] == c.head_node.node_id]]
    finally:
        c.shutdown()


def node_killed_under_object(rt):
    """A return of a task that may not re-run (``max_retries=0``) has no
    lineage: when its daemon dies, a get raises ObjectLostError."""
    c = _cluster(rt)
    try:
        a = c.add_node(num_cpus=1)

        @rt.remote(num_cpus=1, max_retries=0)
        def produce():
            return np.zeros(1_000_000)

        ref = produce.options(scheduling_strategy=_pin(rt, a.node_id)) \
            .remote()
        rt.wait([ref], timeout=60)
        homed = _runtime(rt)._obj_locations.get(ref.id)[0]
        c.remove_node(a, allow_graceful=False)
        _node_dead(rt, a.node_id)
        try:
            rt.get(ref, timeout=30)
            return [homed, "no error"]
        except rt.RayTpuError as e:
            return [homed, type(e).__name__]
    finally:
        c.shutdown()


def drain_moves_work(rt):
    """``drain_node``: the tasks it preempts are refunded and finish
    elsewhere, the restartable actor migrates without spending its
    budget, the daemon's object moves out, and no lineage
    reconstruction runs."""
    config = _mod(rt, "core.config")
    mark = tempfile.mkdtemp()
    with config.env_overrides(drain_grace_period_s=0.2):
        c = _cluster(rt, cpus=3)
        try:
            a = c.add_node(num_cpus=3)
            runtime = _runtime(rt)

            @rt.remote(num_cpus=1)
            def produce():
                return np.arange(300_000)

            @rt.remote(num_cpus=1)
            def slow(i, mark):
                open(os.path.join(mark, str(i)), "w").close()
                time.sleep(1.5)
                return i

            @rt.remote(num_cpus=1, max_restarts=1)
            class Counter:
                def __init__(self):
                    self.n = 0

                def bump(self):
                    self.n += 1
                    return self.n, rt.get_runtime_context().get_node_id()

            soft = _pin(rt, a.node_id, True)
            obj = produce.options(scheduling_strategy=soft).remote()
            rt.wait([obj], timeout=60)
            ctr = Counter.options(scheduling_strategy=soft).remote()
            before = rt.get(ctr.bump.remote(), timeout=60)
            tasks = [slow.options(scheduling_strategy=soft,
                                  max_retries=0).remote(i, mark)
                     for i in range(2)]
            _until(lambda: len(os.listdir(mark)) == 2, 60,
                   "both tasks started")
            recon = runtime.lineage_reconstructions
            drained = runtime.drain_node(a.node_id, reason="preempt",
                                         deadline_s=20, remove=True)
            done = sorted(rt.get(tasks, timeout=60))
            after = rt.get(ctr.bump.remote(), timeout=60)
            value = rt.get(obj, timeout=60)
            row = next(n for n in rt.nodes() if n["NodeID"] == a.node_id)
            return [drained, done, before[1] == a.node_id,
                    after[0], after[1] != a.node_id,
                    int(value[-1]), runtime.drain_tasks_preempted >= 1,
                    runtime.drain_actors_migrated,
                    runtime.drain_objects_evacuated >= 1,
                    runtime.lineage_reconstructions - recon, row["Alive"]]
        finally:
            c.shutdown()


def drain_once_loop(config):
    """Reports steps 0..steps-1 with a checkpoint each, on either
    package (``config["pkg"]``). The first attempt, after the report of
    ``drain_at``, marks ``config["mark"]`` and waits there for its node
    to be drained; a restored attempt resumes after its checkpoint."""
    import importlib
    import json
    import tempfile

    train = importlib.import_module(config["pkg"] + ".train")
    start = 0
    restored = train.get_checkpoint()
    if restored is not None:
        with open(os.path.join(restored.to_directory(),
                               "position.json")) as f:
            start = json.load(f)["step"] + 1
    for i in range(start, config["steps"]):
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "position.json"), "w") as f:
                json.dump({"step": i}, f)
            train.report({"step": i, "resumed": restored is not None,
                          "node": os.environ.get("RAY_TPU_NODE_ID", ""),
                          "loss": float(np.float32(1.0) / (i + 1))},
                         checkpoint=train.Checkpoint.from_directory(d))
        if i == config["drain_at"] and restored is None:
            open(config["mark"], "w").close()
            time.sleep(120)


def trainer_drain_restart(rt):
    """A gang whose node is drained restarts from its last checkpoint
    on the replacement node without spending ``max_failures`` (0 here)."""
    config = _mod(rt, "core.config")
    train = _mod(rt, "train")
    storage = tempfile.mkdtemp()
    mark = os.path.join(storage, "drain_now")
    with config.env_overrides(drain_grace_period_s=0.2,
                              drain_deadline_s=2.0):
        c = _cluster(rt)
        try:
            a = c.add_node(num_cpus=2, resources={"trainer": 1})
            runtime = _runtime(rt)
            replaced = []

            def drain_then_replace():
                _until(lambda: os.path.exists(mark), 120,
                       "the loop reached its drain point")
                runtime.drain_node(a.node_id, reason="scale-down",
                                   remove=True)
                replaced.append(c.add_node(num_cpus=2,
                                           resources={"trainer": 1}))

            t = threading.Thread(target=drain_then_replace, daemon=True)
            t.start()
            cpu = ({"gpus_per_worker": 0} if rt.__name__ == "ray_tpu_torch"
                   else {})
            trainer_cls = getattr(train, "TorchTrainer"
                                  if rt.__name__ == "ray_tpu_torch"
                                  else "JaxTrainer")
            result = trainer_cls(
                drain_once_loop,
                train_loop_config={"pkg": rt.__name__, "steps": 5,
                                   "drain_at": 1, "mark": mark},
                scaling_config=train.ScalingConfig(
                    num_workers=1, resources_per_worker={"trainer": 1},
                    **cpu),
                run_config=train.RunConfig(
                    name="drain", storage_path=storage,
                    failure_config=train.FailureConfig(max_failures=0)),
            ).fit()
            t.join(60)
            m = result.metrics
            return [result.error, m["step"], m["resumed"],
                    m["node"] == replaced[0].node_id, m["loss"]]
        finally:
            c.shutdown()


def resource_view_broadcast(rt):
    """The head broadcasts the cluster's resource view to the daemons;
    a worker on a daemon reads the whole cluster's resources from it."""
    config = _mod(rt, "core.config")
    with config.env_overrides(rview_period_s=0.2):
        c = _cluster(rt)
        try:
            a = c.add_node(num_cpus=3)

            @rt.remote(num_cpus=1)
            def query(expect):
                deadline = time.time() + 20
                while time.time() < deadline:
                    total = rt.cluster_resources()
                    if total.get("CPU", 0) >= expect:
                        break
                    time.sleep(0.1)
                return (rt.cluster_resources().get("CPU"),
                        rt.get_runtime_context().get_node_id())

            total, home = rt.get(query.options(
                scheduling_strategy=_pin(rt, a.node_id)).remote(4.0),
                timeout=60)
            runtime = _runtime(rt)
            return [total, home == a.node_id,
                    runtime._rview_version >= 1,
                    runtime._rview_broadcasts >= 1]
        finally:
            c.shutdown()


def sigstop_declared_dead(rt):
    """A daemon under SIGSTOP keeps its socket open: the head's health
    check declares it dead; after SIGCONT it registers again."""
    import signal
    config = _mod(rt, "core.config")
    with config.env_overrides(health_check_period_s=0.2,
                              health_check_failure_threshold=5):
        c = _cluster(rt)
        try:
            a = c.add_node(num_cpus=1)
            runtime = _runtime(rt)
            where = _where(rt)
            first = rt.get(where.options(
                scheduling_strategy=_pin(rt, a.node_id)).remote(),
                timeout=60)
            os.kill(a.proc.pid, signal.SIGSTOP)
            try:
                dead = _node_dead(rt, a.node_id, timeout=60)
            finally:
                os.kill(a.proc.pid, signal.SIGCONT)
            revived = _until(lambda: runtime._nodes[a.node_id].alive, 60,
                             "the daemon registered again")
            return [first == a.node_id, dead, revived]
        finally:
            c.shutdown()


# -- chaos' node kinds and the DCN dry run ------------------------------


def chaos_node_kinds(rt):
    """``ResourceKiller``'s ``node`` (removes a daemon), ``preempt``
    (drains one, then removes it) and ``partition`` (severs one for a
    while through the node channel's fault rules, then heals)."""
    chaos = _mod(rt, "util.chaos")
    plan = os.path.join(tempfile.mkdtemp(), "chaos_plan.json")
    _mod(rt, "core.wire").write_plan_file(plan, [])
    old = os.environ.get("RAY_TPU_CHAOS_FILE")
    os.environ["RAY_TPU_CHAOS_FILE"] = plan
    c = _cluster(rt)
    try:
        out = []
        for kind in ("node", "preempt"):
            n = c.add_node(num_cpus=1)
            killer = chaos.ResourceKiller(kind=kind, interval_s=0.2,
                                          max_kills=1, seed=1,
                                          drain_deadline_s=5.0).start()
            _until(lambda: killer.kills >= 1, 60, f"a {kind} kill")
            killer.stop()
            _node_dead(rt, n.node_id)
            out.append([killer.decisions[0][:2] == (kind, n.node_id),
                        killer.kills])
        n = c.add_node(num_cpus=1)
        killer = chaos.ResourceKiller(kind="partition", interval_s=0.2,
                                      max_kills=1, seed=1,
                                      partition_duration_s=1.0).start()
        _until(lambda: killer.kills >= 1, 60, "a partition")
        killer.stop()
        kind, victim, mode = killer.decisions[0]
        # Healed, the node serves again (its daemon may have dropped
        # the severed channel and registered anew meanwhile).
        where = _where(rt)

        def served():
            try:
                return rt.get(where.options(
                    scheduling_strategy=_pin(rt, n.node_id)).remote(),
                    timeout=30)
            except rt.RayTpuError:
                return None
        back = _until(served, 90, "a task on the healed node", period=0.5)
        out.append([kind, victim == n.node_id,
                    mode in ("both", "send", "recv"), back == n.node_id])
        return out
    finally:
        c.shutdown()
        if old is None:
            os.environ.pop("RAY_TPU_CHAOS_FILE", None)
        else:
            os.environ["RAY_TPU_CHAOS_FILE"] = old


def dcn_dry_run(rt):
    """The cross-slice (DCN) leg of the dry run: two slices, each on its
    own mesh, hand an activation over ``DcnTcpCommunicator`` and close
    with a cross-slice all-reduce. On the port the slices are actors on
    two node daemons (``parallel.dryrun.dryrun_dcn_pipeline``)."""
    c = _cluster(rt, cpus=2)
    try:
        if rt.__name__ == "ray_tpu":
            importlib.import_module("__graft_entry__") \
                ._dryrun_dcn_pipeline()
            return "passed"
        out = _mod(rt, "parallel.dryrun").dryrun_dcn_pipeline(c)
        daemons = {n.node_id for n in c.list_all_nodes
                   if n.proc is not None}
        ok = (len(set(out["nodes"])) == 2 and set(out["nodes"]) <= daemons
              and out["meshes"][0]["dp"] == 1)
        return "passed" if ok else f"slices not on two daemons: {out}"
    finally:
        c.shutdown()


# -- serve on nodes -------------------------------------------------------


def serve_drain_replace(rt):
    """A drained node's Serve replica is replaced before it stops:
    callers under load see no failed request."""
    serve = _mod(rt, "serve")
    c = _cluster(rt, cpus=2)
    try:
        a = c.add_node(num_cpus=2)

        @serve.deployment(num_replicas=2, ray_actor_options={"num_cpus": 1})
        class Spread:
            def __call__(self, x):
                time.sleep(0.01)
                return "ok"

        handle = serve.run(Spread.bind())
        stop = threading.Event()
        sent, failures = [0], []
        lock = threading.Lock()

        def load():
            i = 0
            while not stop.is_set():
                i += 1
                try:
                    assert handle.remote({"v": i}).result(timeout_s=90) \
                        == "ok"
                except Exception as e:  # noqa: BLE001 — tallied
                    failures.append(f"{type(e).__name__}: {e}")
                with lock:
                    sent[0] += 1
                time.sleep(0.02)

        threads = [threading.Thread(target=load, daemon=True)
                   for _ in range(3)]
        for t in threads:
            t.start()
        _until(lambda: sent[0] >= 10, 60, "requests flowing")
        drained = _runtime(rt).drain_node(a.node_id, reason="chaos drain",
                                          deadline_s=30, remove=True)
        start = sent[0]
        _until(lambda: sent[0] >= start + 30, 60, "requests after the drain")
        stop.set()
        for t in threads:
            t.join(120)
        row = next(n for n in rt.nodes() if n["NodeID"] == a.node_id)
        return [drained, failures[:3], sent[0] > 40, row["Alive"]]
    finally:
        serve.shutdown()
        c.shutdown()


# -- the head daemon, its op log, and clients -----------------------------


def oplog_round_trip(rt):
    """Group-committed appends across a segment rotation replay over a
    snapshot: the last write wins, a delete removes, compaction drops
    the old segment."""
    oplog = _mod(rt, "core.oplog")
    d = os.path.join(tempfile.mkdtemp(), "j")
    log = oplog.OpLog(d)
    b = oplog.b64e
    log.append({"op": "kv_put", "ns": "", "k": b(b"k"), "v": b(b"v1")})
    waiters = [log.append_async({"op": "kv_put", "ns": "n", "k": b(b"x%d" % i),
                                 "v": b(b"%d" % i)}) for i in range(5)]
    for w in waiters:
        w()
    old = log.rotate()
    log.append({"op": "kv_put", "ns": "", "k": b(b"k"), "v": b(b"v2")})
    log.append({"op": "kv_del", "ns": "", "k": b(b"gone")})
    log.close()
    gens = oplog.OpLog.segment_gens(d)
    entries = oplog.OpLog.read_from(d, 0)
    state = oplog.merge_oplog(
        {"kv": [{"ns": "", "k": b(b"gone"), "v": b(b"x")}],
         "named_actors": [], "pgs": []}, entries)
    kv = sorted((r["ns"], r["k"], r["v"]) for r in state["kv"])
    log2 = oplog.OpLog(d)
    log2.delete_upto(old)
    after = oplog.OpLog.segment_gens(d)
    log2.close()
    return [gens, len(entries), kv, after]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_port(port: int, timeout: float = 60.0) -> None:
    def up():
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return True
        except OSError:
            return False
    _until(up, timeout, f"head port {port} open", period=0.1)


def head_restart_readopts(rt):
    """A head daemon with a journal is SIGKILLed and started again: the
    node daemon reconnects, the named actor on it is re-adopted with its
    state, the KV survives, and the client resumes.

    After the restart the program waits, reading only, until the
    restarted head lists the node alive and the actor ``ALIVE``, and
    then makes ONE call: ``bump`` changes the actor's state, so a call
    retried after a timeout could land twice."""
    port = _free_port()
    journal = os.path.join(tempfile.mkdtemp(), "journal")
    env = _env(RAY_TPU_CLUSTER_TOKEN=TOKEN)

    def head():
        return subprocess.Popen(
            [sys.executable, "-m", f"{rt.__name__}.core.head", "--port",
             str(port), "--host", "127.0.0.1", "--num-cpus", "1",
             "--journal", journal], env=env)

    h = head()
    d = None
    try:
        _wait_port(port)
        d = subprocess.Popen(
            [sys.executable, "-m", f"{rt.__name__}.core.node_daemon",
             "--address", f"127.0.0.1:{port}", "--num-cpus", "2",
             "--resources", '{"gang": 1}'], env=env)
        rt.init(address=f"127.0.0.1:{port}", cluster_token=TOKEN)
        runtime = _runtime(rt)
        runtime.kv_put(b"job/state", b"running", "t")

        @rt.remote(num_cpus=1, resources={"gang": 1})
        class Counter:
            def __init__(self):
                self.n = 0

            def bump(self):
                self.n += 1
                return self.n

        ctr = Counter.options(name="survivor").remote()
        first = rt.get(ctr.bump.remote(), timeout=90)
        node = next(n["NodeID"] for n in rt.nodes() if not n["IsHead"])
        h.kill()
        h.wait(10)
        t0 = time.monotonic()
        h = head()
        _wait_port(port)
        seen = []

        def readopted():
            try:
                alive = any(n["NodeID"] == node and n["Alive"]
                            for n in rt.nodes())
                actors = [a["state"] for a in runtime.list_state(
                    "actors", [("name", "=", "survivor")])]
            except Exception as e:  # noqa: BLE001 — the head is coming back
                seen.append((round(time.monotonic() - t0, 2),
                             type(e).__name__))
                return False
            return alive and actors == ["ALIVE"]
        _until(readopted, 120, "the node and the actor re-adopted",
               period=0.2)
        ready_s = time.monotonic() - t0
        second = rt.get(ctr.bump.remote(), timeout=120)
        kv = runtime.kv_get(b"job/state", "t")
        named = rt.get(rt.get_actor("survivor").bump.remote(), timeout=120)
        out = [first, second, kv, named]
        if out != EXPECTED["head_restart_readopts"]:
            print(f"head_restart_readopts: outcome {out}, re-adopted "
                  f"{ready_s:.2f} s after the restart, answered at "
                  f"{time.monotonic() - t0:.2f} s; reads that failed "
                  f"{seen[:20]}", file=sys.stderr, flush=True)
        return out
    finally:
        try:
            rt.shutdown()
        finally:
            for p in (d, h):
                if p is not None:
                    p.kill()
                    p.wait(10)


_CLIENT_SCRIPT = r"""
import json, sys
import importlib
rt = importlib.import_module(sys.argv[1])
addr = sys.argv[2]
out = []

@rt.remote
def double(x):
    return 2 * x

for how in (addr, "auto"):
    rt.init(address=how)
    out.append([rt.get(double.remote(21), timeout=60),
                rt.get(rt.get_actor("greeter").hi.remote(), timeout=60)])
    rt.shutdown()
with rt.client(addr).connect() as ctx:
    out.append([rt.get(double.remote(4), timeout=60), ctx.address == addr])
print("OUT" + json.dumps(out), flush=True)
"""


def client_mode_from_subprocess(rt):
    """A script of its own connects to the running head three ways:
    ``init(address=...)``, ``init(address="auto")`` (the session of its
    parent) and ``client(address).connect()``; each submits a task and
    reaches a named actor of the head's."""
    c = _cluster(rt, cpus=2)
    try:
        @rt.remote(num_cpus=0)
        class Greeter:
            def hi(self):
                return "hi"

        g = Greeter.options(name="greeter").remote()
        rt.get(g.hi.remote(), timeout=60)
        env = _env()
        env.pop("RAY_TPU_ADDRESS", None)
        p = subprocess.run(
            [sys.executable, "-c", _CLIENT_SCRIPT, rt.__name__,
             rt.client_address()], env=env, capture_output=True, text=True,
            timeout=180)
        lines = [x for x in p.stdout.splitlines() if x.startswith("OUT")]
        if p.returncode or not lines:
            return ["client failed", p.returncode, p.stderr[-2000:]]
        return json.loads(lines[-1][3:])
    finally:
        c.shutdown()


TABLE = {f.__name__: f for f in (
    placement_by_resources_and_labels, peer_pull_4mib,
    node_killed_under_task, node_killed_under_actor,
    node_killed_under_object, resource_view_broadcast, dcn_dry_run)}
FAULTS = {f.__name__: f for f in (
    drain_moves_work, trainer_drain_restart, sigstop_declared_dead,
    chaos_node_kinds, serve_drain_replace)}
HEAD = {f.__name__: f for f in (
    oplog_round_trip, head_restart_readopts, client_mode_from_subprocess)}


def run(program, rt) -> tuple:
    """("ok", result) or ("raised", class name, message)."""
    try:
        return ("ok", program(rt))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__, str(e))
    finally:
        if rt.is_initialized():
            rt.shutdown()


def run_table(name: str, table: dict) -> dict:
    """{program: outcome} of every program of ``table`` on package
    ``name``; each program starts and stops its own cluster."""
    rt = importlib.import_module(name)
    return {prog: run(fn, rt) for prog, fn in table.items()}


# What each program must give (the same on both packages, and right).
EXPECTED = {
    "placement_by_resources_and_labels": [True, True, ["a", "b"], 3.0, 1.0],
    "peer_pull_4mib": [True, True, True, 4 << 20, True],
    "node_killed_under_task": [7, True],
    "node_killed_under_actor": [[1, True], [1, True]],
    "node_killed_under_object": ["node", "ObjectLostError"],
    "resource_view_broadcast": [4.0, True, True, True],
    "dcn_dry_run": "passed",
    "drain_moves_work": [True, [0, 1], True, 1, True, 299_999, True, 1,
                         True, 0, False],
    "trainer_drain_restart": [None, 4, True, True,
                              float(np.float32(1.0) / 5)],
    "sigstop_declared_dead": [True, True, True],
    "chaos_node_kinds": [[True, 1], [True, 1],
                         ["partition", True, True, True]],
    "serve_drain_replace": [True, [], True, False],
    "oplog_round_trip": [[0, 1], 8,
                         [("", "aw==", "djI=")]
                         + [("n", __import__("base64").b64encode(
                             b"x%d" % i).decode(),
                             __import__("base64").b64encode(
                                 b"%d" % i).decode()) for i in range(5)],
                         [1]],
    "head_restart_readopts": [1, 2, b"running", 3],
    "client_mode_from_subprocess": [[42, "hi"], [42, "hi"], [8, True]],
}


def processes_left(timeout: float = 15.0) -> list[str]:
    """Command lines of this process's children that are still node
    daemons, heads or runtime workers once ``timeout`` has passed."""
    import torch_runtime_programs
    return torch_runtime_programs.workers_left(
        timeout, ("core.worker_entry", "core.node_daemon", "core.head"))
