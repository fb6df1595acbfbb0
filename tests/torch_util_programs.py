"""Small programs of the one-node utility modules, each run once on
``ray_tpu`` and once on ``ray_tpu_torch`` (tests/test_torch_util_programs.py):
``util.queue``, ``util.multiprocessing`` (``Pool``), ``util.joblib``,
``util.scheduling_strategies``, ``experimental.pubsub``, ``util.usage``,
``util.logdir``, ``util.chaos`` (``ResourceKiller``'s worker, actor and
serve-replica kinds) and ``util.ha`` (the head snapshot round trip).

Every program takes the package module (``rt``) and reaches the module
under test through it (:func:`_sub`), so the same code runs on both. It
returns a plain result that holds only what a run decides (values,
booleans, exception class names, sorted sets), never a pid, a time or a
path: two results are equal only if a user would have seen the same
behaviour. The programs cover the behaviours of the JAX package's
``tests/test_util_queue.py``, ``test_util_extras.py``, ``test_pubsub.py``
and the one-node tests of ``test_kv_ha_chaos.py``; :data:`EXPECTED`
holds what each must give.

:data:`TABLE` runs in one runtime of ``num_cpus=4`` per package
(:func:`run_table`); :data:`ALONE` programs start and stop runtimes of
their own (:func:`run_alone`). Nothing here imports either package at
module level: a worker that unpickles one of these functions loads the
package it runs in.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import tempfile
import threading
import time

from torch_parity import table_run


def _sub(rt, name: str):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _raises(fn) -> str | None:
    """The class name of what ``fn()`` raises, None if nothing."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__
    return None


def _sq(x):
    return x * x


def _addmul(a, b):
    return a + 10 * b


def _set_env(v):
    os.environ["_POOL_INIT"] = str(v)


def _read_env(_):
    return os.environ.get("_POOL_INIT")


def _produce(q, n):
    for i in range(n):
        q.put(i * 10)
    return n


def _consume(q, n):
    return [q.get(timeout=60) for _ in range(n)]


# -- util.queue ---------------------------------------------------------------


def queue_fifo_and_nowait(rt):
    qm = _sub(rt, "util.queue")
    q = qm.Queue()
    for i in range(5):
        q.put(i)
    size = q.qsize()
    got = [q.get() for _ in range(5)]
    return [size, got, q.empty(), _raises(q.get_nowait),
            _raises(lambda: q.get(timeout=0.2))]


def queue_maxsize(rt):
    qm = _sub(rt, "util.queue")
    q = qm.Queue(maxsize=2)
    q.put(1)
    q.put(2)
    out = [_raises(lambda: q.put_nowait(3)),
           _raises(lambda: q.put(3, timeout=0.2)), q.get()]
    q.put(3)
    return out + [[q.get(), q.get()], issubclass(qm.Full, Exception)]


def queue_across_processes(rt):
    q = _sub(rt, "util.queue").Queue()
    c = rt.remote(_consume).remote(q, 6)
    p = rt.remote(_produce).remote(q, 6)
    return [rt.get(p, timeout=120), sorted(rt.get(c, timeout=120)),
            q.qsize()]


# -- util.multiprocessing -----------------------------------------------------


def pool_map_and_starmap(rt):
    with _sub(rt, "util.multiprocessing").Pool(2) as p:
        return [p.map(_sq, range(10)),
                p.starmap(_addmul, [(1, 2), (3, 4)]),
                p.apply(_addmul, (5, 6)),
                p.map(_sq, range(7), chunksize=3)]


def pool_async_and_imap(rt):
    with _sub(rt, "util.multiprocessing").Pool(2) as p:
        r = p.map_async(_sq, range(6))
        out = [r.get(timeout=60), r.ready(), r.successful()]
        out.append(list(p.imap(_sq, range(5), chunksize=2)))
        out.append(sorted(p.imap_unordered(_sq, range(5), chunksize=2)))
        done = threading.Event()
        seen = []

        def callback(value):
            seen.append(value)
            done.set()

        p.apply_async(_addmul, (1, 1), callback=callback)
        out.append([done.wait(60), seen])
        failed = []
        p.apply_async(_sq, ("x",), error_callback=lambda e: failed.append(
            type(e).__name__))
        deadline = time.monotonic() + 60
        while not failed and time.monotonic() < deadline:
            time.sleep(0.05)
        out.append(bool(failed))
        return out


def pool_initializer_and_lifecycle(rt):
    mp = _sub(rt, "util.multiprocessing")
    p = mp.Pool(2, initializer=_set_env, initargs=(7,))
    out = [p.map(_read_env, range(2))]
    r = p.map_async(_sq, range(4))
    p.close()
    p.join()
    out += [r.get(timeout=60), _raises(lambda: p.map(_sq, [1])),
            _raises(lambda: mp.Pool(0)),
            _raises(lambda: mp.Pool(1).join())]
    return out


# -- util.joblib --------------------------------------------------------------


def joblib_backend(rt):
    joblib = importlib.import_module("joblib")
    _sub(rt, "util.joblib").register_ray()
    with joblib.parallel_backend("ray", n_jobs=2):
        out = joblib.Parallel()(joblib.delayed(_sq)(i) for i in range(8))
    return out


# -- util.scheduling_strategies -----------------------------------------------


def _where():
    return "ran"


def scheduling_strategies(rt):
    ss = _sub(rt, "util.scheduling_strategies")
    pg = rt.placement_group([{"CPU": 1}], strategy="PACK")
    pg.ready(timeout=30)
    fn = rt.remote(_where)
    in_pg = fn.options(scheduling_strategy=ss.PlacementGroupSchedulingStrategy(
        pg, placement_group_bundle_index=0)).remote()
    node = rt.nodes()[0]["NodeID"]
    pinned = fn.options(scheduling_strategy=ss.NodeAffinitySchedulingStrategy(
        node, soft=False)).remote()
    soft = fn.options(scheduling_strategy=ss.NodeAffinitySchedulingStrategy(
        "no_such_node", soft=True)).remote()
    out = rt.get([in_pg, pinned, soft], timeout=60)
    strategy = ss.PlacementGroupSchedulingStrategy(pg)
    rt.remove_placement_group(pg)
    return out + [strategy.placement_group_bundle_index,
                  strategy.placement_group_capture_child_tasks]


# -- experimental.pubsub ------------------------------------------------------


def pubsub_roundtrip(rt):
    ps = _sub(rt, "experimental.pubsub")
    sub = ps.subscribe("t1")
    seqs = [ps.publish("t1", {"a": 1}), ps.publish("t1", {"a": 2})]
    out = [seqs[1] - seqs[0], sub.poll(timeout=5), sub.poll(timeout=0.1)]
    ps.publish("t1", 3)
    return out + [sub.poll(timeout=5), sub.last_dropped]


def pubsub_from_latest(rt):
    ps = _sub(rt, "experimental.pubsub")
    ps.publish("t2", "old")
    sub = ps.subscribe("t2", from_latest=True)
    out = [sub.poll(timeout=0.1)]
    ps.publish("t2", "new")
    out.append(sub.poll(timeout=5))
    out.append(ps.subscribe("t2", from_latest=False).poll(timeout=5))
    return out


def pubsub_long_poll(rt):
    ps = _sub(rt, "experimental.pubsub")
    sub = ps.subscribe("t3")
    got = []
    t = threading.Thread(target=lambda: got.extend(sub.poll(timeout=10)))
    t.start()
    time.sleep(0.3)
    woke_early = bool(got)
    ps.publish("t3", "wake")
    t.join(timeout=10)
    return [woke_early, got, t.is_alive()]


def _announce(i):
    import importlib as il
    import sys
    pkg = "ray_tpu_torch" if "ray_tpu_torch" in sys.modules else "ray_tpu"
    return il.import_module(f"{pkg}.experimental.pubsub").publish(
        "t4", f"from-{i}") > 0


def pubsub_workers_publish(rt):
    ps = _sub(rt, "experimental.pubsub")
    sub = ps.subscribe("t4")
    sent = rt.get([rt.remote(num_cpus=0)(_announce).remote(i)
                   for i in range(3)], timeout=60)
    got = []
    deadline = time.monotonic() + 10
    while len(got) < 3 and time.monotonic() < deadline:
        got += sub.poll(timeout=2)
    return [sent, sorted(got)]


def pubsub_ring_bound_and_gaps(rt):
    ps = _sub(rt, "experimental.pubsub")
    sub_all = ps.subscribe("t5", from_latest=False)
    for i in range(2000):
        ps.publish("t5", i)
    got = sub_all.poll(timeout=5, max_messages=5000)
    out = [len(got) <= 1024, got[-1], sub_all.last_dropped
           == 2000 - len(got)]
    sub = ps.subscribe("t6", from_latest=True)
    ps.publish("t6", "seen")
    out += [sub.poll(timeout=5), sub.last_dropped]
    for i in range(1500):              # the ring holds 1024: 476 evicted
        ps.publish("t6", i)
    got = sub.poll(timeout=5, max_messages=5000)
    out += [got[-1], sub.last_dropped == 1500 - len(got) > 0,
            sub.dropped_total == sub.last_dropped]
    ps.publish("t6", "tail")
    out += [sub.poll(timeout=5), sub.last_dropped]
    return out


def pubsub_epoch_rewind(rt):
    ps = _sub(rt, "experimental.pubsub")
    sub = ps.subscribe("t7", from_latest=True)
    ps.publish("t7", "a")
    out = [sub.poll(timeout=5)]
    # The topic recreated under the subscriber (a head restart or the
    # idle reap): an unknowable loss, said as -1.
    _sub(rt, "core.api").get_runtime()._pubsub.pop("t7", None)
    ps.publish("t7", "b")
    out += [sub.poll(timeout=5), sub.last_dropped]
    ps.publish("t7", "c")
    return out + [sub.poll(timeout=5), sub.last_dropped]


# -- util.usage and util.logdir -----------------------------------------------


def usage_and_export(rt):
    usage = _sub(rt, "util.usage")
    rt.get([rt.remote(_sq).remote(i) for i in range(3)], timeout=60)
    report = usage.collect_usage()
    d = tempfile.mkdtemp(prefix="usage_")
    try:
        path = usage.write_usage_report(os.path.join(d, "usage.json"))
        with open(path) as f:
            written = json.load(f)
        n = usage.export_events(os.path.join(d, "events.jsonl"))
        with open(os.path.join(d, "events.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        os.environ["RAY_TPU_USAGE_STATS_ENABLED"] = "0"
        try:
            disabled = [usage.usage_stats_enabled(),
                        usage.write_usage_report(os.path.join(d, "no.json"))]
        finally:
            del os.environ["RAY_TPU_USAGE_STATS_ENABLED"]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return [sorted(report), report["tasks_finished"] >= 3,
            report["cluster_resources"].get("CPU"), sorted(written),
            n == len(rows) > 0, all(isinstance(r, dict) for r in rows),
            usage.usage_stats_enabled(), disabled]


def logdir_helpers(rt):
    logdir = _sub(rt, "util.logdir")
    d = tempfile.mkdtemp(prefix="logdir_")
    try:
        with open(os.path.join(d, "b.log"), "w") as f:
            f.write("0123456789")
        with open(os.path.join(d, "a.log"), "w") as f:
            f.write("x")
        os.mkdir(os.path.join(d, "sub"))
        tail = logdir.tail_log_file(d, "../../b.log", tail_bytes=4)
        first = logdir.tail_log_file(d, "b.log", offset=0, max_bytes=6)
        with open(os.path.join(d, "b.log"), "a") as f:
            f.write("ab")
        more = logdir.tail_log_file(d, "b.log", offset=first["offset"])
        past = logdir.tail_log_file(d, "b.log", offset=10_000)
        return [logdir.list_log_files(d), logdir.list_log_files(""),
                [tail["content"], tail["truncated"]],
                [first["content"], first["truncated"], first["offset"]],
                [more["content"], more["offset"], more["size"]],
                past["content"], logdir.tail_log_file(d, "none.log")["error"],
                logdir.tail_log_file("", "b.log")["error"]]
    finally:
        shutil.rmtree(d, ignore_errors=True)


def session_logs(rt):
    """The live session's log directory: the workers' logs are listed,
    and a traversal out of it is clamped to a basename."""
    logdir = _sub(rt, "util.logdir")
    rt.get(rt.remote(_sq).remote(2), timeout=60)
    log_dir = _sub(rt, "core.api").get_runtime().log_dir
    files = logdir.list_log_files(log_dir)
    worker = [f for f in files if f.startswith("worker-")]
    clamped = logdir.tail_log_file(log_dir, "../" + worker[0])
    return [bool(worker), "error" not in clamped,
            logdir.tail_log_file(log_dir, "../../etc/passwd")["error"]]


# -- util.chaos ---------------------------------------------------------------


def _sleepy(i):
    time.sleep(0.3)
    return i


def chaos_worker_kills(rt):
    chaos = _sub(rt, "util.chaos")
    killer = chaos.ResourceKiller(kind="worker", interval_s=0.25,
                                  max_kills=3, seed=0).start()
    try:
        refs = [rt.remote(_sleepy).options(max_retries=20).remote(i)
                for i in range(8)]
        got = sorted(rt.get(refs, timeout=180))
    finally:
        kills = killer.stop()
    return [got, kills >= 1]


class _Resilient:
    def ping(self):
        return "ok"


def chaos_actor_restarts(rt):
    chaos = _sub(rt, "util.chaos")
    a = rt.remote(_Resilient).options(max_restarts=10).remote()
    first = rt.get(a.ping.remote(), timeout=60)
    killer = chaos.ResourceKiller(kind="actor", interval_s=0.3,
                                  max_kills=2, seed=1).start()
    time.sleep(1.0)
    kills = killer.stop()
    deadline = time.monotonic() + 60
    back = None
    while time.monotonic() < deadline:
        try:
            back = rt.get(a.ping.remote(), timeout=30)
            break
        except Exception:  # noqa: BLE001 — restarting
            time.sleep(0.5)
    rt.kill(a)
    return [first, kills >= 1, back]


class _Echo:
    def __call__(self, x):
        time.sleep(0.01)
        return {"ok": x}


def chaos_serve_replica(rt):
    """ResourceKiller(kind="serve_replica") kills one of two replicas
    while three callers send requests: no request fails and the
    controller respawns the replica."""
    serve = _sub(rt, "serve")
    chaos = _sub(rt, "util.chaos")
    handle = serve.run(serve.deployment(num_replicas=2)(_Echo).bind())
    controller = rt.get_actor(_sub(rt, "serve.controller").CONTROLLER_NAME)
    stop = threading.Event()
    failures, sent = [], [0]

    def caller(tid):
        i = 0
        while not stop.is_set():
            i += 1
            try:
                if handle.remote({"v": i}).result(timeout_s=90) is None:
                    raise AssertionError("no answer")
            except Exception as e:  # noqa: BLE001 — tallied
                failures.append(f"t{tid} req{i}: {type(e).__name__}: {e}")
            sent[0] += 1
            time.sleep(0.02)

    threads = [threading.Thread(target=caller, args=(i,), daemon=True)
               for i in range(3)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while sent[0] < 10 and time.monotonic() < deadline:
        time.sleep(0.02)
    before = rt.get(controller.replica_pids.remote(), timeout=10)
    killer = chaos.ResourceKiller(kind="serve_replica", interval_s=0.1,
                                  max_kills=1, seed=1234).start()
    deadline = time.monotonic() + 30
    while killer.kills < 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    killer.stop()

    def respawned() -> bool:
        now = rt.get(controller.replica_pids.remote(), timeout=10)
        pids = set(now.get("_Echo", {}).values())
        return len(pids) == 2 and pids != set(before["_Echo"].values())

    deadline = time.monotonic() + 60
    while not respawned() and time.monotonic() < deadline:
        time.sleep(0.1)
    back = respawned()
    deadline = time.monotonic() + 60
    while sent[0] < 60 and time.monotonic() < deadline:
        time.sleep(0.02)
    stop.set()
    for t in threads:
        t.join(timeout=120)
    return [failures[:3], killer.kills, [d[0] for d in killer.decisions],
            back, sent[0] >= 60, not any(t.is_alive() for t in threads)]


# -- util.ha ------------------------------------------------------------------


class _NamedCounter:
    def __init__(self, start=0):
        self.n = start

    def incr(self):
        self.n += 1
        return self.n


def ha_round_trip(rt):
    ha, kv = _sub(rt, "util.ha"), _sub(rt, "experimental.internal_kv")
    snap = os.path.join(tempfile.mkdtemp(prefix="ha_"), "head.json")
    rt.init(num_cpus=4)
    try:
        kv.kv_put("cfg", b"v1")
        c = rt.remote(_NamedCounter).options(name="counter").remote(10)
        first = rt.get(c.incr.remote(), timeout=60)
        pg = rt.placement_group([{"CPU": 1}], strategy="PACK")
        pg.ready(timeout=30)
        counts = ha.save_head_state(snap)
        with open(snap) as f:
            tables = sorted(json.load(f))
    finally:
        rt.shutdown()            # the head "dies"
    rt.init(num_cpus=4)
    try:
        restored = ha.restore_head_state(snap)
        c2 = rt.get_actor("counter")
        # Reachable again by name, restarted fresh: identity kept, state
        # lost (the GCS actor-restart semantics).
        return [first, counts, tables, restored["named_actors"],
                restored["pgs"], kv.kv_get("cfg"),
                rt.get(c2.incr.remote(), timeout=60),
                ha.restore_head_state(snap)["named_actors"]]
    finally:
        rt.shutdown()
        shutil.rmtree(os.path.dirname(snap), ignore_errors=True)


def ha_relinks_placement_group(rt):
    """A named actor living in a placement group lands in the re-reserved
    group after the restore (the old group's id is dead)."""
    ha = _sub(rt, "util.ha")
    pg_mod = _sub(rt, "core.placement_group")
    snap = os.path.join(tempfile.mkdtemp(prefix="ha_"), "head2.json")
    rt.init(num_cpus=4)
    try:
        pg = rt.placement_group([{"CPU": 1}], strategy="PACK")
        pg.ready(timeout=30)
        rt.remote(_NamedCounter).options(
            name="pg_actor",
            scheduling_strategy=pg_mod.PlacementGroupSchedulingStrategy(pg),
        ).remote(0)
        first = rt.get(rt.get_actor("pg_actor").incr.remote(), timeout=60)
        old_id = pg.id.hex()
        ha.save_head_state(snap)
    finally:
        rt.shutdown()
    rt.init(num_cpus=4)
    try:
        restored = ha.restore_head_state(snap)
        rows = _sub(rt, "util").placement_group_table()
        live = sorted(rows) if isinstance(rows, dict) else []
        return [first, restored["named_actors"], restored["pgs"],
                rt.get(rt.get_actor("pg_actor").incr.remote(), timeout=60),
                len(live), old_id in live]
    finally:
        rt.shutdown()
        shutil.rmtree(os.path.dirname(snap), ignore_errors=True)


TABLE = {f.__name__: f for f in (
    queue_fifo_and_nowait, queue_maxsize, queue_across_processes,
    pool_map_and_starmap, pool_async_and_imap,
    pool_initializer_and_lifecycle, joblib_backend, scheduling_strategies,
    pubsub_roundtrip, pubsub_from_latest, pubsub_long_poll,
    pubsub_workers_publish, pubsub_ring_bound_and_gaps, pubsub_epoch_rewind,
    usage_and_export, logdir_helpers, session_logs, chaos_worker_kills,
    chaos_actor_restarts, chaos_serve_replica)}
ALONE = {f.__name__: f for f in (ha_round_trip, ha_relinks_placement_group)}


def run(program, rt) -> tuple:
    """("ok", result) or ("raised", class name, message)."""
    try:
        return ("ok", program(rt))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__, str(e))
    finally:
        if rt.is_initialized():
            _sub(rt, "serve").shutdown()


def run_table(name: str, table: dict) -> dict:
    """{program: outcome} of every program of ``table`` on package
    ``name``, in one runtime of ``num_cpus=4``."""
    rt = importlib.import_module(name)
    with table_run(name):
        rt.init(num_cpus=4)
        try:
            return {prog: run(fn, rt) for prog, fn in table.items()}
        finally:
            rt.shutdown()


def run_alone(name: str, table: dict) -> dict:
    """{program: outcome} of programs that start and stop their own
    runtimes, on package ``name``."""
    rt = importlib.import_module(name)
    with table_run(name):
        return {prog: run(fn, rt) for prog, fn in table.items()}


# What each program must give (the same on both packages, and right).
EXPECTED = {
    "queue_fifo_and_nowait": [5, [0, 1, 2, 3, 4], True, "Empty", "Empty"],
    "queue_maxsize": ["Full", "Full", 1, [2, 3], True],
    "queue_across_processes": [6, [0, 10, 20, 30, 40, 50], 0],
    "pool_map_and_starmap": [[x * x for x in range(10)], [21, 43], 65,
                             [x * x for x in range(7)]],
    "pool_async_and_imap": [[0, 1, 4, 9, 16, 25], True, True,
                            [0, 1, 4, 9, 16], [0, 1, 4, 9, 16],
                            [True, [11]], True],
    "pool_initializer_and_lifecycle": [["7", "7"], [0, 1, 4, 9],
                                       "ValueError", "ValueError",
                                       "ValueError"],
    "joblib_backend": [i * i for i in range(8)],
    "scheduling_strategies": ["ran", "ran", "ran", -1, False],
    "pubsub_roundtrip": [1, [{"a": 1}, {"a": 2}], [], [3], 0],
    "pubsub_from_latest": [[], ["new"], ["old", "new"]],
    "pubsub_long_poll": [False, ["wake"], False],
    "pubsub_workers_publish": [[True, True, True],
                               ["from-0", "from-1", "from-2"]],
    "pubsub_ring_bound_and_gaps": [True, 1999, True, ["seen"], 0, 1499,
                                   True, True, ["tail"], 0],
    "pubsub_epoch_rewind": [["a"], ["b"], -1, ["c"], 0],
    "usage_and_export": [
        ["cluster_resources", "collected_at", "num_actors", "num_nodes",
         "tasks_failed", "tasks_finished", "version"], True, 4.0,
        ["cluster_resources", "collected_at", "num_actors", "num_nodes",
         "tasks_failed", "tasks_finished", "version"], True, True, True,
        [False, None]],
    "logdir_helpers": [["a.log", "b.log"], [], ["6789", True],
                       ["012345", True, 6], ["6789ab", 12, 12], "0123456789ab",
                       "no such log file",
                       "log capture is disabled for this session"],
    "session_logs": [True, True, "no such log file"],
    "chaos_worker_kills": [list(range(8)), True],
    "chaos_actor_restarts": ["ok", True, "ok"],
    "chaos_serve_replica": [[], 1, ["serve_replica"], True, True, True],
    "ha_round_trip": [11, {"kv": 1, "named_actors": 1, "pgs": 1},
                      ["kv", "named_actors", "pgs"], ["counter"], 1, b"v1",
                      11, []],
    "ha_relinks_placement_group": [1, ["pg_actor"], 1, 1, 1, False],
}
