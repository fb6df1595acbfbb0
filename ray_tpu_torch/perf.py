"""Core-runtime microbenchmarks of the port (counterpart of
``ray_tpu/perf.py``; the ``ray_perf`` analog), under the JAX package's
metric names and units. Host code: it imports no torch.

Reference: ``python/ray/_private/ray_perf.py`` driven by
``release/microbenchmark/run_microbenchmark.py``; the SURVEY §6 table
(952 sync tasks/s, 1,950 sync actor calls/s, plasma put/get rates) is
the bar these numbers are compared against.

Run: ``python -m ray_tpu_torch.perf [--quick] [--serve]`` — prints one JSON line per
metric: {"metric": ..., "value": ..., "unit": "calls/s"}.
"""

from __future__ import annotations

import json
import time

import numpy as np

import ray_tpu_torch


def timeit(name: str, fn, batch: int = 1, *, seconds: float = 2.0,
           quick: bool = False, unit: str = "calls/s") -> dict:
    """Run fn repeatedly for ~seconds, report batch*iters/elapsed."""
    if quick:
        seconds = 0.5
    # Warm to a STABLE state, not a fixed duration: worker boots are
    # asynchronous, and straggler boots (each importing numpy on
    # one core) can depress a fixed window by ~25x. Keep warming
    # until three consecutive calls agree within 25%, or the warmup
    # budget runs out.
    fn()
    warm_deadline = time.perf_counter() + (1.0 if quick else 5.0)
    prev, stable = None, 0
    while time.perf_counter() < warm_deadline:
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        if prev is not None and 0.75 * prev <= dt <= 1.25 * prev:
            stable += 1
            if stable >= 3:
                break
        else:
            stable = 0
        prev = dt
    iters = 0
    start = time.perf_counter()
    deadline = start + seconds
    while time.perf_counter() < deadline:
        fn()
        iters += 1
    elapsed = time.perf_counter() - start
    value = batch * iters / elapsed
    out = {"metric": name, "value": round(value, 1),
           "unit": unit}
    print(json.dumps(out), flush=True)
    return out


@ray_tpu_torch.remote(num_cpus=1)
def _small_task():
    # num_cpus=1 (reference default): a zero-CPU task escapes the
    # scheduler's concurrency gate entirely, so a 100-task batch would
    # boot 100 fresh workers instead of reusing the pool.
    return b"ok"


@ray_tpu_torch.remote(num_cpus=0)
class _Actor:
    def small_value(self) -> bytes:
        return b"ok"

    def small_value_arg(self, x) -> bytes:
        return b"ok"


@ray_tpu_torch.remote(num_cpus=0)
class _AsyncActor:
    async def small_value(self) -> bytes:
        return b"ok"


@ray_tpu_torch.remote(num_cpus=0)
def _client_task_driver(n_batches: int, batch: int):
    """One 'client' of multi_client_tasks_async: a worker process
    submitting task batches through its own client channel."""
    @ray_tpu_torch.remote(num_cpus=1)
    def _noop():
        return b"ok"

    # Warm to steady state: the first batches grow the shared worker
    # pool (boots are async — a straggler booting inside the timed
    # region reads as a phantom 10x slowdown).
    warm_deadline = time.perf_counter() + 1.5
    while time.perf_counter() < warm_deadline:
        ray_tpu_torch.get([_noop.remote() for _ in range(batch)])
    t0 = time.perf_counter()
    for _ in range(n_batches):
        ray_tpu_torch.get([_noop.remote() for _ in range(batch)])
    return n_batches * batch / (time.perf_counter() - t0)


def run_all(quick: bool = False) -> list[dict]:
    results: list[dict] = []
    own_runtime = False
    try:
        ray_tpu_torch.core.api.get_runtime()
    except Exception:  # noqa: BLE001
        ray_tpu_torch.init(num_cpus=8)
        own_runtime = True

    def rec(r):
        results.append(r)

    try:
        _run_benchmarks(rec, quick)
    finally:
        if own_runtime:
            ray_tpu_torch.shutdown()
    return results


def _run_benchmarks(rec, quick: bool) -> None:
    # Host memcpy bandwidth baseline: every put is at least one
    # source->arena copy, so this is the hard ceiling for the
    # *_put_gigabytes rows on THIS host. Round-to-round put numbers
    # are only comparable through this ratio (r3 recorded 14.1 GiB/s
    # single-client; this host's memcpy ceiling is ~6.8 — the "drop"
    # to ~5 was the host, not the store: 5/6.8 is the single-copy
    # floor at ~75% efficiency).
    src = np.zeros(100 << 20, dtype=np.uint8)
    dst = np.empty_like(src)
    dst[:] = src                                  # touch pages
    t0 = time.perf_counter()
    dst[:] = src
    memcpy_gibs = round(100 / 1024 / (time.perf_counter() - t0), 2)
    row = {"metric": "host_memcpy_gigabytes", "value": memcpy_gibs,
           "unit": "GiB/s"}
    print(json.dumps(row), flush=True)
    rec(row)
    del src, dst

    # Aggregate (multi-stream) memcpy ceiling: the hard upper bound
    # for multi_client_put_gigabytes on THIS host. On a 1-core box
    # the aggregate is no higher than the single stream (4 writers
    # time-slice one core), so a multi-writer target like the
    # reference's 41 GiB/s (32-core metal, release/perf_metrics/
    # microbenchmark.json) is a hardware property, not a store
    # property — compare multi_client_put / this ceiling instead.
    import os as _os
    import threading as _th
    n_streams = 4
    sizes = 25 << 20
    reps = 4
    bufs = [(np.zeros(sizes, dtype=np.uint8),
             np.empty(sizes, dtype=np.uint8)) for _ in range(n_streams)]
    for s, d in bufs:
        d[:] = s                                  # touch pages
    # ONE shared window (barrier release -> last thread done), not a
    # sum of per-stream rates: per-stream windows let an early
    # finisher read near-solo bandwidth while the others still queue
    # (CFS quantum ~ a 25 MiB copy on this host), inflating the
    # "ceiling" above what the hardware delivers concurrently.
    start_bar = _th.Barrier(n_streams)
    spans = [None] * n_streams

    def _stream(i):
        s, d = bufs[i]
        start_bar.wait()
        t0 = time.perf_counter()
        for _ in range(reps):
            d[:] = s
        spans[i] = (t0, time.perf_counter())

    ths = [_th.Thread(target=_stream, args=(i,))
           for i in range(n_streams)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    # Window = earliest post-barrier start to latest finish, measured
    # INSIDE the worker threads: timing from the main thread is
    # skewed by its own rescheduling delay on a contended 1-core host
    # (in either direction, depending on whether it stamps before or
    # after its barrier arrival).
    done = [sp for sp in spans if sp is not None]
    if not done:
        raise RuntimeError("all memcpy streams died before timing")
    window = max(e for _, e in done) - min(s0 for s0, _ in done)
    total_gib = n_streams * reps * sizes / (1 << 30)
    row = {"metric": "host_memcpy_aggregate_gigabytes",
           "value": round(total_gib / window, 2), "unit": "GiB/s",
           "extra": {"streams": n_streams,
                     "cores": _os.cpu_count()}}
    print(json.dumps(row), flush=True)
    rec(row)
    del bufs

    # DevicePrefetcher handoff tax: the background-thread queue hop
    # per batch with a no-op source — the fixed cost the async input
    # pipeline (train/prefetch.py) adds on top of whatever it
    # overlaps; should stay O(10us), invisible next to any real step.
    # The port's prefetcher with place=None, as the JAX row: host
    # only. The module loads torch only where it places a batch, so
    # this harness stays torch-free.
    from ray_tpu_torch.train import prefetch as _pfmod
    n_batches = 500 if quick else 5000
    pf = _pfmod.DevicePrefetcher(iter(range(n_batches)), depth=4)
    t0 = time.perf_counter()
    consumed = sum(1 for _ in pf)
    dt = time.perf_counter() - t0
    pf.close()
    row = {"metric": "prefetch_handoff_overhead",
           "value": round(dt / max(1, consumed) * 1e6, 2),
           "unit": "us/batch", "extra": {"batches": consumed}}
    print(json.dumps(row), flush=True)
    rec(row)

    # -- tasks --
    rec(timeit("single_client_tasks_sync",
               lambda: ray_tpu_torch.get(_small_task.remote()),
               quick=quick))
    rec(timeit("single_client_tasks_async",
               lambda: ray_tpu_torch.get(
                   [_small_task.remote() for _ in range(100)]),
               batch=100, quick=quick))

    # -- actor calls --
    a = _Actor.remote()
    ray_tpu_torch.get(a.small_value.remote())
    rec(timeit("1_1_actor_calls_sync",
               lambda: ray_tpu_torch.get(a.small_value.remote()),
               quick=quick))
    rec(timeit("1_1_actor_calls_async",
               lambda: ray_tpu_torch.get(
                   [a.small_value.remote() for _ in range(100)]),
               batch=100, quick=quick))
    aa = _AsyncActor.options(max_concurrency=8).remote()
    ray_tpu_torch.get(aa.small_value.remote())
    rec(timeit("1_1_async_actor_calls_async",
               lambda: ray_tpu_torch.get(
                   [aa.small_value.remote() for _ in range(100)]),
               batch=100, quick=quick))
    n_actors = 4
    actors = [_Actor.remote() for _ in range(n_actors)]
    ray_tpu_torch.get([b.small_value.remote() for b in actors])
    rec(timeit("n_n_actor_calls_async",
               lambda: ray_tpu_torch.get(
                   [b.small_value.remote() for b in actors
                    for _ in range(25)]),
               batch=25 * n_actors, quick=quick))
    async_actors = [_AsyncActor.options(max_concurrency=8).remote()
                    for _ in range(n_actors)]
    ray_tpu_torch.get([b.small_value.remote() for b in async_actors])
    rec(timeit("n_n_async_actor_calls_async",
               lambda: ray_tpu_torch.get(
                   [b.small_value.remote() for b in async_actors
                    for _ in range(25)]),
               batch=25 * n_actors, quick=quick))

    # -- direct actor-call plane (worker->worker head bypass) ----------
    # The caller must be a WORKER process (the driver talks to its
    # in-process runtime; only ClientRuntime has the bypass): one
    # driver task per caller does async 100-call laps against its
    # actors and reports calls/s plus its own direct/head counters.
    # Rows: direct vs head-routed 1:1 (same machine, same shapes —
    # the pair is the bypass speedup), n:n fan-out, and an
    # inline-arg lap (32 KiB payload rides IN the call frame).
    @ray_tpu_torch.remote(num_cpus=0)
    def _actor_call_driver(handles, n_batches: int, batch: int,
                           payload_kib: int):
        from ray_tpu_torch.core.api import get_runtime
        rt_c = get_runtime()
        arg = b"x" * (payload_kib << 10) if payload_kib else None

        def lap():
            if arg is None:
                refs = [h.small_value.remote()
                        for h in handles for _ in range(batch)]
            else:
                refs = [h.small_value_arg.remote(arg)
                        for h in handles for _ in range(batch)]
            ray_tpu_torch.get(refs, timeout=120)

        lap()                      # head-routed; fires lease resolve
        time.sleep(1.2)            # lease lands; barrier cleared by
        for _ in range(2):         # the lap's get — warm the channel
            lap()
        t0 = time.perf_counter()
        for _ in range(n_batches):
            lap()
        dt = time.perf_counter() - t0
        return (n_batches * batch * len(handles) / dt,
                rt_c.actor_calls_direct, rt_c.actor_calls_head_routed)

    def _direct_bench(name, n_callers, n_actors_row, payload_kib,
                      direct_on):
        env = {} if direct_on else {
            "env_vars": {"RAY_TPU_DIRECT_CALLS_ENABLED": "0"}}
        drv = _actor_call_driver.options(runtime_env=env) \
            if env else _actor_call_driver
        row_actors = [_Actor.remote() for _ in range(n_actors_row)]
        ray_tpu_torch.get([a.small_value.remote() for a in row_actors])
        nb, batch = (3, 30) if quick else (8, 100)
        outs = ray_tpu_torch.get(
            [drv.remote(row_actors, nb, batch, payload_kib)
             for _ in range(n_callers)], timeout=300)
        rate = sum(o[0] for o in outs)
        direct_calls = sum(o[1] for o in outs)
        head_calls = sum(o[2] for o in outs)
        row = {"metric": name, "value": round(rate, 1),
               "unit": "calls/s",
               "extra": {"callers": n_callers,
                         "actors": n_actors_row * n_callers,
                         "calls_direct": direct_calls,
                         "calls_head_routed": head_calls}}
        print(json.dumps(row), flush=True)
        rec(row)
        return row

    d11 = _direct_bench("actor_calls_direct_1_1", 1, 1, 0, True)
    h11 = _direct_bench("actor_calls_head_routed_1_1", 1, 1, 0,
                        False)
    d11["extra"]["speedup_vs_head_routed"] = round(
        d11["value"] / max(h11["value"], 1.0), 2)
    _direct_bench("actor_calls_direct_n_n", 4, 1, 0, True)
    _direct_bench("actor_call_inline_small_args", 1, 1, 32, True)

    # -- wire hardening tax (partition-tolerant wire, core/wire.py) --
    # The checksum + sequence + heartbeat envelope's no-fault cost,
    # isolated on a loopback echo pair: added microseconds per
    # roundtrip (2 wrapped sends + 2 wrapped recvs) over raw
    # multiprocessing connections. Best-of-2 each side — the row
    # tracks the envelope, not the host's scheduler. The e2e contract
    # (direct-call and task rows within 2% of PERF_r07) is pinned by
    # test_perf.py::test_microbench_floors.
    def _echo_rate(wrap: bool, n: int) -> float:
        import threading as _th
        from multiprocessing import Pipe

        from ray_tpu_torch.core import wire as _w
        a, b = Pipe(duplex=True)
        if wrap:
            a = _w.WireConnection(a, kind="perfecho", peer="b")
            b = _w.WireConnection(b, kind="perfecho", peer="a")

        def _echo():
            try:
                while True:
                    b.send(b.recv())
            except (EOFError, OSError):
                pass

        _th.Thread(target=_echo, daemon=True).start()
        msg = ("req", 12345, b"x" * 128)
        for _ in range(500):
            a.send(msg)
            a.recv()
        t0 = time.perf_counter()
        for _ in range(n):
            a.send(msg)
            a.recv()
        dt = time.perf_counter() - t0
        a.close()
        return n / dt

    n_echo = 3000 if quick else 20000
    raw_rt = max(_echo_rate(False, n_echo) for _ in range(2))
    wire_rt = max(_echo_rate(True, n_echo) for _ in range(2))
    ov_us = max(0.0, (1.0 / wire_rt - 1.0 / raw_rt) * 1e6)
    hb_row = {"metric": "heartbeat_overhead",
              "value": round(ov_us, 2), "unit": "us/roundtrip",
              "extra": {"raw_echo_rt_s": round(raw_rt, 1),
                        "wire_echo_rt_s": round(wire_rt, 1),
                        "overhead_pct_of_echo": round(
                            (raw_rt / wire_rt - 1.0) * 100, 1)}}
    print(json.dumps(hb_row), flush=True)
    rec(hb_row)

    # Multiple client processes submitting tasks concurrently
    # (reference: multi_client_tasks_async — each client is its own
    # process with its own submission channel).
    n_clients = 2 if quick else 4
    n_batches, batch = (3, 20) if quick else (10, 50)
    rates = ray_tpu_torch.get(
        [_client_task_driver.remote(n_batches, batch)
         for _ in range(n_clients)], timeout=300)
    mct = {"metric": "multi_client_tasks_async",
           "value": round(sum(rates), 1), "unit": "calls/s",
           "extra": {"clients": n_clients}}
    print(json.dumps(mct), flush=True)
    rec(mct)

    # -- ref-heavy ops (reference: wait_1k_refs / 10k-refs get) --
    refs_1k = [ray_tpu_torch.put(b"x") for _ in range(1000)]
    rec(timeit("single_client_wait_1k_refs",
               lambda: ray_tpu_torch.wait(refs_1k, num_returns=1000,
                                    timeout=60), quick=quick))
    big_list_ref = ray_tpu_torch.put([ray_tpu_torch.put(b"y")
                                for _ in range(10_000)])
    rec(timeit("single_client_get_object_containing_10k_refs",
               lambda: ray_tpu_torch.get(big_list_ref), quick=quick))
    del refs_1k, big_list_ref

    # -- object store --
    small = b"x" * 1024
    rec(timeit("single_client_put_calls_1KiB",
               lambda: ray_tpu_torch.put(small), quick=quick))
    big_ref = ray_tpu_torch.put(np.zeros(1 << 18, dtype=np.uint8))  # 256 KiB
    rec(timeit("single_client_get_calls_256KiB",
               lambda: ray_tpu_torch.get(big_ref), quick=quick))
    chunk = np.zeros(100 << 20, dtype=np.uint8)  # 100 MiB

    def put_big():
        r = ray_tpu_torch.put(chunk)
        del r

    t = timeit("single_client_put_100MiB_calls", put_big, quick=quick)
    rec(t)
    gb = {"metric": "single_client_put_gigabytes",
          "value": round(t["value"] * 100 / 1024, 2),
          "unit": "GiB/s"}
    print(json.dumps(gb), flush=True)
    rec(gb)

    # Multi-client: N workers putting concurrently (reference:
    # multi_client_put_gigabytes, plasma clients writing shm in
    # parallel; the reference sums per-client rates). Here worker
    # puts traverse the client channel into the owner's arena, so
    # this measures the whole ingest path. A barrier actor
    # synchronizes the measured windows — without it, staggered
    # warmups (worker boot, first-touch page faults) leak into other
    # clients' windows and the aggregate reads ~4x low.
    # num_cpus=0: this measures the store's concurrent ingest, not
    # the CPU scheduler — on a 1-core box a CPU gate would serialize
    # the clients.
    n_clients, n_puts, mb = 4, 3 if quick else 8, 50

    @ray_tpu_torch.remote(num_cpus=0)
    class _Barrier:
        def __init__(self, n):
            import threading
            self._need = n
            self._count = 0
            self._lock = threading.Lock()
            self._ev = threading.Event()

        def arrive(self) -> bool:
            with self._lock:
                self._count += 1
                if self._count >= self._need:
                    self._ev.set()
            return self._ev.wait(60)

    @ray_tpu_torch.remote(num_cpus=0)
    def _put_worker(barrier, n_puts: int, mb: int):
        arr = np.zeros(mb << 20, dtype=np.uint8)
        for _ in range(2):     # warm: attach, extents, page tables
            r = ray_tpu_torch.put(arr)
            del r
        if not ray_tpu_torch.get(barrier.arrive.remote(), timeout=90):
            raise RuntimeError(
                "put barrier timed out — windows unsynchronized, the "
                "aggregate would be wrong")
        t0 = time.perf_counter()
        for _ in range(n_puts):
            r = ray_tpu_torch.put(arr)
            del r
        return n_puts * mb / 1024 / (time.perf_counter() - t0)

    barrier = _Barrier.options(
        max_concurrency=n_clients + 1).remote(n_clients)
    rates = ray_tpu_torch.get(
        [_put_worker.remote(barrier, n_puts, mb)
         for _ in range(n_clients)],
        timeout=300)
    mc = {"metric": "multi_client_put_gigabytes",
          "value": round(sum(rates), 2), "unit": "GiB/s",
          "extra": {"clients": n_clients,
                    "per_client": [round(r, 2) for r in rates]}}
    print(json.dumps(mc), flush=True)
    rec(mc)

    # Small-object put storm from N client processes (reference:
    # multi_client_put_calls_Plasma_Store — many writers, 1 KiB
    # objects; measures the control/ingest path, not bandwidth).
    @ray_tpu_torch.remote(num_cpus=0)
    def _put_calls_worker(barrier, n_calls: int):
        payload = b"x" * 1024
        for _ in range(50):                 # warm channel + arena
            r = ray_tpu_torch.put(payload)
            del r
        if not ray_tpu_torch.get(barrier.arrive.remote(), timeout=90):
            raise RuntimeError("put-calls barrier timed out")
        t0 = time.perf_counter()
        for _ in range(n_calls):
            r = ray_tpu_torch.put(payload)
            del r
        return n_calls / (time.perf_counter() - t0)

    n_calls = 200 if quick else 2000
    barrier2 = _Barrier.options(
        max_concurrency=n_clients + 1).remote(n_clients)
    rates = ray_tpu_torch.get(
        [_put_calls_worker.remote(barrier2, n_calls)
         for _ in range(n_clients)],
        timeout=300)
    row = {"metric": "multi_client_put_calls_1KiB",
           "value": round(sum(rates), 1), "unit": "calls/s",
           "extra": {"clients": n_clients,
                     "per_client": [round(r) for r in rates]}}
    print(json.dumps(row), flush=True)
    rec(row)

    # -- object plane: fan-in batched get vs per-ref serial loop --
    # A worker (deser cache disabled) pulls 64 × 1 MiB owner-resident
    # objects through its client channel — serial = one blocking
    # OP_GET round trip per ref (what a `[get(r) for r in refs]`
    # loop pays), batched = one OP_GET_MANY round for the whole list
    # (the vectorized object-plane path). The headline pair uses the
    # same-host fast path (shm descriptors, zero-copy reads) where
    # the win is the 64 saved RTTs; the wire pair (RAY_TPU_NO_SHM)
    # tracks the byte-moving transfer plane, which is memcpy-bound on
    # one host.
    fanin_n, fanin_mib = 64, 1
    fan_refs = [ray_tpu_torch.put(np.zeros(fanin_mib << 20, dtype=np.uint8))
                for _ in range(fanin_n)]

    @ray_tpu_torch.remote(num_cpus=0)
    def _fanin_get(ref_lists, serial: bool, reps: int):
        refs = ref_lists[0]     # nested so the driver ships refs,
        best = 0.0              # not pre-resolved values
        for _ in range(reps + 1):   # first rep warms, best-of rest
            t0 = time.perf_counter()
            if serial:
                vals = [ray_tpu_torch.get(r) for r in refs]
            else:
                vals = ray_tpu_torch.get(refs)
            dt = time.perf_counter() - t0
            total = sum(v.nbytes for v in vals)
            best = max(best, total / dt)
        return best

    reps = 2 if quick else 4
    for tag, env_vars in (
            ("", {"RAY_TPU_DESER_CACHE_MAX_BYTES": "0"}),
            ("wire_", {"RAY_TPU_NO_SHM": "1",
                       "RAY_TPU_DESER_CACHE_MAX_BYTES": "0"})):
        task = _fanin_get.options(
            runtime_env={"env_vars": dict(env_vars)})
        serial_bps = ray_tpu_torch.get(
            task.remote([fan_refs], True, reps), timeout=300)
        batched_bps = ray_tpu_torch.get(
            task.remote([fan_refs], False, reps), timeout=300)
        for name, bps in (
                (f"fanin_get_{tag}{fanin_n}x{fanin_mib}MiB_serial",
                 serial_bps),
                (f"fanin_get_{tag}{fanin_n}x{fanin_mib}MiB_batched",
                 batched_bps)):
            row = {"metric": name,
                   "value": round(bps / (1 << 30), 3),
                   "unit": "GiB/s"}
            if name.endswith("batched"):
                row["extra"] = {
                    "speedup_vs_serial":
                    round(batched_bps / max(serial_bps, 1.0), 2)}
            print(json.dumps(row), flush=True)
            rec(row)
    del fan_refs

    # -- object plane: repeated get of one large ref (deser cache) --
    # Steady-state actor-broadcast shape: the same 64 MiB object
    # fetched over and over. After the first get the driver serves
    # the deserialized value from its per-process LRU (zero-copy
    # views pinned in the shared arena), so this measures the cache
    # hit path; extra.cache_hits proves the cache actually served.
    rt_obj = ray_tpu_torch.core.api.get_runtime()
    big_ref = ray_tpu_torch.put(np.zeros(64 << 20, dtype=np.uint8))
    ray_tpu_torch.get(big_ref)                      # fill
    hits0 = getattr(rt_obj, "deser_cache_hits", 0)
    rec(timeit("repeated_get_64MiB_cached",
               lambda: ray_tpu_torch.get(big_ref), quick=quick))
    hits_row = {"metric": "repeated_get_64MiB_cache_hits",
                "value": getattr(rt_obj, "deser_cache_hits", 0)
                - hits0,
                "unit": "hits"}
    print(json.dumps(hits_row), flush=True)
    rec(hits_row)
    del big_ref

    # -- robustness: graceful node drain latency -----------------------
    # drain_node_64_tasks: wall-clock seconds for drain_node() to
    # empty a node targeted by a 64-task fan-out — grace-finish the
    # running wave, preempt stragglers, exclude the node from further
    # placement — then remove it. Zero-loss is asserted (every task
    # still returns, no lineage reconstruction). Lower is better.
    nid = rt_obj.add_node({"CPU": 8.0})

    @ray_tpu_torch.remote(num_cpus=1)
    def _drain_task(i):
        time.sleep(0.05)
        return i

    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )
    pin = NodeAffinitySchedulingStrategy(nid, soft=True)
    recon0 = rt_obj.lineage_reconstructions
    refs = [_drain_task.options(scheduling_strategy=pin).remote(i)
            for i in range(64)]
    time.sleep(0.3)                # let a wave land on the node
    t0 = time.perf_counter()
    rt_obj.drain_node(nid, reason="perf drain", deadline_s=30.0,
                      remove=True)
    drain_s = time.perf_counter() - t0
    vals = ray_tpu_torch.get(refs, timeout=120)
    assert sorted(vals) == list(range(64)), "drain lost tasks"
    assert rt_obj.lineage_reconstructions == recon0
    row = {"metric": "drain_node_64_tasks",
           "value": round(drain_s, 3), "unit": "s",
           "extra": {"tasks_preempted": rt_obj.drain_tasks_preempted,
                     "reconstructions":
                     rt_obj.lineage_reconstructions - recon0}}
    print(json.dumps(row), flush=True)
    rec(row)

    # -- observability: metrics pipeline cost --------------------------
    # metrics_flush_overhead: full exporter flush units/s for a
    # 100-series registry — snapshot + head-side ingest + one cluster
    # exposition render per unit. This is what every worker pays once
    # per metrics_report_interval_s, and what the head pays per scrape.
    from ray_tpu_torch.observability.aggregator import (
        ClusterMetricsAggregator,
    )
    from ray_tpu_torch.observability.snapshot import snapshot_registry
    from ray_tpu_torch.util.metrics import Counter as _Counter

    flush_counters = [
        _Counter(f"perf_flush_metric_{i}", "flush-overhead probe",
                 ("k",)) for i in range(100)]
    for i, c in enumerate(flush_counters):
        c.inc(tags={"k": str(i)})
    agg = ClusterMetricsAggregator()

    def one_flush():
        agg.ingest("perf_node", "perf_worker",
                   snapshot_registry(), time.time())
        agg.prometheus_text()

    rec(timeit("metrics_flush_overhead", one_flush,
               unit="flushes/s", quick=quick))

    # Instrumented vs disabled task submit: the same sync-task lap
    # with the head-side observability pipeline on (session default)
    # and off. The delta bounds what the plane costs the task hot
    # path; the disabled row is the guardrail baseline (near-zero
    # overhead is also pinned by tests/test_perf.py on the
    # worker-side recording hot path).
    rec(timeit("task_submit_instrumented",
               lambda: ray_tpu_torch.get(_small_task.remote()),
               quick=quick))
    plane = rt_obj.observability
    plane.set_enabled(False)
    try:
        rec(timeit("task_submit_uninstrumented",
                   lambda: ray_tpu_torch.get(_small_task.remote()),
                   quick=quick))
    finally:
        plane.set_enabled(True)

    # -- introspection plane (PR-4) ------------------------------------
    # memory_summary_1k_objects: full cluster memory summaries per
    # second over a 1000-object directory — the `ray_tpu memory` /
    # /api/v1/memory serving cost at a realistic table size.
    ms_refs = [ray_tpu_torch.put(b"m" * 256) for _ in range(1000)]
    rec(timeit("memory_summary_1k_objects",
               lambda: rt_obj.memory_summary(top_n=20),
               unit="calls/s", quick=quick))
    del ms_refs

    # profiler_sampling_overhead: % slowdown of a pure-Python spin
    # loop while a 100 Hz in-process sampler runs, vs unprofiled.
    # This is the price a LIVE capture puts on the target process;
    # the no-session price is a bare flag (tests/test_perf.py pins
    # it near zero).
    import threading as _thr

    from ray_tpu_torch.observability import profiler as _prof

    def _spin(n=200_000):
        x = 0
        for i in range(n):
            x += i
        return x

    def _best_spin(reps=5):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            _spin()
            best = min(best, time.perf_counter() - t0)
        return best

    _spin()                                   # warm
    base = _best_spin()
    sampler = _thr.Thread(
        target=_prof.sample_stacks,
        kwargs={"duration_s": 8.0 * base * 6 + 1.0, "hz": 100.0},
        daemon=True)
    sampler.start()
    time.sleep(0.05)                          # sampler ticking
    profiled = _best_spin()
    sampler.join()
    overhead_pct = max(0.0, (profiled - base) / base * 100.0)
    row = {"metric": "profiler_sampling_overhead",
           "value": round(overhead_pct, 1), "unit": "%",
           "extra": {"spin_base_s": round(base, 5),
                     "spin_profiled_s": round(profiled, 5),
                     "hz": 100}}
    print(json.dumps(row), flush=True)
    rec(row)

    # trace_assembly_1k_spans: head-side TraceStore cost for one
    # 1000-span trace — ingest (span-id dedupe) + full assembly
    # (tree build, per-span self-times, critical path). This is what
    # a runtime.get_trace / dashboard /api/v1/traces/<id> hit pays
    # on a deep trace.
    from ray_tpu_torch.observability.tracestore import TraceStore as _TS
    _tbase = time.time()
    _tspans = [{
        "name": f"s{i}", "trace_id": "a" * 16,
        "span_id": f"sp{i:04d}",
        "parent_id": None if i == 0 else f"sp{(i - 1) // 2:04d}",
        "start": _tbase + i * 1e-4,
        "end": _tbase + 0.5 + i * 1e-4,
        "attributes": {}, "process": "perf",
    } for i in range(1000)]

    def _one_assembly():
        ts = _TS(max_traces=4)
        ts.add_spans(_tspans)
        t = ts.get_trace("a" * 16)
        assert t is not None and t["num_spans"] == 1000

    rec(timeit("trace_assembly_1k_spans", _one_assembly,
               unit="assemblies/s", quick=quick))

    # -- signals plane (head time series + SLO engine) -----------------
    # signals_ingest_overhead: SignalStore.sample() calls/s over the
    # same 100-series registry the flush row uses — what the head's
    # signals loop pays once per signals_sample_interval_s. Timestamps
    # advance a fake clock: sample() is keyed on monotonic ts, and
    # wall time would collapse the whole bench into one ring slot.
    from ray_tpu_torch.observability.slo import SloEngine as _Slo
    from ray_tpu_torch.observability.slo import SloRule as _SloRule
    from ray_tpu_torch.observability.timeseries import SignalStore as _SS

    sig_store = _SS(interval_s=1.0, retention_s=600.0)
    _sig_ts = [time.time()]

    def _one_sample():
        _sig_ts[0] += 1.0
        sig_store.sample(agg.merged(), _sig_ts[0])

    rec(timeit("signals_ingest_overhead", _one_sample,
               unit="samples/s", quick=quick))

    # slo_eval_1k_rules: full burn-rate evaluations/s of a 1000-rule
    # SLO engine against the store just filled above (each rule is a
    # rate query over fast+slow windows). export_gauges=False keeps
    # 3k synthetic gauge series out of the live registry.
    slo_rules = [
        _SloRule(name=f"perf_rule_{i}",
                 signal=f"perf_flush_metric_{i % 100}",
                 kind="rate", target=1e12)
        for i in range(1000)]
    slo_eng = _Slo(rules=slo_rules, auto_rules=False,
                   export_gauges=False)

    rec(timeit("slo_eval_1k_rules",
               lambda: slo_eng.evaluate(sig_store, _sig_ts[0]),
               unit="evals/s", quick=quick))

    # -- scale envelope (PR-13 indexed pending paths) ------------------
    # One-shot throughput rows pinning the scheduler's indexed
    # structures at tier-1-sized N; the full envelope (1k actors,
    # 100k tasks, 500 PGs, chaos overlay) is scripts/scale_driver.py
    # -> SCALE_r01.json. Each row reports a rate plus elapsed and the
    # peak head queue depth observed while it ran.
    import threading as _sthr

    def _run_with_depth_sampler(fn):
        peak = [0]
        stop = _sthr.Event()

        def _sample():
            while not stop.wait(0.005):
                peak[0] = max(peak[0], rt_obj.pending_count())

        s = _sthr.Thread(target=_sample, daemon=True)
        s.start()
        t0 = time.perf_counter()
        fn()
        el = time.perf_counter() - t0
        stop.set()
        s.join(timeout=1.0)
        return el, peak[0]

    n_act = 25 if quick else 100

    def _actor_wave():
        handles = [_Actor.remote() for _ in range(n_act)]
        ray_tpu_torch.get([h.small_value.remote() for h in handles],
                    timeout=300)
        for h in handles:
            ray_tpu_torch.kill(h)

    el, peak = _run_with_depth_sampler(_actor_wave)
    row = {"metric": "actors_create_call_100",
           "value": round(n_act / el, 1), "unit": "actors/s",
           "extra": {"n": n_act, "elapsed_s": round(el, 3),
                     "peak_queue_depth": peak}}
    print(json.dumps(row), flush=True)
    rec(row)

    n_drain = 1000 if quick else 5000

    def _flood_drain():
        refs = [_small_task.remote() for _ in range(n_drain)]
        ray_tpu_torch.get(refs, timeout=600)

    el, peak = _run_with_depth_sampler(_flood_drain)
    row = {"metric": "task_drain_5k",
           "value": round(n_drain / el, 1), "unit": "tasks/s",
           "extra": {"n": n_drain, "elapsed_s": round(el, 3),
                     "peak_queue_depth": peak}}
    print(json.dumps(row), flush=True)
    rec(row)

    from ray_tpu_torch.util import (placement_group as _pg_create,
                              remove_placement_group as _pg_remove)
    n_pg = 10 if quick else 50

    def _pg_wave():
        pgs = [_pg_create([{"CPU": 0.01}]) for _ in range(n_pg)]
        for pg in pgs:
            assert pg.ready(timeout=60), "pg never became ready"
        for pg in pgs:
            _pg_remove(pg)

    el, peak = _run_with_depth_sampler(_pg_wave)
    row = {"metric": "pg_create_50",
           "value": round(n_pg / el, 1), "unit": "pgs/s",
           "extra": {"n": n_pg, "elapsed_s": round(el, 3),
                     "peak_queue_depth": peak}}
    print(json.dumps(row), flush=True)
    rec(row)


def _free_port() -> int:
    """A TCP port on 127.0.0.1 that no socket holds now."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_serve_bench(quick: bool = False) -> list[dict]:
    """Serve benchmarks: handle requests/s, HTTP proxy echo with the
    retry plane on vs off (the ≤5% disabled-path guardrail pair,
    tests/test_perf.py), and a mini chaos soak p99 with one seeded
    replica kill mid-stream (the zero-loss latency row)."""
    import http.client

    from ray_tpu_torch import serve

    results: list[dict] = []

    @serve.deployment(num_replicas=2)
    class Echo:
        def __call__(self, x):
            return x

    http_port, noretry_port = _free_port(), _free_port()
    handle = serve.run(Echo.bind(), http_port=http_port)
    handle.remote(0).result(timeout_s=60)
    out = timeit(
        "serve_requests_per_s",
        lambda: ray_tpu_torch.get([handle.remote(i) for i in range(20)],
                            timeout=60),
        batch=20, quick=quick)
    rpcs = handle._router.controller_rpcs
    out["extra"] = {"controller_rpcs_during_bench": rpcs}
    results.append(out)

    def _echo_loop(port: int, n: int = 20):
        # One keep-alive connection per timing call: the row measures
        # the proxy dispatch path, not TCP handshakes.
        conn = http.client.HTTPConnection("127.0.0.1", port)

        def fn():
            for i in range(n):
                conn.request("POST", "/", body=json.dumps(i))
                resp = conn.getresponse()
                body = resp.read()
                if resp.status != 200:
                    raise RuntimeError(
                        f"proxy echo {resp.status}: {body[:200]!r}")
        return fn

    results.append(timeit("serve_proxy_echo",
                          _echo_loop(http_port),
                          batch=20, quick=quick))

    # Second proxy, SAME replica set, retry plane hard-disabled: the
    # overhead pair differs only in the router call path (config flips
    # in the driver don't reach spawned actors, hence the explicit
    # override).
    from ray_tpu_torch.serve.proxy import ProxyActor
    noretry = ProxyActor.options(num_cpus=0, max_concurrency=32).remote(
        noretry_port, retry_enabled=False)
    ray_tpu_torch.get(noretry.ready.remote(), timeout=30)
    ray_tpu_torch.get(noretry.set_routes.remote(
        {"/": {"name": "Echo", "asgi": False}}))
    results.append(timeit("serve_proxy_echo_noretry",
                          _echo_loop(noretry_port),
                          batch=20, quick=quick))

    # Mini chaos soak: sequential handle requests with ONE seeded
    # replica kill mid-stream; every request must succeed (the retry
    # plane re-dispatches; the controller respawns). p99 in ms.
    from ray_tpu_torch.util.chaos import ResourceKiller
    n_req = 120 if quick else 400
    lat: list[float] = []
    failed = 0
    killer = None
    for i in range(n_req):
        if i == n_req // 3:
            killer = ResourceKiller(kind="serve_replica",
                                    interval_s=0.05, max_kills=1,
                                    seed=42).start()
        t0 = time.perf_counter()
        try:
            handle.remote(i).result(timeout_s=60)
        except Exception:  # noqa: BLE001
            failed += 1
            continue
        lat.append((time.perf_counter() - t0) * 1e3)
    kills = killer.stop() if killer else 0
    lat.sort()
    p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))] if lat else -1.0
    row = {"metric": "serve_soak_p99", "value": round(p99, 2),
           "unit": "ms",
           "extra": {"requests": n_req, "failed": failed,
                     "kills": kills,
                     "p50": round(lat[len(lat) // 2], 2) if lat
                     else -1.0}}
    print(json.dumps(row), flush=True)
    results.append(row)

    serve.shutdown()
    return results


def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="ray_tpu_torch microbenchmarks")
    ap.add_argument("--quick", action="store_true",
                    help="0.5s per metric instead of 2s")
    ap.add_argument("--serve", action="store_true",
                    help="include the serve requests/s benchmark")
    args = ap.parse_args(argv)
    # Logical CPUs above the physical count: microbench workloads are
    # tiny RPCs, and serve needs room for its replicas even on a
    # 1-core host.
    ray_tpu_torch.init(num_cpus=8)
    try:
        run_all(quick=args.quick)
        if args.serve:
            run_serve_bench(quick=args.quick)
    finally:
        ray_tpu_torch.shutdown()
    return 0


if __name__ == "__main__":
    # Route through the importable module: under `python -m`, the
    # remote functions above would live in __main__ and cloudpickle
    # them by value per submission — that benchmarks the by-value
    # serialization path, not the framework's steady-state task path.
    from ray_tpu_torch import perf as _perf
    raise SystemExit(_perf.main())
