"""multiprocessing.Pool API over ray_tpu_torch actors (counterpart of
``ray_tpu/util/multiprocessing.py``).

Reference analog: python/ray/util/multiprocessing/ — a drop-in
``Pool`` whose workers are actors, so ``pool.map`` scales past one
host and survives in the same resource/scheduling world as everything
else. Supported surface: apply/apply_async, map/map_async,
imap/imap_unordered, starmap/starmap_async, context manager,
close/terminate/join.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable

import ray_tpu_torch


class _CallbackWatcher:
    """One daemon thread firing result callbacks in COMPLETION order
    (stdlib Pool's _handle_results model): per-result waiter threads
    would head-of-line block — under joblib, two slow batches would
    stall dispatch of everything behind them."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._entries: dict = {}       # ref -> fire(ref)
        self._thread = None

    def add(self, refs: list, fire) -> None:
        import threading

        with self._lock:
            for r in refs:
                self._entries[r] = fire
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="pool_callback_watcher")
                self._thread.start()
        self._wake.set()

    def _loop(self) -> None:
        while True:
            with self._lock:
                refs = list(self._entries)
            if not refs:
                self._wake.wait(1.0)
                self._wake.clear()
                continue
            done, _rest = ray_tpu_torch.wait(refs, num_returns=1,
                                       timeout=0.5)
            for ref in done:
                with self._lock:
                    fire = self._entries.pop(ref, None)
                if fire is not None:
                    try:
                        fire(ref)
                    except Exception:  # noqa: BLE001 — user callback
                        pass


_watcher = _CallbackWatcher()


@ray_tpu_torch.remote
class _PoolWorker:
    def __init__(self, initializer=None, initargs: tuple = ()):
        if initializer is not None:
            initializer(*initargs)

    def run(self, fn, args, kwargs):
        return fn(*args, **(kwargs or {}))

    def run_chunk(self, fn, chunk, star: bool):
        if star:
            return [fn(*a) for a in chunk]
        return [fn(a) for a in chunk]


class AsyncResult:
    def __init__(self, refs, collect, callback=None,
                 error_callback=None):
        self._refs = refs
        self._collect = collect
        if callback is not None or error_callback is not None:
            # stdlib-Pool semantics (and what joblib relies on): the
            # callback fires when the LAST constituent ref completes,
            # dispatched by the completion-ordered watcher.
            import threading

            remaining = [len(refs)]
            rlock = threading.Lock()

            def fire(_ref):
                with rlock:
                    remaining[0] -= 1
                    if remaining[0] > 0:
                        return
                try:
                    out = self.get(timeout=0)
                except Exception as e:  # noqa: BLE001
                    if error_callback is not None:
                        error_callback(e)
                    return
                if callback is not None:
                    callback(out)

            _watcher.add(list(refs), fire)

    def get(self, timeout: float | None = None):
        return self._collect(
            ray_tpu_torch.get(self._refs, timeout=timeout))

    def wait(self, timeout: float | None = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                     timeout=timeout)

    def ready(self) -> bool:
        done, _ = ray_tpu_torch.wait(self._refs,
                               num_returns=len(self._refs),
                               timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result not ready")
        try:
            ray_tpu_torch.get(self._refs, timeout=0)
            return True
        except Exception:  # noqa: BLE001
            return False


class Pool:
    def __init__(self, processes: int | None = None,
                 initializer: Callable | None = None,
                 initargs: tuple = (), *, num_cpus_per_worker: float = 1):
        if processes is None:
            import os
            processes = max(1, os.cpu_count() or 1)
        if processes < 1:
            raise ValueError("processes must be >= 1")
        self._workers = [
            _PoolWorker.options(num_cpus=num_cpus_per_worker).remote(
                initializer, initargs)
            for _ in range(processes)
        ]
        self._rr = itertools.count()
        self._closed = False
        # In-flight refs: join() must wait for submitted work before
        # tearing workers down (stdlib close()+join() semantics).
        self._inflight: list = []

    # -- helpers -------------------------------------------------------

    def _worker(self):
        if self._closed:
            raise ValueError("Pool not running")
        return self._workers[next(self._rr) % len(self._workers)]

    def _chunks(self, iterable: Iterable, chunksize: int | None):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (4 * len(self._workers))
                            or 1)
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)]

    def _track(self, refs: list) -> list:
        if self._inflight:
            # One wait() pass splits done/pending (a per-ref call
            # here would make dispatch quadratic).
            _done, pending = ray_tpu_torch.wait(
                self._inflight, num_returns=len(self._inflight),
                timeout=0)
            self._inflight = list(pending)
        self._inflight.extend(refs)
        return refs

    def _map_refs(self, fn, iterable, chunksize, star: bool):
        if self._closed or not self._workers:
            raise ValueError("Pool not running")
        return self._track(
            [self._worker().run_chunk.remote(fn, chunk, star)
             for chunk in self._chunks(iterable, chunksize)])

    @staticmethod
    def _flatten(chunks: list[list]) -> list:
        return [x for c in chunks for x in c]

    # -- API -----------------------------------------------------------

    def apply(self, fn, args: tuple = (), kwds: dict | None = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn, args: tuple = (),
                    kwds: dict | None = None, callback=None,
                    error_callback=None) -> AsyncResult:
        ref = self._worker().run.remote(fn, args, kwds)
        self._track([ref])
        return AsyncResult([ref], lambda outs: outs[0],
                           callback=callback,
                           error_callback=error_callback)

    def map(self, fn, iterable: Iterable,
            chunksize: int | None = None) -> list:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn, iterable: Iterable,
                  chunksize: int | None = None) -> AsyncResult:
        refs = self._map_refs(fn, iterable, chunksize, star=False)
        return AsyncResult(refs, self._flatten)

    def starmap(self, fn, iterable: Iterable,
                chunksize: int | None = None) -> list:
        return self.starmap_async(fn, iterable, chunksize).get()

    def starmap_async(self, fn, iterable: Iterable,
                      chunksize: int | None = None) -> AsyncResult:
        refs = self._map_refs(fn, iterable, chunksize, star=True)
        return AsyncResult(refs, self._flatten)

    def imap(self, fn, iterable: Iterable,
             chunksize: int | None = None):
        """Ordered iteration; dispatch is EAGER (stdlib semantics:
        computation overlaps whatever the caller does between
        imap() and iteration)."""
        refs = self._map_refs(fn, iterable, chunksize, star=False)

        def gen():
            for ref in refs:
                yield from ray_tpu_torch.get(ref)

        return gen()

    def imap_unordered(self, fn, iterable: Iterable,
                       chunksize: int | None = None):
        refs = self._map_refs(fn, iterable, chunksize, star=False)

        def gen():
            pending = refs
            while pending:
                done, pending = ray_tpu_torch.wait(pending, num_returns=1)
                for ref in done:
                    yield from ray_tpu_torch.get(ref)

        return gen()

    # -- lifecycle -----------------------------------------------------

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True
        for w in self._workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001
                pass
        self._workers = []

    def join(self) -> None:
        if not self._closed:
            raise ValueError("join() before close()")
        # Let submitted work finish (errors surface at .get, not
        # here) before the workers die.
        if self._inflight:
            try:
                ray_tpu_torch.wait(self._inflight,
                             num_returns=len(self._inflight))
            except Exception:  # noqa: BLE001
                pass
        self.terminate()

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()
