"""Distributed FIFO queue backed by an actor.

Counterpart of ``ray_tpu/util/queue.py``, on the port's runtime.
Reference analog: ray.util.queue.Queue (python/ray/util/queue.py) —
an asyncio-queue actor shared by producers/consumers across
processes.
"""

from __future__ import annotations

import time
from collections import deque

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote
class _QueueActor:
    """Single-threaded on purpose (the reference uses an asyncio
    actor): check-then-act on the deque must not interleave."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.items: deque = deque()

    def put(self, item) -> bool:
        if self.maxsize > 0 and len(self.items) >= self.maxsize:
            return False
        self.items.append(item)
        return True

    def get(self):
        if not self.items:
            return False, None
        return True, self.items.popleft()

    def can_put(self) -> bool:
        return self.maxsize <= 0 or len(self.items) < self.maxsize

    def qsize(self) -> int:
        return len(self.items)


class Queue:
    """Cross-process FIFO; handles are picklable, so any worker/actor
    can produce or consume."""

    def __init__(self, maxsize: int = 0, *, actor_options: dict
                 | None = None):
        opts = {"num_cpus": 0, **(actor_options or {})}
        self._actor = _QueueActor.options(**opts).remote(maxsize)

    def put(self, item, block: bool = True,
            timeout: float | None = None) -> None:
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        if ray_tpu_torch.get(self._actor.put.remote(item), timeout=60):
            return
        if not block:
            raise Full()
        while True:
            if deadline is not None and time.monotonic() > deadline:
                raise Full()
            # Probe cheaply while full — re-shipping the item payload
            # every poll would re-serialize it each time.
            if ray_tpu_torch.get(self._actor.can_put.remote(), timeout=60):
                if ray_tpu_torch.get(self._actor.put.remote(item),
                               timeout=60):
                    return
            time.sleep(0.02)

    def get(self, block: bool = True, timeout: float | None = None):
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        while True:
            ok, item = ray_tpu_torch.get(self._actor.get.remote(),
                                   timeout=60)
            if ok:
                return item
            if not block:
                raise Empty()
            if deadline is not None and time.monotonic() > deadline:
                raise Empty()
            time.sleep(0.02)

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def get_nowait(self):
        return self.get(block=False)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote(), timeout=60)

    def empty(self) -> bool:
        return self.qsize() == 0

    def __reduce__(self):
        return (_rebuild_queue, (self._actor,))


def _rebuild_queue(actor):
    q = object.__new__(Queue)
    q._actor = actor
    return q
