"""Async input pipeline: overlap host batch production and the
host-to-device copy with device compute.

Counterpart of ``ray_tpu/train/prefetch.py``, with the same stats
(``batches``, ``stall_s``, ``produce_s``), error propagation and close
semantics. A background thread pulls host batches from the source,
places them on the device and parks up to ``depth`` of them in a bounded
queue; the consuming loop pops a ready batch while the next is made.

On the card (:func:`prefetch_to_device` with a CUDA device) placement
copies from pinned host memory with ``non_blocking=True`` on a side
stream, and records an event there. The consumer makes its current
stream wait on that event, and marks the batch's tensors as used by that
stream so the caching allocator does not reuse them early. The host
never blocks on the copy.
"""

from __future__ import annotations

import queue
import threading
import time
from functools import partial
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from ray_tpu_torch.core.accelerator import resolve_device

__all__ = ["DevicePrefetcher", "prefetch_to_device"]

_SENTINEL = object()


class DevicePrefetcher:
    """Iterator yielding device-placed batches produced ahead of
    consumption by a background thread.

    Parameters
    ----------
    source:
        Iterable (or iterator) of host batches. May block (dataset
        reads) — that is exactly the work being overlapped.
    place:
        ``batch -> device batch``; ``None`` passes batches through.
        Runs on the background thread.
    depth:
        Max batches in flight past the one being consumed. 2 = double
        buffering.
    stream:
        A ``torch.cuda.Stream`` that ``place`` runs on. Each batch then
        carries an event recorded after its copies, which the consumer's
        current stream waits on before the batch is handed out.

    Stats: ``batches``, ``stall_s`` (cumulative time the consumer
    blocked waiting — ~0 means input is fully hidden), ``produce_s``
    (cumulative background production + placement time on the host).
    """

    def __init__(self, source: Iterable | Iterator,
                 place: Callable[[Any], Any] | None = None,
                 depth: int = 2,
                 stream: torch.cuda.Stream | None = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._source = iter(source)
        self._place = place
        self._stream = stream
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self.depth = depth
        self.batches = 0
        self.stall_s = 0.0
        self.produce_s = 0.0
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="device_prefetch")
        self._thread.start()

    # -- background producer --

    def _produce(self, batch):
        if self._place is None:
            return batch, None
        if self._stream is None:
            return self._place(batch), None
        with torch.cuda.stream(self._stream):
            batch = self._place(batch)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return batch, ready

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    batch = next(self._source)
                except StopIteration:
                    break
                item = self._produce(batch)
                self.produce_s += time.perf_counter() - t0
                # Bounded put, polling the stop flag so close() never
                # deadlocks against a full queue.
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — surfaced on next()
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    # -- consumer side --

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = self._q.get()
        self.stall_s += time.perf_counter() - t0
        if item is _SENTINEL:
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        batch, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(self._stream.device)
            consumer.wait_event(ready)
            for t in _tensors(batch):
                if t.is_cuda:
                    t.record_stream(consumer)
        self.batches += 1
        return batch

    def close(self) -> None:
        """Stop the producer and release queued batches."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _to_device(tree: Any, device: torch.device) -> Any:
    """Copy every array or tensor leaf of ``tree`` to ``device``: numpy
    arrays become tensors, and CUDA copies go from pinned host memory
    without blocking the host. A numpy array is copied straight into a
    pinned buffer (one host copy, also from a read-only array that the
    object store handed out); a ``dtype=object`` array stays on the
    host as it is."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        if tree.dtype == object:
            return tree
        if device.type == "cuda":
            return _pinned(tree).to(device, non_blocking=True)
        if not tree.flags.writeable:
            tree = tree.copy()     # torch rejects read-only arrays
        return torch.from_numpy(tree)
    if device.type == "cuda" and tree.device.type == "cpu":
        return tree.pin_memory().to(device, non_blocking=True)
    return tree.to(device)


def _pinned(arr: np.ndarray) -> torch.Tensor:
    """A copy of ``arr`` in pinned (page-locked) host memory, the source
    of an asynchronous copy to the card. The caching host allocator
    keeps the buffer until the copies that read it have run."""
    host = torch.empty(arr.shape, dtype=_torch_dtype(arr.dtype),
                       pin_memory=True)
    np.copyto(host.numpy(), arr)
    return host


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def prefetch_to_device(batches: Iterable, device=None, *, depth: int = 2,
                       place: Callable[[Any], Any] | None = None):
    """Wrap an iterable of host batches in a :class:`DevicePrefetcher`
    that places each batch on ``device`` (default: the card) ahead of
    consumption. ``place`` overrides the placement function."""
    device = resolve_device(device)
    if place is None:
        place = partial(_to_device, device=device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    return DevicePrefetcher(batches, place=place, depth=depth, stream=stream)
