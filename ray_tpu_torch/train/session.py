"""Worker-side training session.

Analog of the reference's ``_TrainSession``
(python/ray/train/_internal/session.py:111,403,667): the user's
``train_loop_per_worker`` calls ``report(metrics, checkpoint=...)``;
results queue up in the worker actor and are drained by the trainer's
poll loop. Checkpoints are persisted worker-side directly to storage
(reference: worker uploads to StorageContext, storage.py:352), so large
states never transit the driver.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Any


@dataclass
class TrainContext:
    world_rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    experiment_name: str = ""
    storage_path: str = ""
    trial_dir: str = ""
    restored_checkpoint_dir: str | None = None
    loop_config: dict = field(default_factory=dict)
    # Per-worker Data shards (trainer ``datasets=`` -> streaming_split
    # -> this worker's DataIterator), keyed by dataset name.
    dataset_shards: dict = field(default_factory=dict)


@dataclass
class ReportedResult:
    metrics: dict[str, Any]
    checkpoint_dir: str | None
    rank: int
    index: int


_session: "_TrainSession | None" = None


class _TrainSession:
    def __init__(self, context: TrainContext):
        self.context = context
        self.results: "queue.Queue[ReportedResult]" = queue.Queue()
        # Seed past the restored checkpoint so checkpoint directory
        # names stay monotonic across gang restarts.
        self._index = checkpoint_index(context.restored_checkpoint_dir) + 1
        self._lock = threading.Lock()
        # Built-in observability: report()-to-report() wall time per
        # rank (the training step cadence) + a monotonically growing
        # step counter, both shipped to the head by the train
        # worker's metrics exporter.
        self._last_report_ts: float | None = None
        from ray_tpu_torch.util.metrics import Counter, Histogram
        tags = {"rank": str(context.world_rank)}
        self._m_step_time = Histogram(
            "ray_tpu_train_step_time_s",
            "seconds between successive train.report() calls",
            boundaries=[0.01, 0.05, 0.1, 0.5, 1, 5, 30, 120],
            tag_keys=("rank",),
        ).set_default_tags(tags)
        self._m_steps = Counter(
            "ray_tpu_train_steps_total",
            "train.report() calls (training steps) per rank",
            tag_keys=("rank",),
        ).set_default_tags(tags)

    def report(self, metrics: dict[str, Any],
               checkpoint: "Checkpoint | None" = None) -> None:
        import time as _time
        now = _time.perf_counter()
        if self._last_report_ts is not None:
            self._m_step_time.observe(now - self._last_report_ts)
        self._last_report_ts = now
        self._m_steps.inc()
        ckpt_dir = None
        if checkpoint is not None:
            ckpt_dir = checkpoint.persist(
                self.context.trial_dir,
                index=self._index,
                rank=self.context.world_rank)
        with self._lock:
            r = ReportedResult(metrics=dict(metrics),
                               checkpoint_dir=ckpt_dir,
                               rank=self.context.world_rank,
                               index=self._index)
            self._index += 1
        self.results.put(r)


def init_session(context: TrainContext) -> _TrainSession:
    global _session
    _session = _TrainSession(context)
    return _session


def shutdown_session() -> None:
    global _session
    _session = None


def get_session() -> _TrainSession:
    if _session is None:
        raise RuntimeError(
            "no train session active — report()/get_context() are only "
            "valid inside train_loop_per_worker")
    return _session


def report(metrics: dict[str, Any], checkpoint=None) -> None:
    """Report metrics (and optionally a checkpoint) from the training
    loop — the worker-side API (reference: train.report)."""
    get_session().report(metrics, checkpoint)


def get_checkpoint():
    """The checkpoint this run was restored from, or None on a fresh
    start (reference: ray.train.get_checkpoint — the canonical
    resume pattern)."""
    ctx = get_context()
    if ctx.restored_checkpoint_dir:
        return Checkpoint(ctx.restored_checkpoint_dir)
    return None


def get_dataset_shard(name: str = "train"):
    """THIS worker's shard of the trainer's ``datasets[name]``
    (reference: ray.train.get_dataset_shard over
    Dataset.streaming_split): a ``data.DataIterator``; feed the step
    with its ``iter_device_batches``."""
    shards = get_context().dataset_shards
    if name not in shards:
        raise KeyError(
            f"no dataset shard {name!r}: pass datasets={{{name!r}: "
            f"ds}} to the trainer (available: {sorted(shards)})")
    return shards[name]


def get_context() -> TrainContext:
    return get_session().context


class Checkpoint:
    """A directory of checkpoint data (reference:
    python/ray/train/_checkpoint.py:56 — dir + filesystem URI).

    Create with ``Checkpoint.from_directory(tmp)`` in the training loop;
    ``persist`` moves/copies it into experiment storage. Write a train
    state into the directory first with
    ``ray_tpu_torch.train.save_train_state``.
    """

    def __init__(self, path: str):
        self.path = path

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(os.path.abspath(path))

    def to_directory(self) -> str:
        return self.path

    def persist(self, trial_dir: str, index: int, rank: int) -> str:
        import shutil
        dest = os.path.join(trial_dir,
                            f"checkpoint_{index:06d}")
        os.makedirs(dest, exist_ok=True)
        # Rank directories let multi-host sharded saves coexist.
        rank_dest = os.path.join(dest, f"rank_{rank}") \
            if rank else dest
        if os.path.abspath(self.path) != os.path.abspath(rank_dest):
            shutil.copytree(self.path, rank_dest, dirs_exist_ok=True)
        # Completion marker: lets the driver trust on-disk checkpoints
        # for recovery even when the worker died before its report was
        # polled (the poll stream is lossy across actor death; disk is
        # the durable record, as in the reference's StorageContext).
        with open(os.path.join(dest, f".complete_rank_{rank}"), "w"):
            pass
        return dest


def checkpoint_index(ckpt_dir: str | None) -> int:
    """Parse the index out of a ``checkpoint_%06d`` directory name
    (-1 when there is no checkpoint)."""
    if not ckpt_dir:
        return -1
    name = os.path.basename(os.path.normpath(ckpt_dir))
    try:
        return int(name.rsplit("_", 1)[1])
    except (IndexError, ValueError):
        return -1
