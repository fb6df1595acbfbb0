"""TorchTrainer — the DataParallelTrainer analog of the port.

Counterpart of the JAX package's ``JaxTrainer``: the same constructor,
``fit() -> Result``, retries from the newest complete checkpoint, and
the same trial-directory layout. Reference call stack (SURVEY.md §3.4):
BaseTrainer.fit → WorkerGroup of actors → backend process-group setup →
per-worker loop → report()/checkpoint → poll. Here:

- the "backend" is a ``torch.distributed`` default group over the gang
  (``parallel.initialize``; rank 0's address is the rendezvous): NCCL,
  one card a rank, when ``ScalingConfig.gpus_per_worker`` is set, else
  gloo. Every rank joins it before the loop starts, one rank too;
- a loop builds its mesh and step over that group
  (``parallel.make_mesh``, ``train.make_train_step``);
- failure handling restarts the whole gang from the latest checkpoint,
  driven by FailureConfig(max_failures);
- ``datasets=`` travel to every worker as ``Dataset.streaming_split``
  iterators (or one whole-dataset iterator each, per
  ``DataConfig.datasets_to_split``); a worker reads its own through
  ``train.get_dataset_shard(name)``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ray_tpu_torch.core.config import temp_path
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.worker_group import WorkerGroup


@dataclass
class Result:
    metrics: dict[str, Any]
    checkpoint_dir: str | None
    path: str
    metrics_history: list[dict[str, Any]] = field(default_factory=list)
    error: str | None = None
    # When RunConfig.storage_path is a URI: the mirrored location of
    # the final checkpoint in remote storage.
    remote_checkpoint_uri: str | None = None

    @property
    def checkpoint(self):
        from ray_tpu_torch.train.session import Checkpoint
        if self.checkpoint_dir is None:
            return None
        return Checkpoint(self.checkpoint_dir)


class TorchTrainer:
    """Distributed data-parallel (and beyond) PyTorch training.

    train_loop_per_worker runs inside each gang worker; it uses
    ``ray_tpu_torch.train.get_context()`` for rank/size and
    ``ray_tpu_torch.train.report(metrics, checkpoint=...)`` to stream
    results. Report Python numbers (``float(loss)``), taken after the
    step: they are what travels to the driver.

    For the device hot loop, build the step with
    ``train.make_train_step`` (one captured CUDA graph on the card) and
    feed it from ``train.prefetch_to_device``, or with ``datasets=``
    from ``train.get_dataset_shard(name).iter_device_batches(batch)``,
    so host input staging overlaps device compute.
    """

    def __init__(self,
                 train_loop_per_worker: Callable,
                 *,
                 train_loop_config: dict | None = None,
                 scaling_config: ScalingConfig | None = None,
                 run_config: RunConfig | None = None,
                 datasets: dict | None = None,
                 dataset_config=None):
        self.train_loop = train_loop_per_worker
        self.loop_config = train_loop_config or {}
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        # Dataset name -> ray_tpu_torch.data.Dataset, split across the
        # workers, which read via train.get_dataset_shard(name)
        # (reference: DataParallelTrainer datasets= + DataConfig).
        self.datasets = datasets or {}
        from ray_tpu_torch.train.config import DataConfig
        self.dataset_config = dataset_config or DataConfig()

    # -- public API --

    def fit(self) -> Result:
        self._check_gpus()
        name = (self.run_config.name
                or f"train_{int(time.time())}_{os.urandom(3).hex()}")
        from ray_tpu_torch.util.storage import is_uri
        remote_uri = None
        if is_uri(self.run_config.storage_path):
            # Remote storage_path (reference: StorageContext's
            # fs/S3/GS URIs, storage.py:352): run against a local
            # staging dir, mirror the trial tree to the URI at every
            # exit — results and checkpoints land off-host. Workers
            # still write to the staging dir (single host or shared
            # FS), exactly the reference's local-then-upload flow.
            from ray_tpu_torch.util.storage import stage_dir, uri_join
            remote_uri = uri_join(self.run_config.storage_path, name)
            trial_dir = stage_dir(
                temp_path("ray_tpu_torch_experiments_staging"), name)
        else:
            trial_dir = os.path.join(self.run_config.storage_path,
                                     name)
        os.makedirs(trial_dir, exist_ok=True)

        max_failures = self.run_config.failure_config.max_failures
        attempt = 0
        restored: str | None = None
        # Checkpoints already in the trial dir belong to a previous
        # run reusing this name — never silently resume from them.
        try:
            preexisting = frozenset(os.listdir(trial_dir))
        except OSError:
            preexisting = frozenset()
        while True:
            try:
                return self._mirror(trial_dir, remote_uri,
                                    self._fit_once(trial_dir,
                                                   restored))
            except _WorkerGroupError as e:
                attempt += 1
                # Workers persist checkpoints to storage before the
                # driver polls the matching report, so on actor death
                # the on-disk record can be ahead of e.latest_ckpt —
                # recover from whichever is newest.
                latest = _latest_complete_checkpoint(
                    trial_dir, e.latest_ckpt, exclude=preexisting,
                    world_size=self.scaling.num_workers)
                if max_failures >= 0 and attempt > max_failures:
                    return self._mirror(trial_dir, remote_uri, Result(
                        metrics={}, checkpoint_dir=latest,
                        path=trial_dir, error=e.error))
                # Restart the gang from the latest checkpoint.
                restored = latest

    def _mirror(self, trial_dir: str, remote_uri: str | None,
                result: Result) -> Result:
        if remote_uri is None:
            return result
        from ray_tpu_torch.util.storage import mirror_dir, uri_join
        err = mirror_dir(trial_dir, remote_uri)
        if err:
            # A failed mirror must NOT discard a finished Result —
            # everything still exists locally; surface the problem
            # on the result instead of raising away hours of work.
            result.error = ((result.error or "") + " " + err).strip()
            return result
        result.path = remote_uri
        if result.checkpoint_dir:
            rel = os.path.relpath(result.checkpoint_dir, trial_dir)
            if not rel.startswith(".."):
                result.remote_checkpoint_uri = uri_join(remote_uri,
                                                        rel)
        return result

    # -- internals --

    def _check_gpus(self) -> None:
        """The gang's cards must exist: without them the placement
        group would only wait for its timeout."""
        import ray_tpu_torch
        need = self.scaling.num_workers * self.scaling.gpus_per_worker
        have = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
        if need > have:
            raise RuntimeError(
                f"TorchTrainer needs {need} GPU ({self.scaling.num_workers}"
                f" workers x gpus_per_worker="
                f"{self.scaling.gpus_per_worker}) and the cluster has "
                f"{have:g}; it trains on the card by default (pass "
                f"ScalingConfig(gpus_per_worker=0) to train on the CPU)")

    def _fit_once(self, trial_dir: str, restored: str | None) -> Result:
        group = WorkerGroup(
            num_workers=self.scaling.num_workers,
            resources_per_worker=self.scaling.worker_resources(),
            placement_strategy=self.scaling.placement_strategy,
        )
        latest_ckpt: str | None = restored
        history: list[dict] = []
        try:
            group.barrier()
            # Every gang joins one process group, a single worker too,
            # at the address rank 0 advertises. On the card each rank
            # sees every card of the gang, so NCCL can reach its peers'
            # cards directly (the reference shares CUDA_VISIBLE_DEVICES
            # across a node's workers for the same reason).
            gang_cards = None
            if self.scaling.device == "cuda":
                gang_cards = sorted(
                    {i for ids in group.run("gpu_ids", timeout=60)
                     for i in ids}, key=str)
            # Backend knobs (train.torch.TorchConfig's timeout) ride the
            # rendezvous payload.
            group.run("setup_distributed", group.coordinator(),
                      self.scaling.device, gang_cards, timeout=120,
                      **(getattr(self, "_backend_setup_extra", None) or {}))
            ctx_kwargs = {
                "experiment_name": os.path.basename(trial_dir),
                "storage_path": self.run_config.storage_path,
                "trial_dir": trial_dir,
                "restored_checkpoint_dir": restored,
            }
            if self.datasets:
                # DataConfig.datasets_to_split: "all" or a list of
                # names; unsplit datasets replicate — every worker
                # iterates the full stream (reference: DataConfig).
                to_split = self.dataset_config.datasets_to_split
                ctx_kwargs["dataset_shards_all"] = {
                    name: (ds.streaming_split(group.num_workers)
                           if (to_split == "all" or name in to_split)
                           else [ds.iterator()] * group.num_workers)
                    for name, ds in self.datasets.items()}
            group.run("start_loop", (self.train_loop, self.loop_config),
                      ctx_kwargs, timeout=120)

            final_metrics: dict = {}
            done = [False] * group.num_workers
            while not all(done):
                polls = group.run("poll", timeout=600)
                for i, p in enumerate(polls):
                    if p["error"]:
                        raise _WorkerGroupError(p["error"], latest_ckpt)
                    for r in p["results"]:
                        if r["rank"] == 0:
                            history.append(r["metrics"])
                            final_metrics = r["metrics"]
                        if r["checkpoint_dir"]:
                            latest_ckpt = r["checkpoint_dir"]
                    done[i] = p["done"]
                if not all(done):
                    time.sleep(0.05)
            return Result(metrics=final_metrics,
                          checkpoint_dir=latest_ckpt, path=trial_dir,
                          metrics_history=history)
        except _WorkerGroupError:
            raise
        except Exception as e:  # noqa: BLE001 — actor/infra failure
            raise _WorkerGroupError(str(e), latest_ckpt) from e
        finally:
            group.shutdown()


def _latest_complete_checkpoint(
        trial_dir: str, polled: str | None, *,
        exclude: frozenset[str] = frozenset(),
        world_size: int = 1) -> str | None:
    """Newest on-disk checkpoint that finished persisting, preferring
    disk over the lossy polled report stream. Complete = rank 0's
    marker exists AND, when the save is sharded (any ``rank_N/``
    present), ALL ``world_size`` ranks have their markers — a rank
    that died before even creating its shard directory must not make
    the checkpoint look complete. Rank-0-only checkpoints (replicated
    state) have no rank dirs and stay accepted. ``exclude`` filters
    out checkpoints from a previous run reusing the name."""
    from ray_tpu_torch.train.session import checkpoint_index

    def complete(d: str) -> bool:
        path = os.path.join(trial_dir, d)
        if not os.path.exists(os.path.join(path, ".complete_rank_0")):
            return False
        try:
            entries = os.listdir(path)
        except OSError:
            return False
        sharded = any(e.startswith("rank_") and e[5:].isdigit()
                      for e in entries)
        if not sharded:
            return True
        return all(f".complete_rank_{r}" in entries
                   for r in range(world_size))

    best = polled
    try:
        names = sorted(
            d for d in os.listdir(trial_dir)
            if d.startswith("checkpoint_") and d not in exclude
            and complete(d))
    except OSError:
        return best
    if names and checkpoint_index(names[-1]) > checkpoint_index(best):
        best = os.path.join(trial_dir, names[-1])
    return best


class _WorkerGroupError(Exception):
    def __init__(self, error: str, latest_ckpt: str | None):
        super().__init__(error)
        self.error = error
        self.latest_ckpt = latest_ckpt
