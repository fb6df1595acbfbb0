"""Worker group: the gang of training actors.

Analog of the reference's WorkerGroup + BackendExecutor
(python/ray/train/_internal/worker_group.py:102,
backend_executor.py:68,135,451): N actors created inside one placement
group (STRICT_PACK = the gang), each running the user loop in a
background thread while its actor loop stays responsive for result
polling — the same split as the reference's _TrainSession thread.

A loop that captures a CUDA graph in that thread keeps working while
the actor's main thread answers polls: the port's train step captures
in ``"thread_local"`` mode, and results travel as the Python values
the loop reported.
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Callable

import ray_tpu_torch
from ray_tpu_torch.core.placement_group import (
    PlacementGroupSchedulingStrategy,
)


@ray_tpu_torch.remote
class TrainWorker:
    """One rank of the training gang."""

    def __init__(self, rank: int, world_size: int, env_vars: dict):
        import os
        os.environ.update(env_vars)
        self.rank = rank
        self.world_size = world_size
        self._thread: threading.Thread | None = None
        self._done = threading.Event()
        self._error: str | None = None
        self._session = None
        self._device = None
        self._store = None      # the rendezvous store rank 0 holds

    def get_coordinator(self) -> str:
        """A rendezvous address on THIS worker's host, so a gang
        spanning node daemons on different hosts forms one world
        (reference: TorchConfig picks the master addr from worker 0's
        node, torch/config.py:66): the interface that routes toward the
        head (``RAY_TPU_HEAD_IP``, which a node daemon sets for its
        workers), else loopback; the port of the rendezvous store this
        worker (rank 0) starts and holds. The store is multi-tenant, so
        ``setup_distributed``'s env:// rendezvous in this process serves
        from it: no other socket can take the port between its choice and
        the group's start. A port picked free and closed again was taken
        in that gap under load (EADDRINUSE), where the JAX package
        rendezvouses only gangs of more than one."""
        import os

        from torch.distributed import TCPStore

        from ray_tpu_torch.util.net import routable_ip
        head = os.environ.get("RAY_TPU_HEAD_IP")
        host = routable_ip(head) if head else "127.0.0.1"
        self._store = TCPStore(host, 0, self.world_size, is_master=True,
                               wait_for_workers=False, multi_tenant=True)
        return f"{host}:{self._store.port}"

    def gpu_ids(self) -> list:
        """The cards the runtime gave this rank."""
        return ray_tpu_torch.get_gpu_ids()

    def node_gpu_ids(self) -> tuple:
        """(this rank's node id, the cards the runtime gave it)."""
        import os
        return os.environ.get("RAY_TPU_NODE_ID", ""), self.gpu_ids()

    def setup_distributed(self, coordinator: str, device: str = "cpu",
                          gang_cards: dict[str, list] | None = None,
                          timeout_s: float | None = None) -> bool:
        """Join the gang's default process group through
        ``parallel.initialize``: NCCL with one card a rank for
        ``device="cuda"``, gloo for ``"cpu"``. Rendezvous through
        torchrun's environment, set from rank 0's address (the
        reference's _setup_torch_process_group, torch/config.py:115;
        the JAX package's jax.distributed).

        ``gang_cards`` (on the card) maps each node id of the gang to
        the ids of the gang's cards there: the rank widens its
        ``CUDA_VISIBLE_DEVICES`` to its own node's (a card of another
        node is never this worker's) before CUDA starts in this
        process, and ``LOCAL_RANK`` is the index of its own first card
        among them, so the rank's device ``cuda:LOCAL_RANK`` is the
        card the scheduler gave it.
        ``timeout_s`` (``train.torch.TorchConfig``) is the group's
        timeout."""
        import datetime
        import os

        import torch

        from ray_tpu_torch.parallel import initialize
        addr, port = coordinator.rsplit(":", 1)
        local = self.rank
        if device == "cuda":
            if torch.cuda.is_initialized():
                raise RuntimeError(
                    "CUDA started in this train worker before the "
                    "gang's process group; its cards can no longer be "
                    "set")
            own = [str(i) for i in self.gpu_ids()]
            cards = [str(i) for i in (gang_cards or {}).get(
                os.environ.get("RAY_TPU_NODE_ID", ""), own)]
            os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(cards)
            local = cards.index(own[0])
        os.environ.update(MASTER_ADDR=addr, MASTER_PORT=port,
                          RANK=str(self.rank),
                          WORLD_SIZE=str(self.world_size),
                          LOCAL_RANK=str(local))
        kwargs = {} if timeout_s is None else {
            "timeout": datetime.timedelta(seconds=timeout_s)}
        self._device = initialize(device, **kwargs)
        return True

    def start_loop(self, fn_and_config: tuple, context_kwargs: dict) -> bool:
        from ray_tpu_torch.train.session import (
            TrainContext, init_session,
        )
        fn, loop_config = fn_and_config
        context_kwargs = dict(context_kwargs)
        # Trainer datasets arrive as the FULL per-name shard lists
        # (identical args to every worker); each worker keeps only
        # its rank's DataIterator.
        shards_all = context_kwargs.pop("dataset_shards_all", None)
        shards = ({name: lst[self.rank]
                   for name, lst in shards_all.items()}
                  if shards_all else {})
        ctx = TrainContext(world_rank=self.rank,
                           world_size=self.world_size,
                           local_rank=self.rank,
                           loop_config=loop_config or {},
                           dataset_shards=shards,
                           **context_kwargs)
        self._session = init_session(ctx)

        def run():
            try:
                if self._device is not None and \
                        self._device.type == "cuda":
                    # The current card is per thread: the loop's
                    # thread runs on the rank's card, as the thread
                    # that joined the group does (collectives that
                    # stage tensors on the current card need it).
                    import torch
                    torch.cuda.set_device(self._device)
                if _takes_config(fn):
                    fn(loop_config or {})
                else:
                    fn()
            except BaseException:  # noqa: BLE001
                self._error = traceback.format_exc()
            finally:
                self._done.set()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"train_loop_rank{self.rank}")
        self._thread.start()
        return True

    def poll(self, max_results: int = 16) -> dict:
        """Drain queued results; report completion/errors."""
        out = []
        if self._session is not None:
            while len(out) < max_results:
                try:
                    r = self._session.results.get_nowait()
                except Exception:  # queue.Empty
                    break
                out.append({"metrics": r.metrics,
                            "checkpoint_dir": r.checkpoint_dir,
                            "rank": r.rank, "index": r.index})
        return {"results": out,
                "done": self._done.is_set(),
                "error": self._error}

    def ping(self) -> str:
        return "ok"


def _takes_config(fn: Callable) -> bool:
    import inspect
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return len(sig.parameters) >= 1


class WorkerGroup:
    def __init__(self, num_workers: int,
                 resources_per_worker: dict[str, float],
                 placement_strategy: str = "STRICT_PACK",
                 env_vars: dict | None = None):
        self.num_workers = num_workers
        bundles = [dict(resources_per_worker) for _ in range(num_workers)]
        self.pg = ray_tpu_torch.placement_group(bundles,
                                          strategy=placement_strategy)
        self.pg.ready(timeout=120)
        strategy = PlacementGroupSchedulingStrategy(self.pg)
        self.workers = [
            TrainWorker.options(
                num_cpus=resources_per_worker.get("CPU", 1),
                num_gpus=resources_per_worker.get("GPU", 0) or None,
                resources={k: v for k, v in resources_per_worker.items()
                           if k not in ("CPU", "GPU")},
                scheduling_strategy=strategy,
            ).remote(rank, num_workers, env_vars or {})
            for rank in range(num_workers)
        ]

    def barrier(self, timeout: float = 120.0) -> None:
        ray_tpu_torch.get([w.ping.remote() for w in self.workers],
                    timeout=timeout)

    def coordinator(self, timeout: float = 60.0) -> str:
        """Rendezvous address chosen by rank 0 from its own host."""
        return ray_tpu_torch.get(
            self.workers[0].get_coordinator.remote(), timeout=timeout)

    def run(self, method: str, *args, timeout: float | None = None,
            **kwargs) -> list:
        refs = [getattr(w, method).remote(*args, **kwargs)
                for w in self.workers]
        return ray_tpu_torch.get(refs, timeout=timeout)

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001
                pass
        try:
            ray_tpu_torch.remove_placement_group(self.pg)
        except Exception:  # noqa: BLE001
            pass
