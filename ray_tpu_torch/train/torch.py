"""train.torch — torch-DDP helpers over the port's trainer: the
counterpart of ``ray_tpu/train/torch.py``.

Reference analog: ray.train.torch (TorchTrainer + TorchConfig,
python/ray/train/torch/config.py:36,66,115): the framework supplies
ranks and a rendezvous address, the process group is made on every
worker, and ``prepare_model``/``prepare_data_loader`` wrap the user's
model and loader for DDP. The port's ``train.TorchTrainer`` already
joins every gang, one worker too, into one process group (NCCL, one
card a rank, on the card; gloo under ``ScalingConfig(gpus_per_worker=0)``),
so the ``TorchTrainer`` here is that trainer with ``torch_config=``.

Differences from the JAX module, which runs torch on gloo alone because
its image has no CUDA:

- ``TorchConfig().backend`` is None, the device's backend: NCCL where the
  trainer's workers hold cards, gloo where they hold none. A backend that
  does not fit the device raises ValueError naming both (the JAX module
  refuses every backend but gloo).
- ``get_device()`` is the rank's card, ``cuda:LOCAL_RANK``, the card the
  scheduler gave it; ``cpu`` only in a gloo group. Outside a process
  group it is the default device, the card, and raises without one.
- ``prepare_model`` hands DDP the rank's card (``device_ids``) and raises,
  naming the device, when the model's parameters are not on it: it does
  not move the model, as the JAX one does not.
- ``enable_reproducibility`` also sets ``CUBLAS_WORKSPACE_CONFIG`` where
  it is unset, which deterministic algorithms need on the card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ray_tpu_torch.train.config import BackendConfig
from ray_tpu_torch.train.session import Checkpoint
from ray_tpu_torch.train.trainer import TorchTrainer as _Trainer

_DEVICE_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


@dataclass
class TorchConfig(BackendConfig):
    """(reference: ray.train.torch.TorchConfig) ``backend`` None is the
    device's: ``"nccl"`` on the card, ``"gloo"`` on the CPU. ``timeout_s``
    is the process group's timeout (``init_process_group(timeout=)``)."""

    backend: str | None = None
    timeout_s: int = 1800

    def __post_init__(self):
        if self.backend not in (None, *_DEVICE_BACKEND.values()):
            raise ValueError(
                f"TorchConfig.backend={self.backend!r}: the port's "
                f"process groups are nccl (the card) or gloo (the CPU)")

    def backend_for(self, device: str) -> str:
        """The backend of a gang on ``device`` ("cuda" or "cpu");
        ValueError, naming both, where ``backend`` does not fit it."""
        want = _DEVICE_BACKEND[device]
        if self.backend not in (None, want):
            raise ValueError(
                f"TorchConfig.backend={self.backend!r} does not fit the "
                f"trainer's device {device!r}, whose process group is "
                f"{want} (ScalingConfig.gpus_per_worker sets the device)")
        return want


class TorchTrainer(_Trainer):
    """The port's ``train.TorchTrainer`` with ``torch_config=``: every
    worker joins the gang's process group before the loop starts, a
    single worker too, with the config's timeout; user loops can call
    ``dist.*`` and ``prepare_model`` unconditionally."""

    def __init__(self, *args, torch_config=None, **kwargs):
        if torch_config is not None and not isinstance(torch_config,
                                                       TorchConfig):
            # duck-typed configs normalise here, so TorchConfig is the
            # one place the backend's constraint lives
            torch_config = TorchConfig(
                backend=getattr(torch_config, "backend", None),
                timeout_s=getattr(torch_config, "timeout_s", 1800))
        super().__init__(*args, **kwargs)
        self.torch_config = torch_config
        if torch_config is not None:
            torch_config.backend_for(self.scaling.device)
            # forwarded to the workers' process-group setup
            self._backend_setup_extra = {
                "timeout_s": torch_config.timeout_s}


def get_device():
    """(reference: train.torch.get_device) This rank's device: in an NCCL
    group its card, ``cuda:LOCAL_RANK``; in a gloo group the CPU; outside
    a group the default device (the card; RuntimeError without one)."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            return torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                           "0")))
        return torch.device("cpu")
    from ray_tpu_torch.core.accelerator import default_device
    return default_device()


def get_devices() -> list:
    """(reference: train.torch.get_devices)"""
    return [get_device()]


def prepare_model(model):
    """Wrap a torch model for the current world: DDP when world > 1, on
    the rank's card there (reference: train.torch.prepare_model). The
    model must already be on :func:`get_device`."""
    import torch.distributed as dist
    dev = get_device()
    held = sorted({str(p.device) for p in model.parameters()})
    if any(d != str(dev) for d in held):
        raise ValueError(
            f"prepare_model: the model's parameters are on {held}, not on "
            f"this rank's device {dev}; move it there first "
            f"(model.to(train.torch.get_device()))")
    if dist.is_initialized() and dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel
        return DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None)
    return model


class _EpochDataLoader:
    """Wraps a DDP DataLoader so each ``__iter__`` advances the
    DistributedSampler epoch — without set_epoch every epoch would
    replay the identical shuffle order (reference:
    prepare_data_loader's epoch plumbing)."""

    def __init__(self, loader, sampler):
        self._loader = loader
        self.sampler = sampler
        self._epoch = -1

    def __iter__(self):
        self._epoch += 1
        self.sampler.set_epoch(self._epoch)
        return iter(self._loader)

    def __len__(self):
        return len(self._loader)

    def __getattr__(self, name):
        return getattr(self._loader, name)


def prepare_data_loader(loader):
    """Re-build a DataLoader with a DistributedSampler sharding by
    rank (reference: train.torch.prepare_data_loader). The original
    loader's shuffle intent (RandomSampler vs sequential) is
    preserved; pin_memory / collate / workers carry over; iteration
    advances the sampler epoch so shuffles differ per epoch."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return loader
    from torch.utils.data import DataLoader, RandomSampler
    from torch.utils.data.distributed import DistributedSampler
    shuffle = isinstance(getattr(loader, "sampler", None),
                         RandomSampler)
    sampler = DistributedSampler(
        loader.dataset, num_replicas=dist.get_world_size(),
        rank=dist.get_rank(), shuffle=shuffle)
    new_loader = DataLoader(
        loader.dataset, batch_size=loader.batch_size,
        sampler=sampler, num_workers=loader.num_workers,
        collate_fn=loader.collate_fn, drop_last=loader.drop_last,
        pin_memory=loader.pin_memory)
    return _EpochDataLoader(new_loader, sampler)


def prepare_optimizer(optimizer):
    """(reference: train.torch.prepare_optimizer — wraps for AMP;
    identity here, as in the JAX module, which has no AMP scaler)."""
    return optimizer


def backward(tensor) -> None:
    """(reference: train.torch.backward — scales under AMP; plain
    backward here)."""
    tensor.backward()


def enable_reproducibility(seed: int = 0) -> None:
    """Seed torch/numpy/python and force deterministic algorithms
    (reference: train.torch.enable_reproducibility); on the card cuBLAS
    needs its workspace fixed for that (``CUBLAS_WORKSPACE_CONFIG``, set
    where unset)."""
    import random

    import numpy as np
    import torch
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.manual_seed(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.use_deterministic_algorithms(True, warn_only=True)
    os.environ.setdefault("PYTHONHASHSEED", str(seed))


class TorchCheckpoint(Checkpoint):
    """Model-state checkpoint (reference:
    ray.train.torch.TorchCheckpoint): ``from_model`` writes a
    state_dict into a directory and returns a TorchCheckpoint, so the
    reference idiom ``ckpt.get_model(model)`` works. The caller owns
    the directory (``report(checkpoint=...)`` persists a COPY into the
    trial dir — delete the local one after reporting in checkpoint-
    per-epoch loops, or pass a ``directory=`` you manage)."""

    FILE = "model_state.pt"

    @classmethod
    def from_model(cls, model, directory: str | None = None
                   ) -> "TorchCheckpoint":
        import tempfile

        import torch
        directory = directory or tempfile.mkdtemp(
            prefix="torch_ckpt_")
        os.makedirs(directory, exist_ok=True)
        state = model.state_dict() if hasattr(model, "state_dict") \
            else model
        torch.save(state, os.path.join(directory, cls.FILE))
        return cls(directory)

    def get_model(self, model):
        """Load the stored state_dict into ``model`` (returned)."""
        import torch
        state = torch.load(
            os.path.join(self.path, TorchCheckpoint.FILE),
            weights_only=True)
        model.load_state_dict(state)
        return model

