"""ray_tpu_torch.train — the train step (captured as a CUDA graph on the
card), its optimizers, the input pipeline, sharded checkpoints, and
``TorchTrainer``, which runs a loop on a gang of runtime actors
(counterpart of ``ray_tpu.train`` and its ``JaxTrainer``). The framework
modules keep the JAX package's names: ``train.torch`` (``TorchConfig``,
``prepare_model``, ``prepare_data_loader``, ``get_device``),
``train.huggingface`` (``TransformersTrainer``) and ``train.sklearn``
(``SklearnTrainer``).

The names below load their module on first use, as ``ray_tpu_torch``'s
subpackages do: a runtime worker that only runs a trial or a loop's
session imports no torch until its code does."""

import importlib

_HOME = {
    "restore_pytree": "checkpoint",
    "restore_train_state": "checkpoint",
    "save_pytree": "checkpoint",
    "save_train_state": "checkpoint",
    "SGD": "optim",
    "AdamW": "optim",
    "AdamWState": "optim",
    "SGDState": "optim",
    "adamw": "optim",
    "chain": "optim",
    "clip_by_global_norm": "optim",
    "global_norm": "optim",
    "sgd": "optim",
    "RMSProp": "optim",
    "RMSPropState": "optim",
    "rmsprop": "optim",
    "TRAIN_DATASET_KEY": "config",
    "BackendConfig": "config",
    "CheckpointConfig": "config",
    "DataConfig": "config",
    "FailureConfig": "config",
    "RunConfig": "config",
    "ScalingConfig": "config",
    "SyncConfig": "config",
    "DevicePrefetcher": "prefetch",
    "prefetch_to_device": "prefetch",
    "Checkpoint": "session",
    "get_checkpoint": "session",
    "get_context": "session",
    "get_dataset_shard": "session",
    "report": "session",
    "TrainState": "step",
    "batch_spec": "step",
    "buffers_donated": "step",
    "compile_count": "step",
    "disable_capture": "step",
    "init_train_state": "step",
    "make_multi_train_step": "step",
    "make_step": "step",
    "make_train_step": "step",
    "shard_batch": "step",
    "Result": "trainer",
    "TorchTrainer": "trainer",
}
_SUBMODULES = ("checkpoint", "config", "huggingface", "optim", "prefetch",
               "session", "sklearn", "step", "torch", "trainer",
               "worker_group")

__all__ = [
    "TrainState", "init_train_state", "make_train_step", "batch_spec",
    "shard_batch",
    "make_multi_train_step", "make_step", "compile_count",
    "buffers_donated",
    "disable_capture", "AdamW", "AdamWState", "adamw", "SGD",
    "SGDState", "sgd", "RMSProp", "RMSPropState", "rmsprop", "chain",
    "clip_by_global_norm", "global_norm",
    "DevicePrefetcher",
    "prefetch_to_device", "save_pytree", "restore_pytree",
    "save_train_state", "restore_train_state",
    "ScalingConfig", "RunConfig", "FailureConfig", "CheckpointConfig",
    "BackendConfig", "DataConfig", "SyncConfig", "TRAIN_DATASET_KEY",
    "Checkpoint", "get_checkpoint", "get_context", "get_dataset_shard",
    "report", "TorchTrainer", "Result",
]


def __getattr__(name: str):
    if name in _HOME:
        value = getattr(importlib.import_module(
            f"{__name__}.{_HOME[name]}"), name)
    elif name in _SUBMODULES:
        value = importlib.import_module(f"{__name__}.{name}")
    else:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_HOME) | set(_SUBMODULES))
