"""ray_tpu_torch.train — the train step (captured as a CUDA graph on the
card), its optimizers, the input pipeline and sharded checkpoints of the
port (counterpart of ``ray_tpu.train``'s step layer and checkpoints)."""

from ray_tpu_torch.train.checkpoint import (
    restore_pytree,
    restore_train_state,
    save_pytree,
    save_train_state,
)
from ray_tpu_torch.train.optim import (
    SGD,
    AdamW,
    AdamWState,
    SGDState,
    adamw,
    global_norm,
    sgd,
)
from ray_tpu_torch.train.prefetch import DevicePrefetcher, prefetch_to_device
from ray_tpu_torch.train.step import (
    TrainState,
    batch_spec,
    buffers_donated,
    compile_count,
    disable_capture,
    init_train_state,
    make_multi_train_step,
    make_train_step,
    shard_batch,
)

__all__ = [
    "TrainState", "init_train_state", "make_train_step", "batch_spec",
    "shard_batch",
    "make_multi_train_step", "compile_count", "buffers_donated",
    "disable_capture", "AdamW", "AdamWState", "adamw", "SGD",
    "SGDState", "sgd", "global_norm", "DevicePrefetcher",
    "prefetch_to_device", "save_pytree", "restore_pytree",
    "save_train_state", "restore_train_state",
]
