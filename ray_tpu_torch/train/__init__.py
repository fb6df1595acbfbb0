"""ray_tpu_torch.train — the train step (captured as a CUDA graph on the
card), its optimizers and the input pipeline of the port (counterpart of
``ray_tpu.train``'s step layer)."""

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
    "prefetch_to_device",
]
