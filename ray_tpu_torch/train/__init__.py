"""ray_tpu_torch.train — the train step, its optimizer and the input
pipeline of the port (counterpart of ``ray_tpu.train``'s step layer)."""

from ray_tpu_torch.train.optim import AdamW, AdamWState, adamw, global_norm
from ray_tpu_torch.train.prefetch import DevicePrefetcher, prefetch_to_device
from ray_tpu_torch.train.step import (
    TrainState,
    init_train_state,
    make_multi_train_step,
    make_train_step,
)

__all__ = [
    "TrainState", "init_train_state", "make_train_step",
    "make_multi_train_step", "AdamW", "AdamWState", "adamw", "global_norm",
    "DevicePrefetcher", "prefetch_to_device",
]
