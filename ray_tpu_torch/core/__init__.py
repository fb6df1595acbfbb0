"""Device detection for the PyTorch/CUDA port."""

from ray_tpu_torch.core.accelerator import (
    default_device,
    detect_gpus,
    resolve_device,
)

__all__ = ["default_device", "detect_gpus", "resolve_device"]
