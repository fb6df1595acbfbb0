"""Compute ops of the port: attention on hand-written CUDA kernels."""

from ray_tpu_torch.ops.attention import causal_attention, flash_eligible

__all__ = ["causal_attention", "flash_eligible"]
