"""Compute ops of the port: attention on hand-written CUDA kernels, and
its sequence-parallel routes (ring and Ulysses) over a mesh axis."""

from ray_tpu_torch.ops.attention import (
    causal_attention,
    flash_eligible,
    make_sharded_causal_attention,
    resolved_flash_config,
    ring_attention,
    ulysses_attention,
)

__all__ = ["causal_attention", "flash_eligible", "resolved_flash_config",
           "ring_attention", "ulysses_attention",
           "make_sharded_causal_attention"]
