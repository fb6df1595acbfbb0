"""Attention ops of the port.

Counterpart of ``ray_tpu/ops/attention.py``. ``causal_attention`` runs
the hand-written CUDA flash kernels for CUDA tensors
(``ops/cuda/flash_attention.py``) and their plain PyTorch versions for
CPU tensors. There is no library fallback: a CUDA input the kernels do
not take raises. Shapes follow the JAX package: ``[batch, seq, heads,
head_dim]``.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops.cuda.flash_attention import (
    flash_attention,
    flash_attention_available,
    flash_attention_shapes_ok,
)


def flash_eligible(t: int, d: int) -> bool:
    """Would ``causal_attention`` run [*, t, *, d] self-attention on the
    CUDA kernels here? Benchmarks use this to refuse measuring anything
    else."""
    return flash_attention_available() and flash_attention_shapes_ok(t, d)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float | None = None) -> torch.Tensor:
    """Causal attention [B, T, H, D] -> [B, T, H, D]."""
    return flash_attention(q, k, v, causal=True, scale=scale)
