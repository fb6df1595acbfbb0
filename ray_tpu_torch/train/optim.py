"""AdamW with optax's semantics, updating in place.

Counterpart of ``optax.adamw`` as the JAX package uses it
(``optax.adamw(3e-4, weight_decay=0.1, mu_dtype=bf16)`` on the bench):
``chain(scale_by_adam, add_decayed_weights, scale_by_learning_rate)``.
``torch.optim.AdamW`` differs in three ways that matter for parity: it
cannot keep the first moment in bf16, it folds the decay into the
parameter before the Adam step, and it scales the decay by the learning
rate at another point. So, per parameter ``p`` with gradient ``g``:

    mu    = (1 - b1) * g + b1 * mu       # b1 * mu in mu's type (b1 too), sum in f32
    nu    = (1 - b2) * g² + b2 * nu      # float32
    count = count + 1
    u     = (mu / (1 - b1**count)) / (sqrt(nu / (1 - b2**count)) + eps)
    u     = u + weight_decay * p         # every parameter: optax's mask is None
    p     = p + (-lr) * u
    mu    stored in mu_dtype (rounded after the update used it in f32)

The bias corrections are computed in float32, as optax computes them.
Parameters, ``mu`` and ``nu`` are updated in place: the port's
counterpart of the JAX step's buffer donation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class AdamWState:
    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


class AdamW:
    def __init__(self, lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float, mu_dtype: torch.dtype | None):
        self.lr = lr
        self.b1 = b1
        self.b2 = b2
        self.eps = eps
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype

    def init(self, params) -> AdamWState:
        """Zero moments for ``params`` (a module or a list of tensors)."""
        params = _as_list(params)
        return AdamWState(
            count=0,
            mu=[torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                for p in params],
            nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params) -> None:
        """One AdamW step: updates ``params`` and ``state`` in place."""
        params = _as_list(params)
        b1, b2 = self.b1, self.b2
        state.count += 1
        # 1 - decay**count in float32, as optax computes it.
        bc1 = float(np.float32(1) - np.float32(b1) ** np.int32(state.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.int32(state.count))
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            if g is None:
                g = torch.zeros_like(p)
            m32 = g * (1 - b1)
            m32 += mu * _round_to(b1, mu.dtype)
            nu.mul_(b2).add_(g.square().mul_(1 - b2))
            u = (m32 / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
            u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-self.lr)
            mu.copy_(m32)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4,
          mu_dtype: torch.dtype | None = None) -> AdamW:
    """optax.adamw's defaults and semantics; see the module docstring."""
    return AdamW(lr, b1, b2, eps, weight_decay, mu_dtype)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    norms = [torch.linalg.vector_norm(t.float()) for t in tensors
             if t is not None]
    return torch.linalg.vector_norm(torch.stack(norms))


def _round_to(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: JAX casts a Python scalar to the type
    of the array it multiplies, so optax's ``b1 * mu`` with a bf16 ``mu``
    uses b1 = 0.8984375, not 0.9."""
    return torch.tensor(x, dtype=dtype).item()


def _as_list(params) -> list[torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    return list(params)
