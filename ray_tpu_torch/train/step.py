"""Train-step machinery: the counterpart of ``ray_tpu/train/step.py``.

The JAX step is one compiled program (forward, backward, optimizer
update) with the parameter and optimizer buffers donated. PyTorch runs
eagerly, so here a step is forward, ``backward()`` and an in-place
optimizer update; the in-place update is the counterpart of donation,
and a Python loop over a leading ``[K, ...]`` batch stack is the
counterpart of the ``lax.scan`` of :func:`make_multi_train_step`.
Metrics stay on the device until the caller reads them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ray_tpu_torch.train.optim import AdamW, AdamWState, global_norm


@dataclass
class TrainState:
    step: int
    params: torch.nn.Module
    opt_state: AdamWState

    def num_params(self) -> int:
        return sum(p.numel() for p in self.params.parameters())


def init_train_state(params: torch.nn.Module, optimizer: AdamW) -> TrainState:
    """Wrap a module and fresh optimizer state for it."""
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def make_train_step(loss_fn: Callable, optimizer: AdamW,
                    grad_norm: bool = True) -> Callable:
    """``step(state, batch) -> (state, metrics)``: forward, backward and
    the optimizer update, in place on ``state``.

    loss_fn: (module, batch) -> scalar loss.
    ``metrics`` holds ``loss`` and, unless ``grad_norm=False``, the
    global gradient norm (a read of every gradient)."""

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params = list(state.params.parameters())
        for p in params:
            p.grad = None
        loss = loss_fn(state.params, batch)
        loss.backward()
        grads = [p.grad for p in params]
        metrics = {"loss": loss.detach()}
        if grad_norm:
            metrics["grad_norm"] = global_norm(grads)
        optimizer.update(grads, state.opt_state, params)
        for p in params:
            p.grad = None
        state.step += 1
        return state, metrics
    return step


def make_multi_train_step(loss_fn: Callable, optimizer: AdamW,
                          grad_norm: bool = True) -> Callable:
    """``multi(state, batches) -> (state, metrics_of_last_step)``: K
    optimizer steps over a batch stack whose leaves carry a leading
    ``[K, ...]`` axis, the same math as K calls of the single step."""
    body = make_train_step(loss_fn, optimizer, grad_norm)

    def multi(state: TrainState, batches) -> tuple[TrainState, dict]:
        metrics = None
        for i in range(_leading_dim(batches)):
            state, metrics = body(state, _index(batches, i))
        return state, metrics

    return multi


def _leading_dim(tree: Any) -> int:
    if isinstance(tree, dict):
        return _leading_dim(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _leading_dim(tree[0])
    return tree.shape[0]


def _index(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index(v, i) for v in tree)
    return tree[i]
