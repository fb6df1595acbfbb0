"""Switch (top-1) mixture of experts: the counterpart of ``ray_tpu/ops/moe.py``.

The JAX package routes tokens with dense one-hot ``dispatch`` and
``combine`` tensors ``[T, E, C]`` and three einsums
(:func:`top1_dispatch`, :func:`dense_switch_ffn_reference`), which keep
shapes static for the TPU's matrix unit. Those tensors are quadratic in
tokens: at GPT-2's bench batch (32 x 1024 tokens, 8 experts, capacity
8192) one of them holds 2.1 G entries. The port keeps that form as the
spec and the plain version, and routes on the card by index
(:func:`top1_route`, :func:`moe_ffn`):

- dispatch is a scatter of token rows into a static ``[E, C, D]``
  buffer, with one extra dump row that takes the dropped tokens;
- combine is a gather of each token's row times its gate.

It is the same arithmetic: each ``(e, c)`` slot holds one token or none,
so the einsum over the one-hot has one nonzero term, which rounds as
the gather does: a token's output is ``gate · out[e, c]`` rounded once
to the compute type, and a dropped token's is 0. Every shape is static
(capacity comes from the token count), and nothing reads a value back
to the host, so the routing can be captured in a CUDA graph. The
expert products are batched matrix products, as the JAX package leaves
them to XLA; no Pallas kernel sits on this path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ray_tpu_torch.collective.device import all_to_all


def top1_dispatch(router_logits: torch.Tensor, num_experts: int,
                  capacity: int):
    """Switch-routing dispatch and combine tensors, as the JAX function
    builds them.

    router_logits: [T, E]. Returns (dispatch [T, E, C] 0/1 float,
    combine [T, E, C] float, aux_loss scalar). Tokens beyond an expert's
    capacity, in token order, are dropped; aux_loss is the
    load-balancing loss (Switch Transformer eq. 4)."""
    probs = torch.softmax(router_logits, dim=-1)                  # [T, E]
    expert_mask = F.one_hot(probs.argmax(-1), num_experts).to(probs.dtype)
    # Position of each token within its expert's queue.
    position = torch.cumsum(expert_mask, dim=0) * expert_mask - 1.0
    in_capacity = (position < capacity) & (expert_mask > 0)
    pos_clipped = position.clamp(0, capacity - 1).long()
    dispatch = (F.one_hot(pos_clipped, capacity).to(probs.dtype)
                * in_capacity[..., None])                         # [T, E, C]
    gate = (probs * expert_mask).amax(-1)                         # [T]
    combine = dispatch * gate[:, None, None]
    aux = num_experts * torch.sum(expert_mask.mean(0) * probs.mean(0))
    return dispatch, combine, aux


class Route(NamedTuple):
    """Top-1 routing in index form, per token ``t`` of ``[T]``:
    ``expert[t]``; ``slot[t]``, the flat ``[E * C]`` queue slot, or
    ``E * C`` (the dump row) when the token is dropped; ``gate[t]``, the
    chosen expert's probability, 0 when dropped; and ``aux``, the
    load-balancing loss."""
    expert: torch.Tensor
    slot: torch.Tensor
    gate: torch.Tensor
    aux: torch.Tensor


def top1_route(router_logits: torch.Tensor, num_experts: int,
               capacity: int) -> Route:
    """:func:`top1_dispatch` in index form: the same argmax (the first
    maximum), queue positions (a cumulative count in token order), drops,
    gate and aux loss, with no ``[T, E, C]`` tensor and no data-dependent
    shape."""
    probs = torch.softmax(router_logits, dim=-1)
    expert = probs.argmax(-1)
    onehot = F.one_hot(expert, num_experts)
    # The running count of each expert's tokens, read at each token's own
    # expert. It is scanned along the rows of the transposed [E, T] count,
    # which the card scans in parallel; down the E columns of [T, E] the
    # scan ran E wide (6 ms a layer at T = 32768 on an H100).
    running = torch.cumsum(onehot.t().contiguous(), dim=1)
    position = running.gather(0, expert[None])[0] - 1
    kept = position < capacity
    slot = torch.where(kept, expert * capacity + position,
                       num_experts * capacity)
    gate = probs.gather(1, expert[:, None])[:, 0] * kept
    aux = num_experts * torch.sum(onehot.to(probs.dtype).mean(0)
                                  * probs.mean(0))
    return Route(expert, slot, gate, aux)


def capacity_for(num_tokens: int, num_experts: int,
                 capacity_factor: float) -> int:
    """Slots per expert: ``max(1, int(cf · T / E))`` over all ``T`` tokens
    of the flattened batch (``models/moe.py:83-84``)."""
    return max(1, int(capacity_factor * num_tokens / num_experts))


def expert_mlp(expert_in: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """``[E, C, D] -> [E, C, D]``: each expert's two-layer MLP with the
    tanh GELU (``jax.nn.gelu``'s default), empty slots included."""
    h = F.gelu(torch.bmm(expert_in, w_up), approximate="tanh")
    return torch.bmm(h, w_down)


def _router_logits(x: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """float32 router logits, as the JAX model computes them."""
    return x.float() @ router_w.float()


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, group=None, capacity_factor: float = 2.0,
            dtype: torch.dtype | None = None):
    """Switch FFN routed by index, its experts split over the ranks of
    ``group`` (the counterpart of the JAX version's ``ep`` axis; None is
    one rank); ``(y [T, D], aux)``.

    x: [T, D], this rank's own tokens; router_w: [D, E], replicated;
    w_up: [E_local, D, H] and w_down: [E_local, H, D], this rank's experts,
    ``E = E_local · ep``. Routing is local, as in JAX: the capacity comes
    from this rank's T, queue positions count its own tokens, and the
    choice spans all E experts. The ``[ep, E_local, C, D]`` queues go to
    their experts' ranks by ``all_to_all`` and come back by the inverse
    exchange; both are differentiable. ``dtype`` is the compute type that
    ``SwitchFFN`` casts tokens, weights and the combine weights to (its
    ``cfg.dtype``); None computes in ``x``'s type, as the JAX function
    does. The router logits are float32 either way."""
    ep = 1 if group is None else dist.get_world_size(group)
    dt = dtype or x.dtype
    t, d = x.shape
    e_local = w_up.shape[0]
    num_experts = e_local * ep
    capacity = capacity_for(t, num_experts, capacity_factor)
    route = top1_route(_router_logits(x, router_w), num_experts, capacity)
    # Dispatch: each kept token's row into its slot, dropped ones into the
    # dump row, which the experts never see.
    rows = x.new_zeros((num_experts * capacity + 1, d), dtype=dt)
    rows = rows.index_put((route.slot,), x.to(dt))
    queues = rows[:-1].view(ep, e_local, capacity, d)
    if ep > 1:
        # [ep_dst, e_local, C, D] -> [ep_src, e_local, C, D]: each local
        # expert takes the queues of every source rank.
        queues = all_to_all(queues, group, 0, 0)
    expert_in = queues.transpose(0, 1).reshape(e_local, ep * capacity, d)
    out = expert_mlp(expert_in, w_up.to(dt), w_down.to(dt))
    out = out.view(e_local, ep, capacity, d).transpose(0, 1)
    if ep > 1:
        out = all_to_all(out.contiguous(), group, 0, 0)
    out = out.reshape(num_experts * capacity, d)
    # Combine: a dropped token gathers the zero dump row, and its gate is 0.
    # The product of the rounded gate and the row is exact in float32 and
    # rounded once, as the einsum's single term is. index_select's
    # backward adds each token's gradient into its own row; the dump row
    # takes the dropped tokens' zeros, and no kept row is shared.
    out = torch.cat([out, out.new_zeros((1, d))])
    picked = out.index_select(0, route.slot)
    y = (picked.float() * route.gate.to(dt).float()[:, None]).to(dt)
    return y, route.aux


def dense_switch_ffn_reference(x: torch.Tensor, router_w: torch.Tensor,
                               w_up_full: torch.Tensor,
                               w_down_full: torch.Tensor,
                               capacity_factor: float = 2.0,
                               dtype: torch.dtype | None = None):
    """The one-hot einsum form of :func:`moe_ffn`, as the JAX package
    computes it: the spec and the plain version. ``dtype`` as in
    :func:`moe_ffn` (dispatch and combine are cast to it before the
    einsums, as ``SwitchFFN`` does)."""
    dt = dtype or x.dtype
    num_experts = w_up_full.shape[0]
    capacity = capacity_for(x.shape[0], num_experts, capacity_factor)
    dispatch, combine, aux = top1_dispatch(_router_logits(x, router_w),
                                           num_experts, capacity)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(dt), x.to(dt))
    out = expert_mlp(expert_in, w_up_full.to(dt), w_down_full.to(dt))
    y = torch.einsum("tec,ecd->td", combine.to(dt), out)
    return y, aux
