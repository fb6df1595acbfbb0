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

Two expert-parallel layers, as in the JAX package:

- :func:`moe_ffn`, the counterpart of the JAX ``moe_ffn`` under
  ``shard_map``: each ``ep`` rank routes its own tokens and the queues
  travel to their experts' ranks by ``all_to_all``;
- :func:`switch_ffn`, the counterpart of the JAX ``SwitchFFN`` that the
  MoE transformer runs under GSPMD: routing is over the GLOBAL tokens of
  the batch (the capacity from their count, a token's queue position its
  place among them), and the ``ep`` ranks of one data shard, which hold
  the same tokens, each run their own experts on them and sum the
  outputs. Off a mesh it is :func:`moe_ffn` on one rank; the two share
  the dispatch and combine (:func:`_dispatch`, :func:`_combine`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ray_tpu_torch.collective.device import (
    _all_gather,
    all_to_all,
    allreduce,
    copy_to,
    reduce_from,
)
from ray_tpu_torch.parallel.mesh import AXIS_SP, DATA_AXES


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
    ``expert[t]``; ``position[t]``, its place in its expert's queue among
    these tokens; ``kept[t]``, whether its place among the batch's tokens
    is below the capacity; ``gate[t]``, the chosen expert's probability, 0
    when dropped; and ``aux``, the load-balancing loss."""
    expert: torch.Tensor
    position: torch.Tensor
    kept: torch.Tensor
    gate: torch.Tensor
    aux: torch.Tensor

    def slots(self, first: int, count: int, size: int) -> torch.Tensor:
        """Each token's row in the flat ``[count * size]`` queues of
        experts ``[first, first + count)``, ``size`` rows each, or
        ``count * size`` (the dump row) for a token dropped or bound for
        another expert."""
        mine = self.kept & (self.expert >= first) & (self.expert
                                                     < first + count)
        return torch.where(mine, (self.expert - first) * size
                           + self.position, count * size)


def top1_route(router_logits: torch.Tensor, num_experts: int,
               capacity: int, mesh=None, rows: int = 1) -> Route:
    """:func:`top1_dispatch` in index form: the same argmax (the first
    maximum), queue positions (a cumulative count in token order), drops,
    gate and aux loss, with no ``[T, E, C]`` tensor and no data-dependent
    shape.

    On ``mesh`` the logits are this data rank's ``rows`` rows of the
    batch, and routing is over the batch's tokens: ``capacity`` is the
    batch's, a token is kept while its place among the batch's tokens of
    its expert (in the order ``shard_batch`` deals them) is below it, and
    ``aux`` is the batch's loss, its probability mean all-reduced over
    the data ranks differentiably."""
    probs = torch.softmax(router_logits, dim=-1)
    expert = probs.argmax(-1)
    onehot = F.one_hot(expert, num_experts)
    position = _queue_positions(onehot, expert)
    if mesh is None:
        place = position
        share = onehot.to(probs.dtype).mean(0)
        mean_prob = probs.mean(0)
    else:
        offsets, counts, n = _global_offsets(onehot, rows, mesh)
        place = position + offsets.gather(1, expert[:, None])[:, 0]
        share = counts.to(probs.dtype) / n
        mean_prob = allreduce(probs.sum(0), DATA_AXES, mesh=mesh) / n
    kept = place < capacity
    gate = probs.gather(1, expert[:, None])[:, 0] * kept
    aux = num_experts * torch.sum(share * mean_prob)
    return Route(expert, position, kept, gate, aux)


def _queue_positions(onehot: torch.Tensor, expert: torch.Tensor
                     ) -> torch.Tensor:
    """Each token's place in its expert's queue among the tokens of
    ``onehot [T, E]``, in token order."""
    # The running count of each expert's tokens, read at each token's own
    # expert. It is scanned along the rows of the transposed [E, T] count,
    # which the card scans in parallel; down the E columns of [T, E] the
    # scan ran E wide (6 ms a layer at T = 32768 on an H100).
    running = torch.cumsum(onehot.t().contiguous(), dim=1)
    return running.gather(0, expert[None])[0] - 1


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
    slot = route.slots(0, num_experts, capacity)
    queues = _dispatch(x, slot, num_experts * capacity, dt).view(
        ep, e_local, capacity, d)
    if ep > 1:
        # [ep_dst, e_local, C, D] -> [ep_src, e_local, C, D]: each local
        # expert takes the queues of every source rank.
        queues = all_to_all(queues, group, 0, 0)
    expert_in = queues.transpose(0, 1).reshape(e_local, ep * capacity, d)
    out = expert_mlp(expert_in, w_up.to(dt), w_down.to(dt))
    out = out.view(e_local, ep, capacity, d).transpose(0, 1)
    if ep > 1:
        out = all_to_all(out.contiguous(), group, 0, 0)
    return _combine(out.reshape(num_experts * capacity, d), slot,
                    route.gate, dt), route.aux


def _dispatch(tokens: torch.Tensor, slot: torch.Tensor, n: int,
              dt: torch.dtype) -> torch.Tensor:
    """``[n, D]`` queue rows in ``dt``: each token's row at its ``slot``;
    the tokens whose slot is ``n`` (dropped, or another rank's) go to a
    dump row that is cut off, so the experts never see them."""
    rows = tokens.new_zeros((n + 1, tokens.shape[1]), dtype=dt)
    return rows.index_put((slot,), tokens.to(dt))[:-1]


def _combine(out: torch.Tensor, slot: torch.Tensor, gate: torch.Tensor,
             dt: torch.dtype, group=None) -> torch.Tensor:
    """Each token's output: its ``slot``'s row of the experts' ``out [n,
    D]`` (zeros for slot ``n``), summed over ``group`` when given, times
    its gate, rounded once to ``dt``."""
    # The product of the rounded gate and the row is exact in float32 and
    # rounded once, as the einsum's single term is. index_select's
    # backward adds each token's gradient into its own row; the zero row
    # takes the dropped tokens', and no kept row is shared.
    picked = torch.cat([out, out.new_zeros((1, out.shape[1]))]
                       ).index_select(0, slot)
    if group is not None:
        picked = reduce_from(picked, group)
    return (picked.float() * gate.to(dt).float()[:, None]).to(dt)


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


def _global_offsets(onehot: torch.Tensor, b: int, mesh) -> tuple:
    """Per local token, per expert, what to add to the token's place among
    this rank's tokens to make it its place among the batch's: the count
    of the batch's tokens before its row block in the global order
    (``[B, T]`` flattened, rows over ``dp``/``fsdp`` and the sequence over
    ``sp`` as ``shard_batch`` splits them) less this rank's own before it.
    Returns ``(offsets [T_local, E], counts [E], tokens)``, ``counts``
    the global count of each expert."""
    e = onehot.shape[1]
    rows = onehot.view(b, -1, e).sum(1)                      # [b, E]
    group = mesh.group(DATA_AXES)
    n, sp = mesh.axis_size(DATA_AXES), mesh.shape.get(AXIS_SP, 1)
    every = _all_gather(rows[None], group).view(n // sp, sp, b, e)
    # Global order: data shard, then row, then sequence block.
    order = every.transpose(1, 2).reshape(-1, e)
    before = torch.cumsum(order, dim=0) - order
    me = mesh.axis_index(DATA_AXES)
    d, j = divmod(me, sp)
    mine = before.view(n // sp, b, sp, e)[d, :, j] \
        - (torch.cumsum(rows, dim=0) - rows)                # [b, E]
    return (mine.repeat_interleave(onehot.shape[0] // b, dim=0),
            order.sum(0), n * onehot.shape[0])


def switch_ffn(x: torch.Tensor, router_w: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor, capacity_factor: float = 2.0,
               dtype: torch.dtype | None = None, mesh=None, experts=None):
    """The MoE transformer's switch FFN (the JAX ``SwitchFFN``) on this
    rank's ``x [B, T, D]``: ``(y [B, T, D], aux)``.

    Off a mesh (``mesh`` None) it is :func:`moe_ffn` on one rank. On a
    mesh the routing is over the global tokens (:func:`top1_route` with
    its ``mesh``): the
    capacity is ``capacity_factor`` times the batch's token count over E,
    and a token's queue position is its place among the batch's tokens
    routed to its expert, so the drops are the JAX model's; ``aux`` is the
    global load-balancing loss (its probability means all-reduced over
    the data ranks, differentiably). Each rank keeps its own tokens: the
    experts act on each token alone, so a token needs only its global
    position. ``experts`` (a ``parallel.sharding.Split`` over ``ep``
    and/or ``tp``) says how ``w_up [E_local, D, H_local]`` and ``w_down``
    are cut: this rank runs its experts (and its hidden columns) on every
    token of its data shard, and the outputs are summed over ``experts``'
    ranks before the gate, so the router's gradient is whole on each."""
    b, t, d = x.shape
    tokens = x.reshape(b * t, d)
    if mesh is None:
        y, aux = moe_ffn(tokens, router_w, w_up, w_down,
                         capacity_factor=capacity_factor, dtype=dtype)
        return y.view(b, t, d), aux
    dt = dtype or x.dtype
    num_experts = router_w.shape[1]
    capacity = capacity_for(b * t * mesh.axis_size(DATA_AXES), num_experts,
                            capacity_factor)
    route = top1_route(_router_logits(tokens, router_w), num_experts,
                       capacity, mesh, b)
    # This rank's experts [e0, e0 + e_local), each with a queue of this
    # rank's own kept tokens: no more than min(capacity, b * t).
    e_local = w_up.shape[0]
    e0 = 0 if experts is None or "ep" not in experts.axes else \
        experts.mesh.axis_index("ep") * e_local
    size = min(capacity, b * t)
    slot = route.slots(e0, e_local, size)
    if experts is not None:
        tokens = copy_to(tokens, experts.group)
    out = expert_mlp(_dispatch(tokens, slot, e_local * size, dt).view(
        e_local, size, d), w_up.to(dt), w_down.to(dt))
    y = _combine(out.reshape(e_local * size, d), slot, route.gate, dt,
                 None if experts is None else experts.group)
    return y.view(b, t, d), route.aux
