"""Pipeline parallelism over the ``pp`` mesh axis: the counterpart of
``ray_tpu/parallel/pipeline.py``.

The JAX package runs the whole pipeline as one SPMD program inside
``shard_map``: every ``pp`` rank holds one stage's weights, microbatch
activations move to the right neighbour by ``ppermute``, and the GPipe
fill and drain is a ``lax.scan`` over ``num_microbatches + pp - 1``
steps. The port runs the same schedule as a Python loop on each rank,
the activations moving by ``collective.device.ppermute`` (differentiable:
its backward sends the gradients back to the left), so autograd through
the loop is the pipeline's backward.

A collective's backward must run on every rank, in the same order. XLA
runs the whole transposed scan on every device; autograd runs a node only
where its output reached the loss, which on rank 0 (whose received
activations are never read) and in the fill and drain differs from rank
to rank. So, as in the scan, every rank computes its stage at every step
and every step's output moves right; and every received activation is
tied to the result with a zero gradient (:class:`_Tie`), so that each
step's ``ppermute`` runs its backward once on every rank, the latest step
first.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ray_tpu_torch.collective import device as coll
from ray_tpu_torch.parallel.mesh import current_mesh


def spmd_pipeline(stage_fn: Callable, num_microbatches: int,
                  axis: str = "pp", mesh=None) -> Callable:
    """A pipelined apply, ``f(stage_params, x) -> y``, over the ``axis``
    ranks of ``mesh`` (the active mesh by default).

    - ``stage_fn(params_of_my_stage, activation) -> activation`` keeps the
      activation's shape (a pipeline of homogeneous stages).
    - ``stage_params``: this rank's stage, as :func:`shard_stages` gives
      it (each tensor with a leading stage dimension of 1, dropped before
      ``stage_fn`` sees it; any other leaf, a module say, passes as it
      is). ``x``: the whole batch, the same on every ``axis`` rank, split
      into ``num_microbatches`` along dim 0.
    - At step t rank 0 feeds microbatch t, the last rank finishes
      microbatch t - (pp - 1), and each rank's output moves to the right.
      The outputs are summed over ``axis`` from the last rank, so every
      rank returns ``y``; the sum's backward is the identity, so each
      rank's stage gets the gradient of a loss all ranks compute alike,
      and ``x``'s gradient lands on rank 0.

    As in the JAX scan, every rank computes its stage at every step, the
    fill and drain steps on inputs whose outputs are thrown away.
    """

    def pipelined(stage_params: Any, x: torch.Tensor) -> torch.Tensor:
        m = mesh if mesh is not None else current_mesh()
        pp, rank = m.axis_size(axis), m.axis_index(axis)
        params = _tree_map(
            lambda a: a[0] if isinstance(a, torch.Tensor) else a,
            stage_params)
        b = x.shape[0]
        micro = x.reshape(num_microbatches, b // num_microbatches,
                          *x.shape[1:])
        right = [(i, (i + 1) % pp) for i in range(pp)]
        incoming = torch.zeros_like(micro[0])
        received, outputs = [], []
        for t in range(num_microbatches + pp - 1):
            out = stage_fn(params, micro[min(t, num_microbatches - 1)]
                           if rank == 0 else incoming)
            if rank == pp - 1 and t >= pp - 1:
                outputs.append(out)
            incoming = coll.ppermute(out, axis, right, m)
            received.append(incoming)
        y = (torch.stack(outputs) if rank == pp - 1
             else torch.zeros_like(micro))
        y = coll.reduce_from(y, axis, m).reshape(x.shape)
        return _Tie.apply(y, *received)

    return pipelined


class _Tie(torch.autograd.Function):
    """``y`` itself; backward, ``y``'s gradient and zeros for ``others``,
    so that autograd runs the backward of whatever made them."""

    @staticmethod
    def forward(ctx, y, *others):
        ctx.others = [(o.shape, o.dtype, o.device) for o in others]
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=v)
                     for s, d, v in ctx.others))


def shard_stages(params_per_stage: Any, mesh=None, axis: str = "pp") -> Any:
    """This rank's stage of a ``[pp, ...]``-stacked tree of tensors: each
    tensor's block ``r:r+1`` along dim 0 on ``mesh.device``, ``r`` this
    rank's index along ``axis`` (the local view of the JAX version's
    ``P(axis)`` placement)."""
    m = mesh if mesh is not None else current_mesh()
    r = m.axis_index(axis)
    if any(a.shape[0] != m.shape[axis] for a in _leaves(params_per_stage)):
        raise ValueError(f"every leaf needs a leading dimension of "
                         f"{axis}={m.shape[axis]}")
    return _tree_map(lambda a: a[r:r + 1].detach().clone().to(m.device)
                     .requires_grad_(a.requires_grad), params_per_stage)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)
