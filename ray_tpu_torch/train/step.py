"""Train-step machinery: the counterpart of ``ray_tpu/train/step.py``.

The JAX step is one compiled program (forward, backward, optimizer
update) with the parameter and optimizer buffers donated. The port's
counterpart of ``jax.jit`` is a CUDA graph: on the card, a step is
captured once as one graph and replayed on every later call.

- The first call for a new input signature (the batch's shapes, dtypes
  and devices, and the addresses of the state's tensors) runs the step
  eagerly on a side stream as warm-up; that is a real optimizer step.
  Then it captures the step, which runs nothing. Each later call copies
  the batch into the graph's static input buffers and replays it, so N
  calls make N updates. A new signature captures again, as ``jit``
  retraces; :func:`compile_count` counts the captures.
- The captured body reads no value from the host: the optimizer keeps
  its count on the device (``train.optim``), gradients are set to None
  before the capture, and nothing in the step synchronises. The flash
  kernels' launch counters record the launches a capture holds and add
  them at each replay (``flash_attention.record_launches``).
- On the CPU, and under :func:`disable_capture` (the counterpart of
  ``jax.disable_jit``), the step runs eagerly.

Parameters, optimizer state and ``extra`` are updated in place, which
is the counterpart of donation; :func:`buffers_donated` proves it. A
Python loop over a leading ``[K, ...]`` batch stack, replaying the
single-step graph K times, is the counterpart of the ``lax.scan`` of
:func:`make_multi_train_step`. Metrics stay on the device until the
caller reads them; a replay returns copies, never the graph's own
output buffers, which the next replay overwrites.

``has_extra`` carries model state that is not trained, such as
BatchNorm's running statistics, through the step: the loss returns the
new state beside the loss, and the step writes it into
``TrainState.extra`` in place. Only the step writes it, once per step,
however often the forward runs.

On a mesh (``init_train_state(..., mesh=mesh)``, which places the
parameters by ``parallel.sharding.place_params``) the step makes
explicit the reductions that XLA's sharding propagation inserts into the
JAX step:

- the gradient of every replicated parameter is averaged over every rank
  of the mesh (``dp × fsdp × sp``, and ``ep``, whose ranks see the same
  tokens): the ``sp`` ranks saw other tokens of the same weights, so
  leaving them out would be wrong without a sign of it. FSDP2
  reduce-scatters the gradients of the parameters it shards;
- ``loss`` is the mean over every rank's tokens: each rank's loss is its
  share of that mean (the models' loss functions sum the token count
  over the ranks), and the metric is their mean;
- ``grad_norm`` is the norm of the whole gradient, the shards of FSDP2's
  parameters included (``collective.device.global_norm``).

On the card these collectives are captured into the step's CUDA graph
with the rest. The one rule that runs a step eagerly on the card: a
state whose parameters FSDP2 shards. Its hooks all-gather and free
parameters and wait on streams of their own between the modules, which a
capture does not hold; such a step runs eagerly, and
:func:`compile_count` stays None to say so.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.collective import device as coll
from ray_tpu_torch.ops.cuda import flash_attention as fa
from ray_tpu_torch.parallel.mesh import AXIS_FSDP, AXIS_SP
from ray_tpu_torch.parallel.sharding import is_sharded, local, place_params
from ray_tpu_torch.train.optim import global_norm

# > 0 inside disable_capture(): steps run eagerly on the card too.
_capture_disabled = 0


@dataclass
class TrainState:
    step: int
    params: torch.nn.Module
    opt_state: Any
    extra: dict[str, torch.Tensor] | None = None   # e.g. BatchNorm statistics
    mesh: Any = None

    def num_params(self) -> int:
        return sum(p.numel() for p in self.params.parameters())


def init_train_state(params: torch.nn.Module, optimizer, mesh=None,
                     extra: dict[str, torch.Tensor] | None = None,
                     patterns=None) -> TrainState:
    """Wrap a module, fresh optimizer state for it (``adamw`` or ``sgd``)
    and the state ``extra`` that a ``has_extra`` step updates (e.g.
    ``ResNet.batch_stats()``, the module's own buffers).

    With ``mesh`` the parameters are first placed by the rule table
    (``parallel.sharding.place_params`` with ``patterns``), so the optimizer state of a parameter FSDP2 shards
    is sharded with it: the ZeRO counterpart that JAX gets by propagating
    the parameters' shardings into the moments."""
    if mesh is not None:
        place_params(params, mesh, patterns)
    return TrainState(step=0, params=params, opt_state=optimizer.init(params),
                      extra=extra, mesh=mesh)


@contextlib.contextmanager
def disable_capture():
    """Run every train step eagerly inside the block, on the card too: the
    counterpart of ``jax.disable_jit``."""
    global _capture_disabled
    _capture_disabled += 1
    try:
        yield
    finally:
        _capture_disabled -= 1


def _step_body(loss_fn: Callable, optimizer, has_extra: bool,
               grad_norm: bool) -> Callable:
    """``body(state, batch) -> metrics``: forward, backward and the
    optimizer update, in place on ``state``; what a capture records."""

    def body(state: TrainState, batch) -> dict:
        params = list(state.params.parameters())
        for p in params:
            p.grad = None
        if has_extra:
            loss, new_extra = loss_fn(state.params, state.extra, batch)
        else:
            loss = loss_fn(state.params, batch)
        loss.backward()
        grads = [p.grad for p in params]
        metrics = {"loss": loss.detach()}
        if state.mesh is not None:
            metrics["loss"] = _reduce(grads, metrics["loss"], state.mesh)
        if grad_norm:
            metrics["grad_norm"] = _grad_norm(grads, state.mesh)
        optimizer.update(grads, state.opt_state, params)
        for p in params:
            p.grad = None
        if has_extra:
            with torch.no_grad():
                for name, value in new_extra.items():
                    state.extra[name].copy_(value)
        return metrics
    return body


# Elements in one all-reduce of the step's gradients (128 MiB of
# float32): few collectives a step, and a bounded flat copy for each.
BUCKET_ELEMS = 1 << 25


def _buckets(tensors: list) -> list[list]:
    """``tensors`` in runs of one dtype, each run of at most
    :data:`BUCKET_ELEMS` elements unless one tensor alone is larger."""
    runs: list[list] = []
    size = 0
    for t in tensors:
        if (not runs or runs[-1][0].dtype != t.dtype
                or size + t.numel() > BUCKET_ELEMS):
            runs.append([])
            size = 0
        runs[-1].append(t)
        size += t.numel()
    return runs


def _reduce(grads: list, loss: torch.Tensor, mesh) -> torch.Tensor:
    """Average, over every rank of ``mesh``, the gradients FSDP2 does not
    reduce (those of replicated parameters), in place, and return the
    mean of the ranks' losses. The gradients and the loss go in flat
    buckets (:func:`_buckets`), one all-reduce each, after the whole
    backward."""
    n = mesh.size
    loss = loss.reshape(1).clone()
    plain = [g for g in grads if g is not None and not is_sharded(g)]
    # A stable sort: one run of tensors for each dtype, the loss last in
    # its own dtype's.
    tensors = sorted(plain + [loss], key=lambda t: str(t.dtype))
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=dist.group.WORLD)
        if n > 1:
            flat /= n
        torch._foreach_copy_(bucket, [
            part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in bucket]), bucket)])
    return loss.reshape(())


def _grad_norm(grads: list, mesh) -> torch.Tensor:
    """The global gradient norm: local squares of whole (replicated)
    gradients, and those of FSDP2's shards summed over ``fsdp``."""
    if mesh is None:
        return global_norm(grads)
    whole = [g for g in grads if g is not None and not is_sharded(g)]
    shards = [local(g) for g in grads if g is not None and is_sharded(g)]
    sq = global_norm(whole).square() if whole else 0.0
    if shards:
        sq = sq + coll.global_norm(shards, AXIS_FSDP, mesh).square()
    return torch.sqrt(torch.as_tensor(sq, device=mesh.device))


class _Graph:
    """One capture of the step body: its static batch, output metrics and
    the flash-kernel launches it holds."""

    def __init__(self, body: Callable, batch, device: torch.device):
        self.batch = _tree_map(
            lambda x: torch.empty_like(x, device=device), batch)
        self.graph = torch.cuda.CUDAGraph()
        self.metrics: dict = {}
        self.launches: dict[str, int] = {}
        self._body = body
        self._device = device

    def warm_up_and_capture(self, state: TrainState, batch) -> dict:
        """The warm-up step (eager, on a side stream, a real update), then
        the capture (which runs nothing). Returns the warm-up's metrics."""
        current = torch.cuda.current_stream(self._device)
        _tree_copy(self.batch, batch)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            metrics = self._body(state, self.batch)
        current.wait_stream(side)
        for value in metrics.values():
            value.record_stream(current)
        # thread_local: other threads (the prefetcher's copies) may go on
        # calling CUDA while this one captures.
        with fa.record_launches() as launches, torch.cuda.graph(
                self.graph, capture_error_mode="thread_local"):
            self.metrics = self._body(state, self.batch)
        self.launches = launches
        return metrics

    def replay(self, batch) -> dict:
        _tree_copy(self.batch, batch)
        self.graph.replay()
        fa.count_replay(self.launches)
        return {k: v.clone() for k, v in self.metrics.items()}


class _Step:
    """A train step: captured and replayed on the card, eager on the CPU
    and under :func:`disable_capture`. ``multi`` takes a ``[K, ...]``
    batch stack and makes K steps."""

    def __init__(self, body: Callable, multi: bool):
        self._body = body
        self._multi = multi
        self._graphs: dict[Any, _Graph] = {}
        # The addresses of the state's tensors when the step first ran
        # (buffers_donated), and the number of captures, None until the
        # step has run captured (compile_count).
        self.addresses: tuple[int, ...] | None = None
        self.captures: int | None = None

    def __call__(self, state: TrainState, batch) -> tuple[TrainState, dict]:
        if not self._multi:
            return state, self._one(state, batch)
        metrics = None
        for i in range(_leading_dim(batch)):
            metrics = self._one(state, _index(batch, i))
        return state, metrics

    def _one(self, state: TrainState, batch) -> dict:
        tensors = _state_tensors(state)
        addresses = tuple(t.data_ptr() for t in tensors)
        if self.addresses is None:
            self.addresses = addresses
        device = tensors[0].device
        if (_capture_disabled or device.type != "cuda"
                or any(is_sharded(p) for p in state.params.parameters())):
            # FSDP2-sharded parameters: eager by rule (module docstring).
            metrics = self._body(state, batch)
        else:
            metrics = self._captured(state, batch, addresses, device)
        state.step += 1
        return metrics

    def _captured(self, state: TrainState, batch, addresses, device) -> dict:
        # A graph writes the tensors it was captured on: a state whose
        # tensors moved is a new signature, as a new batch layout is.
        key = (_signature(batch), addresses)
        graph = self._graphs.get(key)
        if graph is not None:
            return graph.replay(batch)
        graph = _Graph(self._body, batch, device)
        metrics = graph.warm_up_and_capture(state, batch)
        self._graphs[key] = graph
        self.captures = len(self._graphs)
        return metrics


def batch_spec(mesh, *, seq_sharded: bool = False,
               batch_dim: int = 0) -> tuple:
    """The mesh axes of each dimension of a ``[..., batch, seq, ...]``
    array (as the JAX package's ``PartitionSpec``): batch over ``dp`` and
    ``fsdp``, the sequence over ``sp`` when ``seq_sharded``;
    ``batch_dim`` leading axes (a multi-step stack) stay whole."""
    batch_axes = tuple(a for a in ("dp", "fsdp")
                       if mesh.shape.get(a, 1) > 1)
    first = batch_axes if batch_axes else None
    lead = (None,) * batch_dim
    if seq_sharded and mesh.shape.get(AXIS_SP, 1) > 1:
        return (*lead, first, AXIS_SP)
    return (*lead, first)


def shard_batch(batch, mesh, seq_sharded: bool = False,
                batch_dim: int = 0):
    """This rank's block of a global host batch (the same batch on every
    rank: numpy arrays or tensors), on ``mesh.device``: the batch
    dimension split over ``dp`` and ``fsdp``, the sequence over ``sp``
    when ``seq_sharded`` (for ring or Ulysses attention), as
    :func:`batch_spec` says. ``batch_dim`` marks how many leading axes
    precede the batch axis. ValueError when a split does not divide."""

    def put(x):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        spec = batch_spec(mesh, seq_sharded=seq_sharded
                          and x.dim() >= 2 + batch_dim, batch_dim=batch_dim)
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            n = mesh.axis_size(axes)
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} does "
                                 f"not split over {axes} ({n} ranks)")
            size = x.shape[dim] // n
            x = x.narrow(dim, mesh.axis_index(axes) * size, size)
        return x.contiguous().to(mesh.device)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return put(tree)

    return walk(batch)


def make_train_step(loss_fn: Callable, optimizer, has_extra: bool = False,
                    grad_norm: bool = True) -> Callable:
    """``step(state, batch) -> (state, metrics)``: forward, backward and
    the optimizer update, in place on ``state``, captured as one CUDA
    graph on the card (see the module docstring).

    loss_fn: (module, batch) -> scalar loss                 (has_extra=False)
             (module, extra, batch) -> (loss, new_extra)    (has_extra=True)
    With ``has_extra`` each tensor of ``new_extra`` is copied into the
    tensor of ``state.extra`` of the same name after the update.
    ``metrics`` holds ``loss`` and, unless ``grad_norm=False``, the
    global gradient norm (a read of every gradient)."""
    return _Step(_step_body(loss_fn, optimizer, has_extra, grad_norm),
                 multi=False)


def make_multi_train_step(loss_fn: Callable, optimizer,
                          has_extra: bool = False,
                          grad_norm: bool = True) -> Callable:
    """``multi(state, batches) -> (state, metrics_of_last_step)``: K
    optimizer steps over a batch stack whose leaves carry a leading
    ``[K, ...]`` axis, the same math as K calls of the single step; on
    the card, K replays of the single step's graph."""
    return _Step(_step_body(loss_fn, optimizer, has_extra, grad_norm),
                 multi=True)


def compile_count(step_fn: Callable) -> int | None:
    """Number of CUDA-graph captures of a step from
    :func:`make_train_step` or :func:`make_multi_train_step`; ``None``
    for a step that has only run eagerly (on the CPU, or under
    :func:`disable_capture`), as the JAX version returns ``None`` when it
    cannot tell.

    The contract after warm-up is a STABLE count: one capture for the
    input signature, and a new one only when the batch's shapes, dtypes
    or devices, or the state's tensors, change; a count that grows with
    steps means every call pays a warm-up and a capture."""
    return getattr(step_fn, "captures", None)


def buffers_donated(step_fn: Callable, state: TrainState) -> bool:
    """True when every parameter, optimizer-state tensor and ``extra``
    tensor of ``state`` lies at the address it had when ``step_fn`` first
    ran on it: the step, its captured graph included, updated the state
    in place, the port's counterpart of donation.

    The argument is the step and the state, not the state alone as in
    the JAX version: a jax array that a donating dispatch consumed is
    marked deleted, but a torch tensor that a step updated in place looks
    like one it never touched, and one that a step replaced looks like
    any other. So the proof compares the addresses the step recorded
    before its first update, which its graph writes, with the addresses
    of the state's tensors now."""
    recorded = getattr(step_fn, "addresses", None)
    if not recorded:
        return False
    return recorded == tuple(t.data_ptr() for t in _state_tensors(state))


def _state_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor a step updates: parameters (a shard's local part),
    optimizer state, extra."""
    return ([local(p) for p in state.params.parameters()]
            + list(_tensors(state.opt_state))
            + list((state.extra or {}).values()))


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _signature(tree: Any) -> Any:
    """What a capture depends on in a batch: the structure, and each
    tensor's shape, dtype and device (other leaves by value)."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return tuple((k, _signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_signature(v) for v in tree))
    return tree


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _tree_copy(dst: Any, src: Any) -> None:
    """Copy every tensor leaf of ``src`` into the same leaf of ``dst``."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src, non_blocking=True)
    elif isinstance(dst, dict):
        for k, v in dst.items():
            _tree_copy(v, src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _tree_copy(d, s)


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
