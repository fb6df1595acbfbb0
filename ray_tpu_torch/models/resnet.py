"""ResNet in PyTorch: the counterpart of ``ray_tpu/models/resnet.py``.

The batch keeps the JAX package's layout, ``{"image": [B, H, W, 3]
float32, "label": [B] int32}``. The model casts the images to the compute
type and permutes them to an NCHW view of the same NHWC memory, which is
PyTorch's ``channels_last`` format, so cuDNN runs NHWC tensor-core
convolutions on the card, as XLA does on the TPU. Convolutions are cuDNN
calls (``F.conv2d``): the JAX package leaves them to XLA, outside any
Pallas kernel.

The numerics follow flax, which differs from PyTorch's own layers in
ways that do not show in the output's shape:

- ``padding="SAME"`` pads as ``lax.padtype_to_pads``: the total padding
  is split with the smaller half first, so the 7x7/2 stem pads (2, 3) on
  224 and the 3x3/2 convolutions pad (0, 1) on even sizes.
  ``F.conv2d(padding=3)`` would give the same output size with every
  window one pixel off. Uneven padding is done with ``F.pad`` and the
  convolution then runs unpadded; ``nn.max_pool(padding="SAME")`` pads
  with -inf the same way.
- BatchNorm (``momentum=0.9``, ``epsilon=1e-5``) takes its batch
  statistics in float32 with flax's fast variance, ``max(0, E[x²] −
  E[x]²)``, which is the biased variance, and the running variance takes
  that: ``ra_var = 0.9 * ra_var + 0.1 * var``. ``nn.BatchNorm2d`` keeps
  the unbiased one, so it cannot hold these statistics. The
  normalisation ``(x − mean) * (scale * rsqrt(var + eps)) + bias`` runs
  in float32 and is cast to the compute type.
- In training the model is functional: ``forward(image, train=True)``
  returns the logits and the new running statistics and writes no
  buffer, so a forward that a recompute or a second call reruns changes
  nothing. The train step writes the statistics
  (``train.make_train_step(has_extra=True)``), as the JAX step carries
  ``batch_stats`` in ``TrainState.extra``.
- On a ``dp``/``fsdp`` mesh (``ResNet(config, mesh=mesh)``) the batch
  statistics are those of the GLOBAL batch, as under the JAX step, where
  ``jit`` reduces across the sharded batch axis: each BatchNorm sums
  ``x`` and ``x²`` over its rows, allreduces the sums over the batch
  ranks (differentiably: the backward allreduces their gradients) and
  divides by the global count, so the running statistics are equal on
  every rank too.
- On a ``tp`` mesh the rule table cuts every convolution's output
  channels over ``tp``, as the JAX table does (``conv.*kernel``), and
  keeps BatchNorm and the classifier replicated. Each convolution
  computes this rank's channels from the whole input; BatchNorm
  normalises them with this rank's slice of its replicated scale and
  bias, taken through ``collective.device.copy_to`` so that their
  gradients are summed over ``tp``, and gathers its new running
  statistics over ``tp``, so that they are whole on every rank; the
  residual adds the blocks locally; before the next convolution the
  channels are gathered (:func:`gather_channels`, in ``channels_last``
  memory), and the backward sums each rank's share of the input
  gradient over ``tp`` (a reduce-scatter).
  The global pooling runs on this rank's channels, which are gathered
  (``gather_from``: the classifier's gradient is equal on every rank)
  for the replicated classifier. The ``sp`` ranks of a mesh are
  replicas, as in the JAX model, which never reads ``sp``: the batch is
  cut over ``dp`` and ``fsdp`` only.
- The residual branch is projected where its shape differs from the
  block's output, so stage 0's first block projects at stride 1.
- The global mean over H and W takes a float32 sum and rounds to the
  compute type (``jnp.mean`` of a bf16 array); the classifier and the
  loss run in float32.

Parameters are float32 and named after the flax tree: ``conv_init``,
``bn_init``, ``stage{i}_block{j}.{conv1,bn1,...,conv_proj,bn_proj}`` and
``classifier``; the running statistics are the buffers ``<bn>.mean`` and
``<bn>.var``. Convolution weights are OIHW, the transpose of flax's HWIO
kernel, and dense weights ``[out, in]`` (:meth:`ResNet.load_jax_params`
swaps both).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.collective import device as coll
from ray_tpu_torch.collective.device import allreduce
from ray_tpu_torch.core.accelerator import resolve_device

BN_MOMENTUM = 0.9
BN_EPS = 1e-5
# The standard deviation of a standard normal truncated to [-2, 2]: flax's
# truncated-normal initializers divide by it.
_TRUNC_STD = 0.87962566103423978


@dataclass(frozen=True)
class ResNet50Config:
    num_classes: int = 1000
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    dtype: torch.dtype = torch.bfloat16       # compute dtype
    param_dtype: torch.dtype = torch.float32

    @staticmethod
    def resnet18(**kw) -> "ResNet50Config":
        return ResNet50Config(stage_sizes=(2, 2, 2, 2), **kw)

    @staticmethod
    def tiny(**kw) -> "ResNet50Config":
        kw.setdefault("num_classes", 10)
        kw.setdefault("stage_sizes", (1, 1))
        kw.setdefault("width", 16)
        return ResNet50Config(**kw)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of ``padding="SAME"`` along one axis, as
    ``lax.padtype_to_pads``: the output has ceil(size / stride) positions
    and the smaller half of the padding goes first."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def lecun_normal_(w: torch.Tensor, fan_in: int, gen) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    std = fan_in ** -0.5 / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                              generator=gen)


class Conv(nn.Module):
    """flax ``nn.Conv(c_out, (k, k), strides=(s, s), padding="SAME")`` on
    NCHW input: weight ``[c_out, c_in, k, k]`` in ``param_dtype``,
    lecun-normal, cast to the compute type (and to ``channels_last``)
    with its input, as flax's ``dtype=`` does."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 dtype: torch.dtype, param_dtype: torch.dtype, device, gen,
                 bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(torch.empty(
            c_out, c_in, kernel, kernel, dtype=param_dtype, device=device))
        lecun_normal_(self.weight, c_in * kernel * kernel, gen)
        self.bias = (nn.Parameter(torch.zeros(c_out, dtype=param_dtype,
                                              device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s, dt = self.kernel, self.stride, self.dtype
        (top, bottom), (left, right) = (same_pads(n, k, s)
                                        for n in x.shape[2:])
        x = x.to(dt)
        if top == bottom and left == right:
            pad = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            pad = 0
        w = self.weight.to(dt, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x, w, b, s, pad)


def max_pool_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), (s, s), padding="SAME")`` on NCHW: -inf
    padding split as :func:`same_pads` splits it."""
    (top, bottom), (left, right) = (same_pads(n, kernel, stride)
                                    for n in x.shape[2:])
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


class _GatherChannels(torch.autograd.Function):
    """Every rank's channels of NCHW ``x`` in ``channels_last`` memory,
    concatenated in rank order; backward, this rank's channels of the
    gradient summed over the ranks (a reduce-scatter). Each rank's block
    goes over the wire as its own contiguous NHWC memory, and the result
    and the gradient are ``channels_last`` again, so that cuDNN runs the
    same layout as off a mesh."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, c, h, w = x.shape
        nhwc = x.permute(0, 2, 3, 1).contiguous()   # a view when channels_last
        parts = coll._all_gather(nhwc.unsqueeze(0), group, 0)
        r = parts.shape[0]
        return (parts.permute(1, 2, 3, 0, 4).reshape(n, h, w, r * c)
                .permute(0, 3, 1, 2))

    @staticmethod
    def backward(ctx, g):
        n, c, h, w = g.shape
        r = dist.get_world_size(ctx.group)
        parts = g.permute(0, 2, 3, 1).reshape(n, h, w, r, c // r) \
            .permute(3, 0, 1, 2, 4)
        mine = coll._reduce_scatter(parts, ctx.group, 0)[0]
        return mine.permute(0, 3, 1, 2), None


def gather_channels(x: torch.Tensor, tp) -> torch.Tensor:
    """Every ``tp`` rank's channels of NCHW ``x``, whole, for a
    convolution whose output channels ``tp`` cuts (``x`` itself without
    ``tp``): each rank's convolution gives only its share of the input's
    gradient, which the backward sums over ``tp``."""
    if tp is None:
        return x
    return _GatherChannels.apply(x, tp.group)


def replicated_block(p: torch.Tensor, tp, n: int) -> torch.Tensor:
    """This ``tp`` rank's ``n`` entries of the replicated parameter ``p``
    (all of ``p`` without ``tp``), through ``copy_to``: each rank's
    gradient covers its entries only, and the sum over ``tp`` makes it
    whole and equal on every rank, as the step expects of a replicated
    parameter."""
    if tp is None:
        return p
    return coll.copy_to(p, tp.group).narrow(0, tp.index * n, n)


class _Norms:
    """What the BatchNorm layers of one forward share: the mode, the
    running statistics they read (``{buffer name: tensor}``), in training
    the new ones they return, the process group of the batch ranks
    whose rows the statistics span (None: this rank's rows) and the
    ``tp`` Split that cuts the channels (None: every channel here)."""

    def __init__(self, train: bool, stats: Mapping[str, torch.Tensor],
                 group=None, tp=None):
        self.train = train
        self.stats = stats
        self.group = group
        self.tp = tp
        self.new_stats: dict[str, torch.Tensor] = {}

    def moments(self, xf: torch.Tensor):
        """Per-channel mean and E[x²] of the rows ``[N, C]``: this rank's,
        or the global batch's over ``group``."""
        if self.group is None:
            return xf.mean(0), (xf * xf).mean(0)
        sums = allreduce(torch.stack([xf.sum(0), (xf * xf).sum(0)]),
                         self.group)
        return sums / (xf.shape[0] * dist.get_world_size(self.group))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype)`` over
    N, H and W of NCHW input; see the module docstring. ``path`` is the
    layer's name in its model, the prefix of its buffers' names."""

    def __init__(self, n: int, dtype: torch.dtype, param_dtype: torch.dtype,
                 device, scale_init: float = 1.0):
        super().__init__()
        self.dtype = dtype
        self.path = ""
        self.scale = nn.Parameter(torch.full((n,), scale_init,
                                             dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(n, dtype=param_dtype,
                                             device=device))
        self.register_buffer("mean", torch.zeros(n, dtype=param_dtype,
                                                 device=device))
        self.register_buffer("var", torch.ones(n, dtype=param_dtype,
                                               device=device))

    def forward(self, x: torch.Tensor, norms: _Norms) -> torch.Tensor:
        # Rows of channels, [N*H*W, C]: a view of channels_last memory, so
        # the per-channel statistics and the normalisation broadcast along
        # the contiguous last axis. Under tp, C is this rank's channels.
        n, c, h, w = x.shape
        tp = norms.tp
        ra_mean, ra_var = (norms.stats[f"{self.path}.{k}"]
                           for k in ("mean", "var"))
        if tp is not None:
            ra_mean, ra_var = (ra.narrow(0, tp.index * c, c)
                               for ra in (ra_mean, ra_var))
        xf = x.permute(0, 2, 3, 1).reshape(-1, c).float()
        if norms.train:
            mean, mean_sq = norms.moments(xf)
            var = (mean_sq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                for k, ra, batch in (("mean", ra_mean, mean),
                                     ("var", ra_var, var)):
                    new = BN_MOMENTUM * ra + (1 - BN_MOMENTUM) * batch
                    norms.new_stats[f"{self.path}.{k}"] = (
                        new if tp is None
                        else coll._all_gather(new, tp.group))
        else:
            mean, var = ra_mean, ra_var
        mul = torch.rsqrt(var + BN_EPS) * replicated_block(self.scale, tp, c)
        y = (xf - mean) * mul + replicated_block(self.bias, tp, c)
        return y.to(self.dtype).view(n, h, w, c).permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    """1x1 → 3x3 (stride) → 1x1 (x4), BatchNorm after each; the residual is
    projected (1x1 at the stride, BatchNorm) where its shape differs."""

    def __init__(self, c_in: int, features: int, stride: int,
                 config: ResNet50Config, device, gen):
        super().__init__()
        c = config
        dt, pd = c.dtype, c.param_dtype

        def conv(i, o, k, s):
            return Conv(i, o, k, s, dt, pd, device, gen)

        def norm(n, scale_init=1.0):
            return BatchNorm(n, dt, pd, device, scale_init)

        self.conv1 = conv(c_in, features, 1, 1)
        self.bn1 = norm(features)
        self.conv2 = conv(features, features, 3, stride)
        self.bn2 = norm(features)
        self.conv3 = conv(features, 4 * features, 1, 1)
        self.bn3 = norm(4 * features, scale_init=0.0)
        self.conv_proj = self.bn_proj = None
        if c_in != 4 * features or stride != 1:
            self.conv_proj = conv(c_in, 4 * features, 1, stride)
            self.bn_proj = norm(4 * features)

    def forward(self, x: torch.Tensor, norms: _Norms) -> torch.Tensor:
        """``x`` and the result: this ``tp`` rank's channels (all of them
        without ``tp``)."""
        tp = norms.tp
        whole = gather_channels(x, tp)
        y = F.relu(self.bn1(self.conv1(whole), norms))
        y = F.relu(self.bn2(self.conv2(gather_channels(y, tp)), norms))
        y = self.bn3(self.conv3(gather_channels(y, tp)), norms)
        residual = x
        if self.conv_proj is not None:
            residual = self.bn_proj(self.conv_proj(whole), norms)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """``forward(image [B, H, W, 3]) -> logits [B, num_classes]`` float32;
    with ``train=True``, ``(logits, new running statistics)``.

    ``device`` defaults to the card (``core.accelerator.default_device``,
    which raises without one), or to ``mesh.device``; pass
    ``device="cpu"`` to run on the CPU. Weights are random from ``seed``
    on a ``torch.Generator`` of that device. On ``mesh`` the batch
    statistics span the ``dp`` and ``fsdp`` ranks; placed over ``tp``
    the channels are cut (module docstring); ``sp`` ranks are replicas."""

    tensor_parallel = True      # place_params may split it over tp
    tp = None                   # the Split of a tensor-parallel placement

    def __init__(self, config: ResNet50Config = ResNet50Config(), *,
                 device=None, seed: int = 0, mesh=None):
        super().__init__()
        self.config = c = config
        self.mesh = mesh
        self._bn_group = None
        if mesh is not None and mesh.axis_size(("dp", "fsdp")) > 1:
            self._bn_group = mesh.group(("dp", "fsdp"))
        device = resolve_device(device, mesh)
        gen = torch.Generator(device=device).manual_seed(seed)
        dt, pd = c.dtype, c.param_dtype
        self.conv_init = Conv(3, c.width, 7, 2, dt, pd, device, gen)
        self.bn_init = BatchNorm(c.width, dt, pd, device)
        self.block_names = []
        c_in = c.width
        for i, n_blocks in enumerate(c.stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                name = f"stage{i}_block{j}"
                features = c.width * 2 ** i
                self.add_module(name, Bottleneck(c_in, features, stride, c,
                                                 device, gen))
                self.block_names.append(name)
                c_in = 4 * features
        self.classifier = nn.Linear(c_in, c.num_classes, dtype=pd,
                                    device=device)
        lecun_normal_(self.classifier.weight, c_in, gen)
        with torch.no_grad():
            self.classifier.bias.zero_()
        for name, m in self.named_modules():
            if isinstance(m, BatchNorm):
                m.path = name

    def batch_stats(self) -> dict[str, torch.Tensor]:
        """The running statistics, ``{"<bn>.mean" | "<bn>.var": buffer}``:
        the train step's ``extra`` (``init_train_state(..., extra=...)``),
        which the step updates in place."""
        return dict(self.named_buffers())

    def forward(self, image: torch.Tensor, train: bool = False,
                batch_stats: Mapping[str, torch.Tensor] | None = None):
        """``batch_stats`` (default: the module's buffers) are the running
        statistics that eval mode normalises with and that training
        averages into the ones it returns."""
        c = self.config
        norms = _Norms(train, self.batch_stats() if batch_stats is None
                       else batch_stats, self._bn_group, self.tp)
        # [B, H, W, 3] memory seen as NCHW: the channels_last format.
        x = image.to(c.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn_init(self.conv_init(x), norms))
        x = max_pool_same(x, 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, norms)
        x = x.mean((2, 3), dtype=torch.float32).to(c.dtype)
        if self.tp is not None:
            x = coll.gather_from(x, self.tp.group, 1).contiguous()
        logits = F.linear(x.float(), self.classifier.weight,
                          self.classifier.bias)
        return (logits, norms.new_stats) if train else logits

    @torch.no_grad()
    def load_jax_params(self, params: dict, batch_stats: dict | None = None
                        ) -> None:
        """Copy the JAX package's flax ``params`` and ``batch_stats`` (nested
        dicts of numpy arrays, as ``ResNet.init_variables`` gives them after
        ``np.asarray``) into this module: conv kernels HWIO → OIHW, dense
        kernels ``[in, out]`` → ``[out, in]``."""
        def put(dst: torch.Tensor, src, perm=None):
            src = torch.from_numpy(np.array(src, dtype=np.float32))
            if perm is not None:
                src = src.permute(*perm)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"shape {tuple(src.shape)} does not fit "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)

        def node(tree: dict, name: str) -> dict:
            for part in name.split("."):
                tree = tree[part]
            return tree

        for name, m in self.named_modules():
            if isinstance(m, Conv):
                put(m.weight, node(params, name)["kernel"], (3, 2, 0, 1))
            elif isinstance(m, BatchNorm):
                put(m.scale, node(params, name)["scale"])
                put(m.bias, node(params, name)["bias"])
                if batch_stats is not None:
                    put(m.mean, node(batch_stats, name)["mean"])
                    put(m.var, node(batch_stats, name)["var"])
            elif isinstance(m, nn.Linear):
                put(m.weight, node(params, name)["kernel"], (1, 0))
                put(m.bias, node(params, name)["bias"])


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """``-mean(sum(one_hot(labels) * log_softmax(logits)))`` in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def resnet_loss_fn():
    """``(model, batch_stats, batch) -> (loss, new_batch_stats)``; batch =
    {image, label}. The JAX counterpart takes ``(params, batch_stats,
    batch)`` with the flax module bound outside; here the ``ResNet``
    module holds its parameters and is the first argument."""

    def loss_fn(model: ResNet, batch_stats, batch):
        logits, new_stats = model(batch["image"], train=True,
                                  batch_stats=batch_stats)
        return softmax_cross_entropy(logits, batch["label"]), new_stats

    return loss_fn
