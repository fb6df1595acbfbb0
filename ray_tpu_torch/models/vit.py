"""Vision Transformer in PyTorch: the counterpart of
``ray_tpu/models/vit.py``.

Patchify convolution → encoder blocks with bidirectional attention → the
CLS token's head. The numerics follow flax, as ``models/gpt2.py`` does:

- float32 parameters, bfloat16 compute: every dense layer casts its
  weight and input to the compute type (flax ``Dense(dtype=bf16)``);
  weights are ``nn.Linear``'s ``[out, in]``, the transpose of flax's
  kernel. q, k and v are three dense layers.
- LayerNorm takes float32 statistics with the fast variance and
  epsilon 1e-6 (``models.gpt2.LayerNorm``).
- the MLP's GELU is flax's ``nn.gelu``, the tanh approximation.
- attention is ``jax.nn.dot_product_attention`` with no mask and scale
  ``head_dim**-0.5``: here the port's flash kernels with ``causal=False``
  (``ops/cuda/flash_attention.flash_attention``) for CUDA tensors, their
  plain versions for CPU tensors. A CUDA input the kernels refuse
  raises; nothing falls back to a library attention.
- the head reads token 0 in float32 and returns float32 logits.

Images are ``[B, H, W, 3]`` float32, as in JAX; the patch convolution
reads them as ``channels_last`` NCHW (see ``models/resnet.py``).
``ViTConfig.remat`` runs each block under activation checkpointing with
the ``"nothing"`` policy, the counterpart of ``nn.remat`` with no policy.

``ViT(config, mesh=mesh)`` runs on a ``dp``/``fsdp`` mesh: each rank
holds its block of the batch, and attention needs nothing from the other
ranks. On a ``tp`` mesh it cuts what the JAX rule table cuts: only each
block's ``mlp_proj``, whose input rows (the MLP's hidden units) are split
over ``tp`` (``parallel.sharding``). Every rank computes ``fc`` whole,
takes its block of the hidden units after GELU through
``collective.device.copy_to`` (so that ``fc``'s gradient, which each
rank holds only for its block, is summed over ``tp``), runs ``mlp_proj``
on its rows, sums the partial products over ``tp`` (``reduce_from``) and
adds the bias once.

On a mesh with a real ``sp`` axis the sequence is split over the ``sp``
ranks, as the JAX model's ``("batch", "seq", None)`` constraint names it
(the JAX ``constrain`` drops an axis that does not divide T, so XLA
keeps T whole there; the split is this port's, with the same numbers).
T (197 for ViT-B/16) need not divide: each rank builds the embedded
sequence of its images (CLS, patches, ``pos_embed``), pads it with zero
rows at the end to ``sp`` blocks of ``ceil(T / sp)`` rows
(:func:`seq_blocks`) and keeps its own block, so only the last blocks
hold padding (ViT-B/16 on ``sp 4``: three blocks of 50 rows and one of
47 valid ones; the tiny config's 17 tokens on ``sp 8``: blocks of 3, the
last two empty). Attention is the bidirectional ring
(``ops.attention._bidir_ring_attention``), each hop against the valid
keys of its source block only; the padded rows are computed, row by row,
and never reach a valid row. The CLS token sits on ``sp`` rank 0, which
computes the head; its logits reach every ``sp`` rank through
:func:`cls_logits`, whose backward sums the ranks' logit gradients into
rank 0. So every rank computes the loss of its data shard, and the
ranks' parameter gradients, each holding its rows' share, sum over
``sp`` to ``sp`` times the shard's gradient, which the train step's mean
over the data axes (``dp × fsdp × sp``) turns into the gradient of the
mean loss. Padded rows get no gradient: no valid row depends on them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.core.accelerator import resolve_device
from ray_tpu_torch.models.gpt2 import LayerNorm, enter, leave, remat_call
from ray_tpu_torch.models.resnet import Conv, lecun_normal_, \
    softmax_cross_entropy
from ray_tpu_torch.ops.attention import _bidir_ring_attention
from ray_tpu_torch.ops.cuda.flash_attention import flash_attention


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16       # compute dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = False

    @staticmethod
    def base(**kw) -> "ViTConfig":
        return ViTConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "ViTConfig":
        kw.setdefault("image_size", 32)
        kw.setdefault("patch_size", 8)
        kw.setdefault("num_classes", 10)
        kw.setdefault("n_layer", 2)
        kw.setdefault("n_head", 4)
        kw.setdefault("n_embd", 64)
        return ViTConfig(**kw)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


def _attention(q, k, v):
    """Bidirectional attention on [B, T, H, D], as the reference's
    ``jax.nn.dot_product_attention(q, k, v)``."""
    return flash_attention(q, k, v, causal=False)


def seq_blocks(t: int, n: int) -> tuple[int, tuple[int, ...]]:
    """``(block, lengths)``: the rows of each of ``n`` sequence blocks,
    ``ceil(t / n)``, and the valid rows of each, the padding at the end
    (0 for a block wholly past ``t``)."""
    block = -(-t // n)
    return block, tuple(max(0, min(block, t - r * block)) for r in range(n))


class _FromFirstRank(torch.autograd.Function):
    """``x`` of rank 0 of ``group`` on every rank of it; the backward sums
    the ranks' gradients into rank 0 (0 on the others), the transpose of
    the broadcast."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone().contiguous()
        dist.broadcast(y, dist.get_global_rank(group, 0), group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        g = dy.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        if dist.get_rank(ctx.group) != 0:
            g = torch.zeros_like(g)
        return g, None


def cls_logits(logits: torch.Tensor, mesh) -> torch.Tensor:
    """The logits of the CLS token, which ``sp`` rank 0 computes, on every
    ``sp`` rank of ``mesh`` (each rank passes the head's output on its own
    first row, which only rank 0's is)."""
    return _FromFirstRank.apply(logits, mesh.group("sp"))


def _dense(n_in: int, n_out: int, config: ViTConfig, device, gen,
           init: str) -> nn.Linear:
    """A dense layer with a zero bias and flax's ``xavier_uniform`` or
    ``lecun_normal`` kernel."""
    lin = nn.Linear(n_in, n_out, dtype=config.param_dtype, device=device)
    with torch.no_grad():
        if init == "xavier_uniform":
            nn.init.xavier_uniform_(lin.weight, generator=gen)
        else:
            lecun_normal_(lin.weight, n_in, gen)
        lin.bias.zero_()
    return lin


def _apply(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype):
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class EncoderBlock(nn.Module):
    """Pre-LN block: ``x + proj(attn(ln_1(x)))``, then ``x +
    mlp_proj(gelu(fc(ln_2(x))))``."""

    tp = None       # the Split of a tensor-parallel placement

    def __init__(self, config: ViTConfig, device, gen):
        super().__init__()
        c = config
        self.config = c
        e = c.n_embd
        self.ln_1 = LayerNorm(e, 1e-6, c.dtype, c.param_dtype, device)
        for name in ("q", "k", "v", "proj"):
            setattr(self, name, _dense(e, e, c, device, gen, "xavier_uniform"))
        self.ln_2 = LayerNorm(e, 1e-6, c.dtype, c.param_dtype, device)
        self.fc = _dense(e, c.mlp_ratio * e, c, device, gen, "xavier_uniform")
        self.mlp_proj = _dense(c.mlp_ratio * e, e, c, device, gen,
                               "xavier_uniform")

    def forward(self, x: torch.Tensor, attn_fn: Callable) -> torch.Tensor:
        c = self.config
        dt = c.dtype
        b, t, e = x.shape
        h = self.ln_1(x)
        q, k, v = (_apply(getattr(self, name), h, dt)
                   .view(b, t, c.n_head, c.head_dim) for name in "qkv")
        x = x + _apply(self.proj, attn_fn(q, k, v).reshape(b, t, e), dt)
        h = F.gelu(_apply(self.fc, self.ln_2(x), dt), approximate="tanh")
        # Under tp this rank's hidden units meet its rows of mlp_proj and
        # the partial products are summed over tp. The bias is added to
        # the rounded product, as flax's Dense adds it, so at tp = 1 the
        # two routes agree bit for bit.
        if self.tp is not None:
            n = self.mlp_proj.weight.shape[1]
            h = enter(h, self.tp).narrow(-1, self.tp.index * n, n)
        y = F.linear(h, self.mlp_proj.weight.to(dt))
        return x + (leave(y, self.tp) + self.mlp_proj.bias.to(dt))


class ViT(nn.Module):
    """``forward(images [B, H, W, 3]) -> logits [B, num_classes]``.

    ``device`` defaults to the card (``core.accelerator.default_device``,
    which raises without one), or to ``mesh.device``; pass
    ``device="cpu"`` to run on the CPU. Weights are random from ``seed``
    on a ``torch.Generator`` of that device."""

    tensor_parallel = True      # place_params may split it over tp

    def __init__(self, config: ViTConfig, *, device=None, seed: int = 0,
                 attn_fn: Callable = _attention, mesh=None):
        super().__init__()
        self.config = c = config
        self.mesh = mesh
        self.sp = 1 if mesh is None else mesh.shape.get("sp", 1)
        self.attn_fn = attn_fn
        device = resolve_device(device, mesh)
        gen = torch.Generator(device=device).manual_seed(seed)
        e, pd = c.n_embd, c.param_dtype
        self.patch_embed = Conv(3, e, c.patch_size, c.patch_size, c.dtype,
                                pd, device, gen, bias=True)
        self.cls = nn.Parameter(torch.zeros(1, 1, e, dtype=pd, device=device))
        self.pos_embed = nn.Parameter(
            torch.empty(1, c.num_patches + 1, e, dtype=pd, device=device)
            .normal_(0.0, 0.02, generator=gen))
        self.h = nn.ModuleList(EncoderBlock(c, device, gen)
                               for _ in range(c.n_layer))
        self.ln_f = LayerNorm(e, 1e-6, c.dtype, pd, device)
        self.head = _dense(e, c.num_classes, c, device, gen, "lecun_normal")

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        c = self.config
        dt = c.dtype
        b = images.shape[0]
        # [B, H, W, 3] memory seen as NCHW (channels_last); the patch grid
        # comes back as [B, h, w, E] memory, flattened row-major as in JAX.
        x = self.patch_embed(images.to(dt).permute(0, 3, 1, 2))
        x = x.permute(0, 2, 3, 1).reshape(b, -1, c.n_embd)
        x = torch.cat([self.cls.to(dt).expand(b, 1, c.n_embd), x], dim=1)
        x = x + self.pos_embed.to(dt)
        attn_fn = self.attn_fn
        if self.sp > 1:
            t = x.shape[1]
            block, lengths = seq_blocks(t, self.sp)
            x = F.pad(x, (0, 0, 0, block * self.sp - t)).narrow(
                1, self.mesh.axis_index("sp") * block, block)
            attn_fn = functools.partial(_bidir_ring_attention,
                                        lengths=lengths, mesh=self.mesh)
        for blk in self.h:
            if c.remat:
                x = remat_call(blk, x, attn_fn, policy="nothing")
            else:
                x = blk(x, attn_fn)
        x = self.ln_f(x)
        logits = F.linear(x[:, 0].float(), self.head.weight, self.head.bias)
        return cls_logits(logits, self.mesh) if self.sp > 1 else logits

    @torch.no_grad()
    def load_jax_params(self, params: dict) -> None:
        """Copy the JAX package's flax params (a nested dict of numpy
        arrays, as ``ray_tpu.models.ViT.init_params`` gives them after
        ``np.asarray``) into this module."""
        def put(dst: torch.Tensor, src, perm=None):
            src = torch.from_numpy(np.array(src, dtype=np.float32))
            if perm is not None:
                src = src.permute(*perm)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"shape {tuple(src.shape)} does not fit "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)

        def dense(lin: nn.Linear, p: dict):
            put(lin.weight, p["kernel"], (1, 0))
            put(lin.bias, p["bias"])

        def norm(ln: LayerNorm, p: dict):
            put(ln.scale, p["scale"])
            put(ln.bias, p["bias"])

        put(self.patch_embed.weight, params["patch_embed"]["kernel"],
            (3, 2, 0, 1))
        put(self.patch_embed.bias, params["patch_embed"]["bias"])
        put(self.cls, params["cls"])
        put(self.pos_embed, params["pos_embed"])
        for i, block in enumerate(self.h):
            p = params[f"h_{i}"]
            norm(block.ln_1, p["ln_1"])
            norm(block.ln_2, p["ln_2"])
            for name in ("q", "k", "v", "proj", "fc", "mlp_proj"):
                dense(getattr(block, name), p[name])
        norm(self.ln_f, params["ln_f"])
        dense(self.head, params["head"])


def vit_loss_fn():
    """``(model, batch) -> scalar loss``; batch = {images, labels}, the
    JAX package's keys. The JAX counterpart takes ``(params, batch)`` with
    the flax module bound outside; here the ``ViT`` module holds its
    parameters and is the first argument."""

    def loss_fn(model: ViT, batch):
        return softmax_cross_entropy(model(batch["images"]), batch["labels"])

    return loss_fn
