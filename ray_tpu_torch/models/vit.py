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
ranks. The JAX model also names the ``sp`` axis, where XLA gathers the
sequence for its dense attention; a ViT over sequence or tensor ranks is
not in the port yet (ROADMAP §1) and raises NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.core.accelerator import resolve_device
from ray_tpu_torch.models.gpt2 import LayerNorm, remat_call
from ray_tpu_torch.models.resnet import Conv, lecun_normal_, \
    softmax_cross_entropy
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
        return x + _apply(self.mlp_proj, h, dt)


class ViT(nn.Module):
    """``forward(images [B, H, W, 3]) -> logits [B, num_classes]``.

    ``device`` defaults to the card (``core.accelerator.default_device``,
    which raises without one), or to ``mesh.device``; pass
    ``device="cpu"`` to run on the CPU. Weights are random from ``seed``
    on a ``torch.Generator`` of that device."""

    def __init__(self, config: ViTConfig, *, device=None, seed: int = 0,
                 attn_fn: Callable = _attention, mesh=None):
        super().__init__()
        for axis in ("sp", "tp"):
            if mesh is not None and mesh.shape.get(axis, 1) > 1:
                raise NotImplementedError(
                    f"ViT on a mesh with {axis}={mesh.shape[axis]} is not "
                    "in the port yet (ROADMAP §1)")
        self.config = c = config
        self.mesh = mesh
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
        for block in self.h:
            if c.remat:
                x = remat_call(block, x, self.attn_fn, policy="nothing")
            else:
                x = block(x, self.attn_fn)
        x = self.ln_f(x)
        return F.linear(x[:, 0].float(), self.head.weight, self.head.bias)

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
