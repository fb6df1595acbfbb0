"""Llama-family decoder in PyTorch: the counterpart of
``ray_tpu/models/llama.py``.

RMSNorm, rotary position embeddings, a SwiGLU MLP, grouped-query
attention (``n_kv_head < n_head``), no biases, the LM head tied to the
embedding unless ``tie_embeddings=False``. The numerics follow the flax
model, as ``models/gpt2.py`` does for GPT-2:

- float32 parameters, bfloat16 compute: every dense layer casts its
  weight and input to the compute type (flax ``Dense(dtype=bf16)``);
  weights are ``nn.Linear``'s ``[out, in]``, the transpose of flax's
  ``[in, out]`` kernel (:meth:`Llama.load_jax_params` swaps them).
- RMSNorm takes its statistics in float32, ``x * rsqrt(mean(x²) + eps)``
  times the float32 scale, then casts to the compute type.
- RoPE rotates interleaved pairs ``(x[..., 0::2], x[..., 1::2])``, not
  the "rotate half" layout of other Llama code; the angles are float32,
  their cos and sin are cast to the compute type before the products.
- GQA repeats each key/value head ``n_head / n_kv_head`` times in place
  (``jnp.repeat(k, rep, axis=2)``, which is ``repeat_interleave``, not
  ``Tensor.repeat``), so the attention sees equal head counts. In eager
  PyTorch this is a real copy of k and v.
- the tied head returns float32 logits from compute-type operands; the
  untied ``lm_head`` returns compute-type logits cast to float32, as the
  flax ``Dense`` does.

Attention is pluggable (``attn_fn``), by default
``ops.attention.causal_attention`` (the CUDA flash kernels for CUDA
tensors). ``remat=True`` runs each block under activation checkpointing
with the ``"nothing"`` policy, as the reference's ``nn.remat`` with
``nothing_saveable`` does. ``Llama(config, mesh=mesh)`` runs on a mesh as
``models/gpt2.py`` describes: a sequence block's RoPE angles are those of
its own rows, and GQA repeats k and v before the exchange of ring or
Ulysses attention, as the JAX model does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ray_tpu_torch.core.accelerator import resolve_device
from ray_tpu_torch.models.gpt2 import (
    chunked_cross_entropy,
    cross_entropy_loss,
    matmul_f32,
    mesh_attention,
    remat_call,
    seq_offset,
)
from ray_tpu_torch.parallel.mesh import loss_group


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layer: int = 22
    n_head: int = 32
    n_kv_head: int = 4               # GQA groups
    n_embd: int = 2048
    intermediate: int = 5632         # SwiGLU hidden
    seq_len: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    attn_impl: str = "auto"          # auto | dense | ring | ulysses
    sp_axis: str = "sp"
    tie_embeddings: bool = True

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("n_layer", 2)
        kw.setdefault("n_head", 4)
        kw.setdefault("n_kv_head", 2)
        kw.setdefault("n_embd", 64)
        kw.setdefault("intermediate", 176)
        kw.setdefault("seq_len", 64)
        return LlamaConfig(**kw)

    @staticmethod
    def tinyllama_1b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)     # the defaults above are the 1.1B

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        kw.setdefault("n_layer", 32)
        kw.setdefault("n_head", 32)
        kw.setdefault("n_kv_head", 32)
        kw.setdefault("n_embd", 4096)
        kw.setdefault("intermediate", 11008)
        kw.setdefault("seq_len", 4096)
        return LlamaConfig(**kw)

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


def rope_freqs(head_dim: int, seq_len: int, theta: float,
               device=None) -> torch.Tensor:
    """``[seq_len, head_dim / 2]`` float32 rotation angles."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    return torch.outer(t, inv)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the (even, odd) pairs of ``x [B, T, H, D]`` by the
    per-position ``angles [T, D/2]``."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    cos = torch.cos(angles)[None, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[None, :, None, :].to(x.dtype)
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape)


class RMSNorm(nn.Module):
    """flax ``RMSNorm`` of the reference: float32 statistics and scale,
    output in ``dtype``."""

    def __init__(self, n: int, eps: float, dtype: torch.dtype,
                 param_dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(n, dtype=param_dtype,
                                             device=device))

    def forward(self, x):
        xf = x.float()
        norm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(self.dtype)


def _linear(n_in: int, n_out: int, config: LlamaConfig, device, gen):
    """A bias-free dense layer, weight normal(0.02) (no depth scaling)."""
    lin = skip_init(nn.Linear, n_in, n_out, bias=False,
                    dtype=config.param_dtype, device=device)
    with torch.no_grad():
        lin.weight.normal_(0.0, 0.02, generator=gen)
    return lin


def _dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype):
    return F.linear(x.to(dtype), lin.weight.to(dtype))


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device, gen):
        super().__init__()
        c = config
        self.config = c
        e, hd = c.n_embd, c.head_dim
        self.q = _linear(e, c.n_head * hd, c, device, gen)
        self.k = _linear(e, c.n_kv_head * hd, c, device, gen)
        self.v = _linear(e, c.n_kv_head * hd, c, device, gen)
        self.proj = _linear(c.n_head * hd, e, c, device, gen)

    def forward(self, x, attn_fn: Callable, angles):
        """``angles``: ``[T, D/2]``, those of this block's rows."""
        c = self.config
        dt, hd = c.dtype, c.head_dim
        b, t, _ = x.shape
        q = _dense(self.q, x, dt).view(b, t, c.n_head, hd)
        k = _dense(self.k, x, dt).view(b, t, c.n_kv_head, hd)
        v = _dense(self.v, x, dt).view(b, t, c.n_kv_head, hd)
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
        # GQA: each kv head repeated in place, as jnp.repeat(axis=2).
        rep = c.n_head // c.n_kv_head
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        y = attn_fn(q, k, v)
        return _dense(self.proj, y.reshape(b, t, c.n_head * hd), dt)


class SwiGLU(nn.Module):
    def __init__(self, config: LlamaConfig, device, gen):
        super().__init__()
        c = config
        self.config = c
        self.gate = _linear(c.n_embd, c.intermediate, c, device, gen)
        self.up = _linear(c.n_embd, c.intermediate, c, device, gen)
        self.down = _linear(c.intermediate, c.n_embd, c, device, gen)

    def forward(self, x):
        dt = self.config.dtype
        return _dense(self.down, F.silu(_dense(self.gate, x, dt))
                      * _dense(self.up, x, dt), dt)


class LlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig, device, gen):
        super().__init__()
        c = config
        self.attn_norm = RMSNorm(c.n_embd, c.rms_eps, c.dtype, c.param_dtype,
                                 device)
        self.attn = LlamaAttention(c, device, gen)
        self.mlp_norm = RMSNorm(c.n_embd, c.rms_eps, c.dtype, c.param_dtype,
                                device)
        self.mlp = SwiGLU(c, device, gen)

    def forward(self, x, attn_fn: Callable, angles):
        x = x + self.attn(self.attn_norm(x), attn_fn, angles)
        return x + self.mlp(self.mlp_norm(x))


class Llama(nn.Module):
    """Llama-style decoder LM. ``forward(tokens) -> logits``.

    ``device`` defaults to the card (``core.accelerator.default_device``,
    which raises without one), or to ``mesh.device``; pass
    ``device="cpu"`` to run on the CPU. Weights are random from ``seed``
    on a ``torch.Generator`` of that device. ``attn_fn`` defaults to the
    mesh's attention (``models.gpt2.mesh_attention``)."""

    def __init__(self, config: LlamaConfig, *, device=None, seed: int = 0,
                 attn_fn: Callable | None = None, mesh=None):
        super().__init__()
        self.config = config
        self.mesh = mesh
        self.attn_fn = attn_fn or mesh_attention(mesh, config.attn_impl,
                                                 config.sp_axis)
        device = resolve_device(device, mesh)
        gen = torch.Generator(device=device).manual_seed(seed)
        c = config
        self.wte = skip_init(nn.Embedding, c.vocab_size, c.n_embd,
                             dtype=c.param_dtype, device=device)
        with torch.no_grad():
            self.wte.weight.normal_(0.0, 0.02, generator=gen)
        self.h = nn.ModuleList(LlamaBlock(c, device, gen)
                               for _ in range(c.n_layer))
        self.norm_f = RMSNorm(c.n_embd, c.rms_eps, c.dtype, c.param_dtype,
                              device)
        if not c.tie_embeddings:
            # flax Dense's default init: lecun_normal (truncated normal,
            # fan_in scaling).
            self.lm_head = skip_init(nn.Linear, c.n_embd, c.vocab_size,
                                     bias=False, dtype=c.param_dtype,
                                     device=device)
            std = c.n_embd ** -0.5 / 0.87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(self.lm_head.weight, std=std,
                                      a=-2 * std, b=2 * std, generator=gen)
        self.register_buffer(
            "angles", rope_freqs(c.head_dim, c.seq_len, c.rope_theta, device),
            persistent=False)

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False):
        c = self.config
        dt = c.dtype
        b, t = tokens.shape
        pos0 = seq_offset(self.mesh, c.sp_axis, t)
        angles = self.angles[pos0:pos0 + t]
        x = F.embedding(tokens, self.wte.weight.to(dt))
        for block in self.h:
            if c.remat:
                x = remat_call(block, x, self.attn_fn, angles,
                               policy="nothing")
            else:
                x = block(x, self.attn_fn, angles)
        x = self.norm_f(x)
        if return_hidden:
            # Final hidden states for the chunked LM-head loss.
            return x
        rows = x.reshape(b * t, -1).to(dt)
        if c.tie_embeddings:
            logits = matmul_f32(rows, self.wte.weight.to(dt).t())
        else:
            logits = _dense(self.lm_head, rows, dt).float()
        return logits.view(b, t, -1)

    @torch.no_grad()
    def load_jax_params(self, params: dict) -> None:
        """Copy the JAX package's flax params (a nested dict of numpy
        arrays, as ``ray_tpu.models.Llama.init_params`` gives them after
        ``np.asarray``) into this module."""
        def put(dst: torch.Tensor, src, transpose: bool = False):
            src = torch.from_numpy(np.array(src, dtype=np.float32))
            if transpose:
                src = src.t()
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"shape {tuple(src.shape)} does not fit "
                                 f"parameter {tuple(dst.shape)}")
            dst.copy_(src)

        put(self.wte.weight, params["wte"]["embedding"])
        for i, block in enumerate(self.h):
            p = params[f"h_{i}"]
            put(block.attn_norm.scale, p["attn_norm"]["scale"])
            put(block.mlp_norm.scale, p["mlp_norm"]["scale"])
            for name in ("q", "k", "v", "proj"):
                put(getattr(block.attn, name).weight,
                    p["attn"][name]["kernel"], transpose=True)
            for name in ("gate", "up", "down"):
                put(getattr(block.mlp, name).weight,
                    p["mlp"][name]["kernel"], transpose=True)
        put(self.norm_f.scale, params["norm_f"]["scale"])
        if not self.config.tie_embeddings:
            put(self.lm_head.weight, params["lm_head"]["kernel"],
                transpose=True)


def llama_loss_fn(fused_ce: bool = True, ce_chunk: int = 2048):
    """``(model, batch) -> scalar loss``; batch = {tokens, targets}.

    ``fused_ce`` (default) runs the chunked LM-head + cross-entropy of
    ``models/gpt2.py`` on the tied embedding, or on ``lm_head``'s weight
    (the transpose of the flax kernel, as the reference passes it) when
    the head is untied; False materializes full float32 logits (an
    evaluation path on the card, as for GPT-2). On a mesh the loss is the
    mean over every rank's tokens, as ``models.gpt2.gpt2_loss_fn``'s."""

    def loss_fn(model: Llama, batch):
        group = loss_group(model.mesh)
        if fused_ce:
            h = model(batch["tokens"], return_hidden=True)
            head = (model.wte.weight if model.config.tie_embeddings
                    else model.lm_head.weight)
            return chunked_cross_entropy(h, head, batch["targets"],
                                         chunk_size=ce_chunk, group=group)
        return cross_entropy_loss(model(batch["tokens"]), batch["targets"],
                                  group=group)

    return loss_fn
