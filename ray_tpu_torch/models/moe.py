"""Switch-MoE transformer LM: the counterpart of ``ray_tpu/models/moe.py``.

GPT-2-shaped: every ``moe_every``-th block's MLP is a top-1-routed
mixture of experts (``ops.moe``), the others are GPT-2's blocks, and
the embedding, LayerNorms, attention, tied LM head and chunked
cross-entropy are GPT-2's own (``models.gpt2``), as the JAX module
imports them from its ``gpt2.py``. The numerics follow the flax model:
float32 router logits, tokens, expert weights and the combine weights
cast to the compute type, the tanh GELU.

The experts run in index form on every device (``ops.moe.moe_ffn``): a
scatter into static ``[E, C, D]`` queues and a gather back, never the
``[T, E, C]`` one-hot of the JAX package, which at the bench's batch
would not fit the card. Where flax ``sow``s each MoE layer's
load-balancing loss into ``intermediates``, :meth:`MoETransformer.forward`
returns them as one tensor beside its output, and :func:`moe_loss_fn`
takes their mean.

``MoEConfig.remat`` is kept with the JAX config's fields but read
nowhere, as ``MoETransformer`` in the JAX package never reads it. The
mesh fields (``attn_impl``, ``sp_axis``, ``MoETransformer(mesh=)``) are
those of the JAX model; a mesh of more than one rank raises
NotImplementedError for now: through ``SwitchFFN`` the JAX model routes
the GLOBAL tokens of the batch, which needs the experts and the routing
on a mesh (ROADMAP §1). ``ops.moe.moe_ffn`` over an ``ep`` group is the
expert-parallel layer that will carry it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ray_tpu_torch.core.accelerator import resolve_device
from ray_tpu_torch.models.gpt2 import (
    GPT2,
    Block,
    CausalSelfAttention,
    GPT2Config,
    LayerNorm,
    _normal,
    chunked_cross_entropy,
    cross_entropy_loss,
    load_norms_and_attention,
    matmul_f32,
    put_param,
)
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.moe import moe_ffn


@dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 50304
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    seq_len: int = 1024
    num_experts: int = 8
    capacity_factor: float = 2.0
    aux_loss_coeff: float = 0.01
    moe_every: int = 2               # every k-th block is MoE
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False              # never read, as in the JAX package
    attn_impl: str = "auto"
    sp_axis: str = "sp"

    @staticmethod
    def tiny(**kw) -> "MoEConfig":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("n_layer", 2)
        kw.setdefault("n_head", 4)
        kw.setdefault("n_embd", 64)
        kw.setdefault("seq_len", 64)
        kw.setdefault("num_experts", 4)
        return MoEConfig(**kw)

    def gpt2(self) -> GPT2Config:
        return GPT2Config(
            vocab_size=self.vocab_size, n_layer=self.n_layer,
            n_head=self.n_head, n_embd=self.n_embd, seq_len=self.seq_len,
            dtype=self.dtype, param_dtype=self.param_dtype,
            attn_impl=self.attn_impl, sp_axis=self.sp_axis)

    def is_moe(self, i: int) -> bool:
        """Whether block ``i`` is a MoE block (``models/moe.py:150``)."""
        return (i + 1) % self.moe_every == 0


class SwitchFFN(nn.Module):
    """Top-1 routed expert MLP over the flattened ``[B·T, D]`` tokens:
    ``router [D, E]``, ``w_up [E, D, 4D]``, ``w_down [E, 4D, D]``, each
    normal(0.02). ``forward(x) -> (y, aux)``."""

    def __init__(self, config: MoEConfig, device, gen):
        super().__init__()
        c = config
        self.config = c
        d, e, pd = c.n_embd, c.num_experts, c.param_dtype
        self.router = _normal((d, e), 0.02, pd, device, gen)
        self.w_up = _normal((e, d, 4 * d), 0.02, pd, device, gen)
        self.w_down = _normal((e, 4 * d, d), 0.02, pd, device, gen)

    def forward(self, x):
        b, t, d = x.shape
        y, aux = moe_ffn(x.reshape(b * t, d), self.router, self.w_up,
                         self.w_down,
                         capacity_factor=self.config.capacity_factor,
                         dtype=self.config.dtype)
        return y.view(b, t, d), aux


class MoEBlock(nn.Module):
    """Pre-LN block whose MLP is a :class:`SwitchFFN`;
    ``forward(x, attn_fn) -> (x, aux)``."""

    def __init__(self, config: MoEConfig, device, gen):
        super().__init__()
        c = config
        g = c.gpt2()
        self.ln_1 = LayerNorm(c.n_embd, 1e-5, c.dtype, c.param_dtype, device)
        self.attn = CausalSelfAttention(g, device, gen)
        self.ln_2 = LayerNorm(c.n_embd, 1e-5, c.dtype, c.param_dtype, device)
        self.moe = SwitchFFN(c, device, gen)

    def forward(self, x, attn_fn: Callable):
        x = x + self.attn(self.ln_1(x), attn_fn)
        y, aux = self.moe(self.ln_2(x))
        return x + y, aux

    @torch.no_grad()
    def load_jax_params(self, p: dict) -> None:
        load_norms_and_attention(self, p)
        for name in ("router", "w_up", "w_down"):
            put_param(getattr(self.moe, name), p["moe"][name])


class MoETransformer(nn.Module):
    """GPT-2-shaped LM with switch-MoE FFNs every ``moe_every``-th block.
    ``forward(tokens) -> (logits, aux)``, ``aux`` holding each MoE
    layer's load-balancing loss in order; wte is tied to the LM head.

    ``device`` defaults to the card (``core.accelerator.default_device``,
    which raises without one); pass ``device="cpu"`` to run on the CPU.
    Weights are random from ``seed`` on a ``torch.Generator`` of that
    device."""

    def __init__(self, config: MoEConfig, *, device=None, seed: int = 0,
                 attn_fn: Callable = causal_attention, mesh=None):
        super().__init__()
        if mesh is not None and mesh.size > 1:
            raise NotImplementedError(
                "MoETransformer on a mesh of more than one rank (global "
                "routing through SwitchFFN) is not in the port yet "
                "(ROADMAP §1)")
        c = config
        self.config = c
        self.mesh = mesh
        self.attn_fn = attn_fn
        device = resolve_device(device, mesh)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.wte = skip_init(nn.Embedding, c.vocab_size, c.n_embd,
                             dtype=c.param_dtype, device=device)
        self.wpe = skip_init(nn.Embedding, c.seq_len, c.n_embd,
                             dtype=c.param_dtype, device=device)
        with torch.no_grad():
            self.wte.weight.normal_(0.0, 0.02, generator=gen)
            self.wpe.weight.normal_(0.0, 0.01, generator=gen)
        g = c.gpt2()
        self.h = nn.ModuleList(
            MoEBlock(c, device, gen) if c.is_moe(i) else Block(g, device, gen)
            for i in range(c.n_layer))
        self.ln_f = LayerNorm(c.n_embd, 1e-5, c.dtype, c.param_dtype, device)

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False):
        dt = self.config.dtype
        b, t = tokens.shape
        x = F.embedding(tokens, self.wte.weight.to(dt)) \
            + self.wpe.weight[:t].to(dt)
        aux = []
        for block in self.h:
            if isinstance(block, MoEBlock):
                x, a = block(x, self.attn_fn)
                aux.append(a)
            else:
                x = block(x, self.attn_fn)
        x = self.ln_f(x)
        aux = (torch.stack(aux) if aux
               else torch.zeros((0,), dtype=torch.float32, device=x.device))
        if return_hidden:
            return x, aux
        return matmul_f32(x.reshape(b * t, -1).to(dt),
                          self.wte.weight.to(dt).t()).view(b, t, -1), aux

    # The flax tree's ``h_{i}`` holds ``moe`` on MoE blocks and ``mlp``
    # on dense ones; each block loads its own.
    load_jax_params = GPT2.load_jax_params


def moe_loss_fn(fused_ce: bool = True, ce_chunk: int = 2048):
    """``(model, batch) -> scalar loss``: the LM loss plus
    ``aux_loss_coeff`` times the mean of the MoE layers' load-balancing
    losses (``models/moe.py:168-191``). ``fused_ce`` (default) uses the
    chunked LM-head + cross-entropy; False materializes full float32
    logits (an evaluation path)."""

    def loss_fn(model: MoETransformer, batch):
        if fused_ce:
            h, aux = model(batch["tokens"], return_hidden=True)
            lm = chunked_cross_entropy(h, model.wte.weight, batch["targets"],
                                       chunk_size=ce_chunk)
        else:
            logits, aux = model(batch["tokens"])
            lm = cross_entropy_loss(logits, batch["targets"])
        if aux.numel() == 0:
            return lm
        return lm + model.config.aux_loss_coeff * aux.float().mean()

    return loss_fn
