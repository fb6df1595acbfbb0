"""Switch-MoE transformer LM: the counterpart of ``ray_tpu/models/moe.py``.

GPT-2-shaped: every ``moe_every``-th block's MLP is a top-1-routed
mixture of experts (``ops.moe``), the others are GPT-2's blocks, and
the embedding, LayerNorms, attention, tied LM head and chunked
cross-entropy are GPT-2's own (``models.gpt2``), as the JAX module
imports them from its ``gpt2.py``. The numerics follow the flax model:
float32 router logits, tokens, expert weights and the combine weights
cast to the compute type, the tanh GELU.

The experts run in index form on every device (``ops.moe.switch_ffn``):
a scatter into static ``[E, C, D]`` queues and a gather back, never the
``[T, E, C]`` one-hot of the JAX package, which at the bench's batch
would not fit the card. Where flax ``sow``s each MoE layer's
load-balancing loss into ``intermediates``, :meth:`MoETransformer.forward`
returns them as one tensor beside its output, and :func:`moe_loss_fn`
takes their mean.

``MoEConfig.remat`` is kept with the JAX config's fields but read
nowhere, as ``MoETransformer`` in the JAX package never reads it.

On a mesh (``MoETransformer(config, mesh=mesh)``) the model runs as the
JAX model does under GSPMD: each rank holds its block of the batch (over
``dp`` and ``fsdp``, the sequence over ``sp``), attention and the dense
blocks are GPT-2's on the mesh (heads over ``tp``), and each
``SwitchFFN`` routes the GLOBAL tokens of the batch
(``ops.moe.switch_ffn``): the capacity and every token's queue position
are those of the whole batch, so the drops are the JAX model's, and the
aux loss is the global one. Placed on a real ``ep`` axis
(``parallel.sharding.place_params``), a rank holds ``E / ep`` experts
and runs them on its data shard's tokens, which every ``ep`` rank of the
shard holds; the outputs are summed over ``ep``. A real ``tp`` axis
splits each expert's hidden dimension the same way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

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
    skip_init,
)
from ray_tpu_torch.models.gpt2 import (
    lm_logits,
    mesh_attention,
    seq_offset,
    vocab_embedding,
)
from ray_tpu_torch.ops.moe import switch_ffn
from ray_tpu_torch.parallel.mesh import loss_group
from ray_tpu_torch.parallel.sharding import Split


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
    normal(0.02). ``forward(x) -> (y, aux)``. On a mesh it routes the
    global tokens; ``ep`` and ``tp`` are the Splits placement gives it."""

    ep = None
    tp = None

    def __init__(self, config: MoEConfig, device, gen, mesh=None):
        super().__init__()
        c = config
        self.config = c
        self.mesh = mesh
        d, e, pd = c.n_embd, c.num_experts, c.param_dtype
        self.router = _normal((d, e), 0.02, pd, device, gen)
        self.w_up = _normal((e, d, 4 * d), 0.02, pd, device, gen)
        self.w_down = _normal((e, 4 * d, d), 0.02, pd, device, gen)

    def forward(self, x):
        axes = tuple(s.axes[0] for s in (self.ep, self.tp) if s is not None)
        return switch_ffn(x, self.router, self.w_up, self.w_down,
                          capacity_factor=self.config.capacity_factor,
                          dtype=self.config.dtype, mesh=self.mesh,
                          experts=Split(self.mesh, axes) if axes else None)


class MoEBlock(nn.Module):
    """Pre-LN block whose MLP is a :class:`SwitchFFN`;
    ``forward(x, attn_fn) -> (x, aux)``."""

    def __init__(self, config: MoEConfig, device, gen, mesh=None):
        super().__init__()
        c = config
        g = c.gpt2()
        self.ln_1 = LayerNorm(c.n_embd, 1e-5, c.dtype, c.param_dtype, device)
        self.attn = CausalSelfAttention(g, device, gen)
        self.ln_2 = LayerNorm(c.n_embd, 1e-5, c.dtype, c.param_dtype, device)
        self.moe = SwitchFFN(c, device, gen, mesh)

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
    which raises without one), or to ``mesh.device``; pass
    ``device="cpu"`` to run on the CPU. Weights are random from ``seed``
    on a ``torch.Generator`` of that device. ``attn_fn`` defaults to the
    mesh's attention (``models.gpt2.mesh_attention``)."""

    tensor_parallel = True      # place_params may split it over tp
    tp = None

    def __init__(self, config: MoEConfig, *, device=None, seed: int = 0,
                 attn_fn: Callable | None = None, mesh=None):
        super().__init__()
        c = config
        self.config = c
        self.mesh = mesh
        self.attn_fn = attn_fn or mesh_attention(mesh, c.attn_impl,
                                                 c.sp_axis)
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
            MoEBlock(c, device, gen, mesh) if c.is_moe(i)
            else Block(g, device, gen)
            for i in range(c.n_layer))
        self.ln_f = LayerNorm(c.n_embd, 1e-5, c.dtype, c.param_dtype, device)

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False):
        dt = self.config.dtype
        b, t = tokens.shape
        pos0 = seq_offset(self.mesh, self.config.sp_axis, t)
        x = vocab_embedding(tokens, self.wte.weight, self.tp, dt) \
            + self.wpe.weight[pos0:pos0 + t].to(dt)
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
        return lm_logits(matmul_f32(x.reshape(b * t, -1).to(dt),
                                    self.wte.weight.to(dt).t()),
                         self.tp).view(b, t, -1), aux

    # The flax tree's ``h_{i}`` holds ``moe`` on MoE blocks and ``mlp``
    # on dense ones; each block loads its own.
    load_jax_params = GPT2.load_jax_params


def moe_loss_fn(fused_ce: bool = True, ce_chunk: int = 2048):
    """``(model, batch) -> scalar loss``: the LM loss plus
    ``aux_loss_coeff`` times the mean of the MoE layers' load-balancing
    losses (``models/moe.py:168-191``). ``fused_ce`` (default) uses the
    chunked LM-head + cross-entropy; False materializes full float32
    logits (an evaluation path). On a mesh the LM loss is the mean over
    the data ranks' tokens, as ``models.gpt2.gpt2_loss_fn``'s, and the aux
    losses are the global ones on every rank."""

    def loss_fn(model: MoETransformer, batch):
        group = loss_group(model.mesh)
        if fused_ce:
            h, aux = model(batch["tokens"], return_hidden=True)
            lm = chunked_cross_entropy(h, model.wte.weight, batch["targets"],
                                       chunk_size=ce_chunk, group=group,
                                       tp=model.tp)
        else:
            logits, aux = model(batch["tokens"])
            lm = cross_entropy_loss(logits, batch["targets"], group=group)
        if aux.numel() == 0:
            return lm
        return lm + model.config.aux_loss_coeff * aux.float().mean()

    return loss_fn
