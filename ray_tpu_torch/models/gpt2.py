"""GPT-2 in PyTorch: the counterpart of ``ray_tpu/models/gpt2.py``.

The numerics follow the flax model so that the two agree step for step:

- float32 parameters, bfloat16 compute (``GPT2Config.dtype``): every
  layer casts its weights and input to the compute type, as flax's
  ``dtype=`` does.
- the JAX parameter layouts are kept: ``qkv_kernel [E, 3, H, D]``,
  ``qkv_bias [3, H, D]``, ``proj_kernel [H, D, E]``, ``proj_bias [E]``,
  so the fused qkv product yields q, k and v with no transposes. The MLP
  uses ``nn.Linear`` (weight ``[out, in]``, the transpose of flax
  ``Dense``'s ``[in, out]`` kernel; :meth:`GPT2.load_jax_params` swaps
  it).
- LayerNorm takes its statistics in float32 with the fast variance
  E[x²] − E[x]², clipped at 0, as flax's ``LayerNorm(dtype=bf16)``.
- the embedding tables are cast to the compute type before the gather,
  as flax's ``Embed(dtype=bf16)``.
- the tied LM head takes compute-type operands and returns float32
  logits (``preferred_element_type=f32`` in the reference): on the card
  one bf16 product with a float32 output, on the CPU a float32 product
  of the rounded operands, which is the same number.

Attention is pluggable (``attn_fn``) and defaults to
``ops.attention.causal_attention``: the CUDA flash kernels for CUDA
tensors, their plain versions for CPU tensors.

``GPT2(config, mesh=mesh)`` runs on a mesh (``parallel.mesh``), as the JAX
model does: each rank holds its block of the batch (over ``dp`` and
``fsdp``) and, on a real ``sp`` axis, its block of the sequence, and
attention comes from ``ops.attention.make_sharded_causal_attention``
(``config.attn_impl``: ring or Ulysses over ``config.sp_axis``). A
sequence block takes the position embeddings of its own rows. The loss
(:func:`gpt2_loss_fn`) is the mean over every rank's tokens.

``GPT2Config.remat`` runs each block under activation checkpointing
(``torch.utils.checkpoint``, non-reentrant), the counterpart of
``nn.remat`` per block; ``remat_policy`` names what the forward may keep,
as ``jax.checkpoint_policies`` do, through selective checkpointing;
``"everything"`` keeps all, which is the block without a checkpoint. The
flash kernels are custom ops, not matrix products, so every policy but
``"everything"`` runs the attention forward again in the backward, as
JAX does with its ``pallas_call``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch.core.accelerator import resolve_device
from ray_tpu_torch.ops.attention import (
    causal_attention,
    make_sharded_causal_attention,
)
from ray_tpu_torch.parallel.mesh import loss_group


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304          # 50257 padded up to a multiple of 128
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    seq_len: int = 1024
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16       # compute dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    # What remat may KEEP from the forward (see _REMAT_POLICIES):
    # "nothing" recomputes the whole block, "dots" / "dots_no_batch" keep
    # matrix-product outputs, "everything" keeps all and recomputes
    # nothing (the block runs without a checkpoint).
    remat_policy: str = "nothing"
    attn_impl: str = "auto"          # "auto" | "dense" | "ring" | "ulysses"
    sp_axis: str = "sp"

    @staticmethod
    def small(**kw) -> "GPT2Config":
        return GPT2Config(**kw)

    @staticmethod
    def medium(**kw) -> "GPT2Config":
        return GPT2Config(n_layer=24, n_head=16, n_embd=1024, **kw)

    @staticmethod
    def large(**kw) -> "GPT2Config":
        return GPT2Config(n_layer=36, n_head=20, n_embd=1280, **kw)

    @staticmethod
    def tiny(**kw) -> "GPT2Config":
        """Test-size config."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("n_layer", 2)
        kw.setdefault("n_head", 4)
        kw.setdefault("n_embd", 64)
        kw.setdefault("seq_len", 64)
        return GPT2Config(**kw)

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def num_params(self) -> int:
        e, l, v, s = self.n_embd, self.n_layer, self.vocab_size, \
            self.seq_len
        per_block = 12 * e * e + 13 * e  # qkv+proj+mlp + norms/biases
        return v * e + s * e + l * per_block + 2 * e


_aten = torch.ops.aten
# Ops whose outputs each policy saves, the counterparts of
# jax.checkpoint_policies' nothing_saveable, checkpoint_dots,
# checkpoint_dots_with_no_batch_dims and everything_saveable. On the
# port's models every product without batch dimensions reaches the
# dispatcher as mm or addmm. "everything" (None) recomputes nothing,
# which is autograd without a checkpoint: a checkpoint that saved every
# op would keep every intermediate, where autograd keeps only what the
# backward reads.
_REMAT_POLICIES = {
    "nothing": frozenset(),
    "dots": frozenset({_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm}),
    "dots_no_batch": frozenset({_aten.mm, _aten.addmm}),
    "everything": None,
}


def _policy(saved, ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op.overloadpacket in saved:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(name: str) -> Callable | None:
    """Resolve a ``remat_policy`` name to a selective-checkpoint policy,
    ``(ctx, op, *args, **kwargs) -> CheckpointPolicy``, or None for
    ``"everything"``, whose blocks run without a checkpoint; ValueError
    for an unknown name."""
    try:
        saved = _REMAT_POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown remat policy {name!r}; "
            f"one of {sorted(_REMAT_POLICIES)}") from None
    return None if saved is None else functools.partial(_policy, saved)


def remat_call(fn: Callable, *args, policy: str):
    """``fn(*args)`` under non-reentrant activation checkpointing with the
    named policy: the counterpart of ``nn.remat(..., policy=...)``."""
    policy_fn = remat_policy(policy)
    if policy_fn is None:
        return fn(*args)
    return checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     policy_fn))


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result from operands of any float type
    (XLA's ``preferred_element_type=f32``). On the card it is one bf16
    product with a float32 output; callers differentiate it by hand
    (``ChunkedCrossEntropyFn``) or run it without grad."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class LayerNorm(nn.Module):
    """flax ``LayerNorm(epsilon, dtype)``: float32 statistics with the
    fast variance, scale and bias in float32, output in ``dtype``."""

    def __init__(self, n: int, eps: float, dtype: torch.dtype,
                 param_dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(n, dtype=param_dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(n, dtype=param_dtype,
                                             device=device))

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x - mean) * mul + self.bias).to(self.dtype)


def _normal(shape, std, dtype, device, gen):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device)
                        .normal_(0.0, std, generator=gen))


class CausalSelfAttention(nn.Module):
    def __init__(self, config: GPT2Config, device, gen):
        super().__init__()
        c = config
        self.config = c
        h, d, e, pd = c.n_head, c.head_dim, c.n_embd, c.param_dtype
        self.qkv_kernel = _normal((e, 3, h, d), 0.02, pd, device, gen)
        self.qkv_bias = nn.Parameter(torch.zeros(3, h, d, dtype=pd,
                                                 device=device))
        self.proj_kernel = _normal((h, d, e), 0.02 / math.sqrt(2 * c.n_layer),
                                   pd, device, gen)
        self.proj_bias = nn.Parameter(torch.zeros(e, dtype=pd, device=device))

    def forward(self, x, attn_fn: Callable):
        c = self.config
        dt, e, h, d = c.dtype, c.n_embd, c.n_head, c.head_dim
        b, t, _ = x.shape
        # One fused qkv product: [B, T, E] @ [E, 3*H*D] -> [B, T, 3, H, D].
        qkv = (x.to(dt) @ self.qkv_kernel.to(dt).reshape(e, 3 * h * d)) \
            .view(b, t, 3, h, d) + self.qkv_bias.to(dt)
        q, k, v = qkv.unbind(2)
        y = attn_fn(q, k, v)
        return y.reshape(b, t, h * d) \
            @ self.proj_kernel.to(dt).reshape(h * d, e) + self.proj_bias.to(dt)


class MLP(nn.Module):
    def __init__(self, config: GPT2Config, device, gen):
        super().__init__()
        c = config
        self.config = c
        e, pd = c.n_embd, c.param_dtype
        self.fc = skip_init(nn.Linear, e, 4 * e, dtype=pd, device=device)
        self.proj = skip_init(nn.Linear, 4 * e, e, dtype=pd, device=device)
        for lin, std in ((self.fc, 0.02),
                         (self.proj, 0.02 / math.sqrt(2 * c.n_layer))):
            with torch.no_grad():
                lin.weight.normal_(0.0, std, generator=gen)
                lin.bias.zero_()

    def forward(self, x):
        dt = self.config.dtype

        def dense(lin, h):
            return F.linear(h.to(dt), lin.weight.to(dt), lin.bias.to(dt))

        # tanh-approximate GELU: flax nn.gelu's default.
        return dense(self.proj, F.gelu(dense(self.fc, x), approximate="tanh"))


class Block(nn.Module):
    """Pre-LN transformer block (LayerNorm eps 1e-5)."""

    def __init__(self, config: GPT2Config, device, gen):
        super().__init__()
        c = config
        self.ln_1 = LayerNorm(c.n_embd, 1e-5, c.dtype, c.param_dtype, device)
        self.attn = CausalSelfAttention(c, device, gen)
        self.ln_2 = LayerNorm(c.n_embd, 1e-5, c.dtype, c.param_dtype, device)
        self.mlp = MLP(c, device, gen)

    def forward(self, x, attn_fn: Callable):
        x = x + self.attn(self.ln_1(x), attn_fn)
        return x + self.mlp(self.ln_2(x))

    @torch.no_grad()
    def load_jax_params(self, p: dict) -> None:
        """This block's flax params (``params["h_{i}"]``)."""
        load_norms_and_attention(self, p)
        for name in ("fc", "proj"):
            lin = getattr(self.mlp, name)
            put_param(lin.weight, p["mlp"][name]["kernel"], transpose=True)
            put_param(lin.bias, p["mlp"][name]["bias"])


def put_param(dst: torch.Tensor, src, transpose: bool = False) -> None:
    """Copy one flax param (a numpy array) into ``dst``, transposed first
    when asked; ValueError when the shapes differ."""
    src = torch.from_numpy(np.array(src, dtype=np.float32))
    if transpose:
        src = src.t()
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} does not fit "
                         f"parameter {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def load_norms_and_attention(block: nn.Module, p: dict) -> None:
    """A pre-LN block's ``ln_1``, ``ln_2`` and ``attn`` from its flax
    params: what GPT-2's blocks and the MoE blocks share."""
    for name in ("ln_1", "ln_2"):
        ln = getattr(block, name)
        put_param(ln.scale, p[name]["scale"])
        put_param(ln.bias, p[name]["bias"])
    for name in ("qkv_kernel", "qkv_bias", "proj_kernel", "proj_bias"):
        put_param(getattr(block.attn, name), p["attn"][name])


def mesh_attention(mesh, attn_impl: str, sp_axis: str) -> Callable:
    """The attention of a model on ``mesh`` (JAX's ``_attn_fn``): the
    sharded attention where an axis of the activations holds more than
    one rank, else ``causal_attention``."""
    if mesh is not None and any(mesh.shape.get(a, 1) > 1
                                for a in ("dp", "fsdp", "tp", sp_axis)):
        return make_sharded_causal_attention(mesh, seq_axis=sp_axis,
                                             impl=attn_impl)
    return causal_attention


def seq_offset(mesh, sp_axis: str, t: int) -> int:
    """The first absolute position of this rank's ``t`` rows: its index
    along ``sp_axis`` times ``t`` (0 off a mesh)."""
    if mesh is None or mesh.shape.get(sp_axis, 1) == 1:
        return 0
    return mesh.axis_index(sp_axis) * t


class GPT2(nn.Module):
    """GPT-2 LM. ``forward(tokens) -> logits``; wte is tied to the LM head.

    ``device`` defaults to the card (``core.accelerator.default_device``,
    which raises without one), or to ``mesh.device``; pass
    ``device="cpu"`` to run on the CPU. Weights are random from ``seed``
    on a ``torch.Generator`` of that device. ``attn_fn`` defaults to the
    mesh's attention (:func:`mesh_attention`)."""

    def __init__(self, config: GPT2Config, *, device=None, seed: int = 0,
                 attn_fn: Callable | None = None, mesh=None):
        super().__init__()
        if config.dropout > 0:
            raise NotImplementedError("dropout > 0 is not ported yet")
        if config.remat:
            remat_policy(config.remat_policy)   # unknown names raise here
        self.config = config
        self.mesh = mesh
        self.attn_fn = attn_fn or mesh_attention(mesh, config.attn_impl,
                                                 config.sp_axis)
        device = resolve_device(device, mesh)
        gen = torch.Generator(device=device).manual_seed(seed)
        c = config
        self.wte = skip_init(nn.Embedding, c.vocab_size, c.n_embd,
                             dtype=c.param_dtype, device=device)
        self.wpe = skip_init(nn.Embedding, c.seq_len, c.n_embd,
                             dtype=c.param_dtype, device=device)
        with torch.no_grad():
            self.wte.weight.normal_(0.0, 0.02, generator=gen)
            self.wpe.weight.normal_(0.0, 0.01, generator=gen)
        self.h = nn.ModuleList(Block(c, device, gen) for _ in range(c.n_layer))
        self.ln_f = LayerNorm(c.n_embd, 1e-5, c.dtype, c.param_dtype, device)

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False):
        dt = self.config.dtype
        b, t = tokens.shape
        pos0 = seq_offset(self.mesh, self.config.sp_axis, t)
        x = F.embedding(tokens, self.wte.weight.to(dt)) \
            + self.wpe.weight[pos0:pos0 + t].to(dt)
        for block in self.h:
            if self.config.remat:
                x = remat_call(block, x, self.attn_fn,
                               policy=self.config.remat_policy)
            else:
                x = block(x, self.attn_fn)
        x = self.ln_f(x)
        if return_hidden:
            # Final hidden states for the chunked LM-head loss, which
            # never materializes the full (B, T, vocab) logits.
            return x
        return matmul_f32(x.reshape(b * t, -1).to(dt),
                          self.wte.weight.to(dt).t()).view(b, t, -1)

    @torch.no_grad()
    def load_jax_params(self, params: dict) -> None:
        """Copy the JAX package's flax params (a nested dict of numpy
        arrays, as ``ray_tpu.models.GPT2.init_params`` gives them after
        ``np.asarray``) into this module."""
        put_param(self.wte.weight, params["wte"]["embedding"])
        put_param(self.wpe.weight, params["wpe"]["embedding"])
        for i, block in enumerate(self.h):
            block.load_jax_params(params[f"h_{i}"])
        put_param(self.ln_f.scale, params["ln_f"]["scale"])
        put_param(self.ln_f.bias, params["ln_f"]["bias"])


def _token_count(mask_sum: torch.Tensor, group) -> tuple:
    """(the count of tokens the mean divides by, the factor a rank's sum
    takes): this rank's own count, or, over the ranks of ``group``, the
    count of all of them with each rank's sum scaled by the group's size,
    so that the mean of the ranks' losses is the mean over every token
    (local counts differ where ``ignore_index`` masks unevenly)."""
    if group is None:
        return mask_sum, 1
    total = mask_sum.clone()
    dist.all_reduce(total, group=group)
    return total, dist.get_world_size(group)


def cross_entropy_loss(logits, targets, ignore_index: int = -1, group=None):
    """Mean token cross-entropy; positions == ignore_index are masked.
    With ``group``, this rank's share of the mean over the group's tokens
    (see :func:`chunked_cross_entropy`)."""
    logp = torch.log_softmax(logits, dim=-1)
    mask = targets != ignore_index
    safe = torch.where(mask, targets, 0).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(mask, nll, 0.0)
    cnt, n = _token_count(mask.sum(), group)
    return nll.sum() * n / cnt.clamp_min(1)


class ChunkedCrossEntropyFn(torch.autograd.Function):
    """Tied LM head + cross-entropy over row chunks ``[n, chunk, E]``.

    Forward keeps only each row's log-sum-exp; backward recomputes each
    chunk's logits and reuses that lse, dlogits = (softmax − onehot)/cnt.
    The embedding gradient is summed in float32 across chunks and
    returned in the embedding's type, as the reference does."""

    @staticmethod
    def forward(ctx, rows_c, emb, tgt_c, ignore_index, group):
        n = rows_c.shape[0]
        emb_t = emb.t()
        tot = torch.zeros((), dtype=torch.float32, device=rows_c.device)
        cnt = torch.zeros((), dtype=torch.int64, device=rows_c.device)
        lse_c = torch.empty(tgt_c.shape, dtype=torch.float32,
                            device=rows_c.device)
        for i in range(n):
            logits = matmul_f32(rows_c[i], emb_t)
            lse = torch.logsumexp(logits, dim=-1)
            mask = tgt_c[i] != ignore_index
            safe = torch.where(mask, tgt_c[i], 0)
            picked = logits.gather(1, safe[:, None])[:, 0]
            tot += torch.where(mask, lse - picked, 0.0).sum()
            cnt += mask.sum()
            lse_c[i] = lse
        cnt, ranks = _token_count(cnt, group)
        ctx.save_for_backward(rows_c, emb, tgt_c, lse_c, cnt)
        ctx.ignore_index, ctx.ranks = ignore_index, ranks
        return tot * ranks / cnt.clamp_min(1).float()

    @staticmethod
    def backward(ctx, g):
        rows_c, emb, tgt_c, lse_c, cnt = ctx.saved_tensors
        scale = g * ctx.ranks / cnt.clamp_min(1).float()
        emb_t = emb.t()
        demb = torch.zeros(emb.shape, dtype=torch.float32, device=emb.device)
        dx = torch.empty_like(rows_c)
        for i in range(rows_c.shape[0]):
            logits = matmul_f32(rows_c[i], emb_t)
            mask = tgt_c[i] != ctx.ignore_index
            p = torch.exp(logits - lse_c[i][:, None])
            safe = torch.where(mask, tgt_c[i], 0)
            p.scatter_add_(1, safe[:, None], torch.full_like(p[:, :1], -1.0))
            dlb = (p * (scale * mask)[:, None]).to(emb.dtype)
            dx[i] = dlb @ emb
            demb += matmul_f32(dlb.t(), rows_c[i])
        return dx, demb.to(emb.dtype), None, None, None


def chunked_cross_entropy(hidden, embedding, targets,
                          ignore_index: int = -1,
                          chunk_size: int = 2048, group=None):
    """Cross-entropy that never materializes the full (B, S, vocab)
    logits: the tied LM head and the loss run per row chunk, with a
    hand-written backward that recomputes each chunk's logits and reuses
    the saved per-row log-sum-exp. Rows that do not fill the last chunk
    are padded with zeros and ``ignore_index`` targets.

    With ``group`` (a process group whose ranks hold other tokens) the
    token count is summed over the group and this rank's loss is its sum
    times the group's size over that count: the mean of the ranks'
    losses, which the train step takes, is the mean over every token, and
    so are the gradients the step averages."""
    b, s, e = hidden.shape
    n_rows = b * s
    rows = hidden.reshape(n_rows, e)
    tgt = targets.reshape(n_rows).long()
    chunk = min(chunk_size, n_rows)
    pad = (-n_rows) % chunk
    if pad:
        rows = F.pad(rows, (0, 0, 0, pad))
        tgt = F.pad(tgt, (0, pad), value=ignore_index)
    n = rows.shape[0] // chunk
    # Cast the tied embedding ONCE (fwd and bwd both use the copy).
    return ChunkedCrossEntropyFn.apply(
        rows.reshape(n, chunk, e), embedding.to(hidden.dtype),
        tgt.reshape(n, chunk), ignore_index, group)


def gpt2_loss_fn(fused_ce: bool = True, ce_chunk: int = 2048):
    """``(model, batch) -> scalar loss``; batch = {tokens, targets}.

    The JAX counterpart takes ``(params, batch)`` with the flax module
    bound outside; here the ``GPT2`` module holds its parameters and is
    the first argument. On a mesh of more than one rank the loss is this
    rank's share of the mean over every rank's tokens (the ``group`` of
    :func:`chunked_cross_entropy`). ``fused_ce`` (default) uses the
    chunked LM-head + cross-entropy path; False materializes full float32 logits (not
    differentiable on the card: an evaluation path)."""

    def loss_fn(model: GPT2, batch):
        group = loss_group(model.mesh)
        if fused_ce:
            h = model(batch["tokens"], return_hidden=True)
            return chunked_cross_entropy(h, model.wte.weight,
                                         batch["targets"],
                                         chunk_size=ce_chunk, group=group)
        return cross_entropy_loss(model(batch["tokens"]), batch["targets"],
                                  group=group)

    return loss_fn
