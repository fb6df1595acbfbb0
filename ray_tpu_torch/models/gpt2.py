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
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ray_tpu_torch.core.accelerator import resolve_device
from ray_tpu_torch.ops.attention import causal_attention


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


class GPT2(nn.Module):
    """GPT-2 LM. ``forward(tokens) -> logits``; wte is tied to the LM head.

    ``device`` defaults to the card (``core.accelerator.default_device``,
    which raises without one); pass ``device="cpu"`` to run on the CPU.
    Weights are random from ``seed`` on a ``torch.Generator`` of that
    device."""

    def __init__(self, config: GPT2Config, *, device=None, seed: int = 0,
                 attn_fn: Callable = causal_attention):
        super().__init__()
        if config.dropout > 0:
            raise NotImplementedError("dropout > 0 is not ported yet")
        self.config = config
        self.attn_fn = attn_fn
        device = resolve_device(device)
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
        x = F.embedding(tokens, self.wte.weight.to(dt)) \
            + self.wpe.weight[:t].to(dt)
        for block in self.h:
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
        def put(dst: torch.Tensor, src, transpose: bool = False):
            src = torch.from_numpy(np.array(src, dtype=np.float32))
            if transpose:
                src = src.t()
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"shape {tuple(src.shape)} does not fit "
                                 f"parameter {tuple(dst.shape)}")
            dst.copy_(src)

        put(self.wte.weight, params["wte"]["embedding"])
        put(self.wpe.weight, params["wpe"]["embedding"])
        for i, block in enumerate(self.h):
            p = params[f"h_{i}"]
            for name in ("ln_1", "ln_2"):
                ln = getattr(block, name)
                put(ln.scale, p[name]["scale"])
                put(ln.bias, p[name]["bias"])
            for name in ("qkv_kernel", "qkv_bias", "proj_kernel",
                         "proj_bias"):
                put(getattr(block.attn, name), p["attn"][name])
            for name in ("fc", "proj"):
                lin = getattr(block.mlp, name)
                put(lin.weight, p["mlp"][name]["kernel"], transpose=True)
                put(lin.bias, p["mlp"][name]["bias"])
        put(self.ln_f.scale, params["ln_f"]["scale"])
        put(self.ln_f.bias, params["ln_f"]["bias"])


def cross_entropy_loss(logits, targets, ignore_index: int = -1):
    """Mean token cross-entropy; positions == ignore_index are masked."""
    logp = torch.log_softmax(logits, dim=-1)
    mask = targets != ignore_index
    safe = torch.where(mask, targets, 0).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(mask, nll, 0.0)
    return nll.sum() / mask.sum().clamp_min(1)


class ChunkedCrossEntropyFn(torch.autograd.Function):
    """Tied LM head + cross-entropy over row chunks ``[n, chunk, E]``.

    Forward keeps only each row's log-sum-exp; backward recomputes each
    chunk's logits and reuses that lse, dlogits = (softmax − onehot)/cnt.
    The embedding gradient is summed in float32 across chunks and
    returned in the embedding's type, as the reference does."""

    @staticmethod
    def forward(ctx, rows_c, emb, tgt_c, ignore_index):
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
        ctx.save_for_backward(rows_c, emb, tgt_c, lse_c, cnt)
        ctx.ignore_index = ignore_index
        return tot / cnt.clamp_min(1).float()

    @staticmethod
    def backward(ctx, g):
        rows_c, emb, tgt_c, lse_c, cnt = ctx.saved_tensors
        scale = g / cnt.clamp_min(1).float()
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
        return dx, demb.to(emb.dtype), None, None


def chunked_cross_entropy(hidden, embedding, targets,
                          ignore_index: int = -1,
                          chunk_size: int = 2048):
    """Cross-entropy that never materializes the full (B, S, vocab)
    logits: the tied LM head and the loss run per row chunk, with a
    hand-written backward that recomputes each chunk's logits and reuses
    the saved per-row log-sum-exp. Rows that do not fill the last chunk
    are padded with zeros and ``ignore_index`` targets."""
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
        tgt.reshape(n, chunk), ignore_index)


def gpt2_loss_fn(fused_ce: bool = True, ce_chunk: int = 2048):
    """``(model, batch) -> scalar loss``; batch = {tokens, targets}.

    The JAX counterpart takes ``(params, batch)`` with the flax module
    bound outside; here the ``GPT2`` module holds its parameters and is
    the first argument. ``fused_ce`` (default) uses the chunked LM-head
    + cross-entropy path; False materializes full float32 logits (not
    differentiable on the card: an evaluation path)."""

    def loss_fn(model: GPT2, batch):
        if fused_ce:
            h = model(batch["tokens"], return_hidden=True)
            return chunked_cross_entropy(h, model.wte.weight,
                                         batch["targets"],
                                         chunk_size=ce_chunk)
        return cross_entropy_loss(model(batch["tokens"]), batch["targets"])

    return loss_fn
