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
(:func:`gpt2_loss_fn`) is the mean over the data ranks' tokens
(``parallel.mesh.DATA_AXES``).

Placed on a mesh with a real ``tp`` axis (``parallel.sharding.place_params``),
each rank holds its block of the weights the table splits, and the layers
run Megatron's column and row products on the layouts kept from JAX:
``qkv_kernel`` and ``qkv_bias`` are this rank's heads, ``proj_kernel``
their rows, ``mlp.fc`` its output columns and ``mlp.proj`` its input
rows; a replicated activation enters through ``collective.device.copy_to``
and a row product leaves through ``reduce_from``, its bias added once
after the sum. ``mlp.fc.bias`` is replicated: a rank adds its own columns
of it, taken through ``copy_to``, so its gradient is summed over ``tp``
in the backward. ``wte`` is split on the vocabulary: the lookup is
a masked local lookup summed over ``tp`` (:func:`vocab_embedding`), and
the chunked cross-entropy is vocab-parallel. The placement gives each of
those layers its ``tp`` attribute (a ``parallel.sharding.Split``).

``GPT2Config.dropout`` acts as flax's ``nn.Dropout`` does in the JAX
model: at the embedding sum, the attention projection's output and the
MLP's output, and only in a forward with ``deterministic=False``, which
draws its masks from the ``torch.Generator`` passed as ``generator=`` (the
counterpart of ``rngs={"dropout": key}``). Each element is kept with
probability 1 − ``dropout`` and scaled by 1/(1 − ``dropout``). The loss
(:func:`gpt2_loss_fn`) and so the train step run the model
deterministically, as the JAX package's loss does: a config with dropout
trains as one without. A block's masks are drawn before it runs, so a
block under remat recomputes its forward with the same masks.

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
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch.collective import device as coll
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


def skip_init(cls: type, *args, **kwargs) -> nn.Module:
    """``cls(*args, **kwargs)`` with its parameters allocated but not
    initialised, as ``torch.nn.utils.skip_init`` gives. That one builds the
    module on the meta device, whose reference kernels import
    ``torch._dynamo`` (and with it sympy): seconds of every worker's start.
    Here the instance's own ``reset_parameters`` is a no-op while ``cls``'s
    ``__init__`` runs (``nn.Linear`` and ``nn.Embedding`` call it last)."""
    module = cls.__new__(cls)
    object.__setattr__(module, "reset_parameters", lambda: None)
    cls.__init__(module, *args, **kwargs)
    object.__delattr__(module, "reset_parameters")
    return module


def _normal(shape, std, dtype, device, gen):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device)
                        .normal_(0.0, std, generator=gen))


def enter(x: torch.Tensor, split) -> torch.Tensor:
    """A replicated activation entering a layer whose weights ``split``
    cuts (``collective.device.copy_to``); ``x`` itself without one."""
    return x if split is None else coll.copy_to(x, split.group)


def leave(x: torch.Tensor, split) -> torch.Tensor:
    """The sum of the ranks' partial products over ``split``
    (``collective.device.reduce_from``); ``x`` itself without one."""
    return x if split is None else coll.reduce_from(x, split.group)


def vocab_embedding(tokens: torch.Tensor, table: torch.Tensor, tp,
                    dtype: torch.dtype) -> torch.Tensor:
    """``table``'s rows for ``tokens`` in ``dtype`` (the table cast before
    the gather, as flax's ``Embed(dtype=)``). Under ``tp`` the table is
    this rank's block of the vocabulary: each rank looks up the tokens
    that fall in its block, zeros for the others, and the rows are summed
    over ``tp``."""
    if tp is None:
        return F.embedding(tokens, table.to(dtype))
    n = table.shape[0]
    ids = tokens - tp.index * n
    inside = (ids >= 0) & (ids < n)
    rows = F.embedding(torch.where(inside, ids, 0), table.to(dtype))
    return coll.reduce_from(torch.where(inside[..., None], rows, 0),
                            tp.group)


def lm_logits(logits: torch.Tensor, tp) -> torch.Tensor:
    """The whole vocabulary's logits from this rank's block of them."""
    return logits if tp is None else coll.gather_from(logits, tp.group, -1)


class CausalSelfAttention(nn.Module):
    tp = None       # the Split of a tensor-parallel placement

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
        dt, e, d = c.dtype, c.n_embd, c.head_dim
        h = self.qkv_kernel.shape[2]        # this rank's heads
        b, t, _ = x.shape
        x = enter(x, self.tp)
        # One fused qkv product: [B, T, E] @ [E, 3*H*D] -> [B, T, 3, H, D].
        qkv = (x.to(dt) @ self.qkv_kernel.to(dt).reshape(e, 3 * h * d)) \
            .view(b, t, 3, h, d) + self.qkv_bias.to(dt)
        q, k, v = qkv.unbind(2)
        y = attn_fn(q, k, v)
        y = y.reshape(b, t, h * d) @ self.proj_kernel.to(dt).reshape(h * d, e)
        return leave(y, self.tp) + self.proj_bias.to(dt)


class MLP(nn.Module):
    tp = None

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
        # Under tp the column product takes this rank's columns (and its
        # columns of the replicated bias, whose gradient copy_to sums over
        # tp) and the row product is summed over tp. The row product's
        # bias is added to the rounded product, as flax's Dense adds it,
        # so at tp = 1 the two routes agree bit for bit.
        bias = self.fc.bias
        if self.tp is not None:
            n = self.fc.weight.shape[0]
            bias = enter(bias, self.tp).narrow(0, self.tp.index * n, n)
        h = F.linear(enter(x, self.tp).to(dt), self.fc.weight.to(dt),
                     bias.to(dt))
        # tanh-approximate GELU: flax nn.gelu's default.
        y = F.linear(F.gelu(h, approximate="tanh"), self.proj.weight.to(dt))
        return leave(y, self.tp) + self.proj.bias.to(dt)


def dropout(x: torch.Tensor, keep: torch.Tensor | None, rate: float
            ) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` with its mask given: ``x / (1 − rate)``
    where ``keep``, else 0; ``x`` itself without a mask."""
    if keep is None:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def keep_mask(shape, rate: float, device, generator: torch.Generator
              ) -> torch.Tensor:
    """Which elements a dropout of ``rate`` keeps: each with probability
    1 − ``rate``, from ``generator`` (flax's ``bernoulli(rng, 1 − rate)``
    draw, not its bits)."""
    return torch.rand(shape, device=device, generator=generator) < 1.0 - rate


class Block(nn.Module):
    """Pre-LN transformer block (LayerNorm eps 1e-5). ``keep``: the masks
    of its two dropouts (attention output, MLP output), or None."""

    def __init__(self, config: GPT2Config, device, gen):
        super().__init__()
        c = config
        self.ln_1 = LayerNorm(c.n_embd, 1e-5, c.dtype, c.param_dtype, device)
        self.attn = CausalSelfAttention(c, device, gen)
        self.ln_2 = LayerNorm(c.n_embd, 1e-5, c.dtype, c.param_dtype, device)
        self.mlp = MLP(c, device, gen)

    def forward(self, x, attn_fn: Callable, keep=None):
        rate = self.attn.config.dropout
        keep_attn, keep_mlp = keep or (None, None)
        x = x + dropout(self.attn(self.ln_1(x), attn_fn), keep_attn, rate)
        return x + dropout(self.mlp(self.ln_2(x)), keep_mlp, rate)

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
    when asked, and cut to this rank's block where placement split
    ``dst`` (its ``placement``); ValueError when the shapes differ."""
    src = torch.from_numpy(np.array(src, dtype=np.float32))
    if transpose:
        src = src.t()
    placement = getattr(dst, "placement", None)
    if placement is not None:
        src = placement.block(src)
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

    tensor_parallel = True      # place_params may split it over tp
    tp = None

    def __init__(self, config: GPT2Config, *, device=None, seed: int = 0,
                 attn_fn: Callable | None = None, mesh=None):
        super().__init__()
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

    def forward(self, tokens: torch.Tensor, deterministic: bool = True,
                return_hidden: bool = False,
                generator: torch.Generator | None = None):
        """Logits, or with ``return_hidden`` the final hidden states.
        ``deterministic=False`` applies the config's dropout with masks
        from ``generator`` (ValueError without one)."""
        c = self.config
        dt = c.dtype
        b, t = tokens.shape
        rate = c.dropout if not deterministic else 0.0
        if rate > 0 and generator is None:
            raise ValueError(
                "deterministic=False with dropout > 0 draws its masks from "
                "generator= (a torch.Generator on the model's device), as "
                "the JAX model draws them from rngs={'dropout': key}")

        def masks(n: int):
            if rate <= 0:
                return None
            return tuple(keep_mask((b, t, c.n_embd), rate, tokens.device,
                                   generator) for _ in range(n))

        pos0 = seq_offset(self.mesh, c.sp_axis, t)
        x = vocab_embedding(tokens, self.wte.weight, self.tp, dt) \
            + self.wpe.weight[pos0:pos0 + t].to(dt)
        if rate > 0:
            x = dropout(x, masks(1)[0], rate)
        for block in self.h:
            if c.remat:
                x = remat_call(block, x, self.attn_fn, masks(2),
                               policy=c.remat_policy)
            else:
                x = block(x, self.attn_fn, masks(2))
        x = self.ln_f(x)
        if return_hidden:
            # Final hidden states for the chunked LM-head loss, which
            # never materializes the full (B, T, vocab) logits.
            return x
        return lm_logits(matmul_f32(x.reshape(b * t, -1).to(dt),
                                    self.wte.weight.to(dt).t()),
                         self.tp).view(b, t, -1)

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
    returned in the embedding's type, as the reference does.

    Under ``tp`` (a ``parallel.sharding.Split``) ``emb`` is this rank's
    block of the vocabulary and each chunk's logits are ``[chunk, V/tp]``:
    the ranks' row log-sum-exps and target logits (the target's owner
    holds it, the others 0) are gathered once, after the last chunk, and
    combined (a log-sum-exp and a sum); the hidden-state gradient, a
    partial product on each rank, is summed over ``tp`` once. The full
    ``[n, V]`` logits never exist. At ``tp = 1`` every step is the
    mesh-less one's, bit for bit."""

    @staticmethod
    def forward(ctx, rows_c, emb, tgt_c, ignore_index, group, tp):
        n = rows_c.shape[0]
        emb_t = emb.t()
        lo = 0 if tp is None else tp.index * emb.shape[0]
        lse_c = torch.empty(tgt_c.shape, dtype=torch.float32,
                            device=rows_c.device)
        picked_c = torch.empty_like(lse_c)
        for i in range(n):
            logits = matmul_f32(rows_c[i], emb_t)
            lse_c[i] = torch.logsumexp(logits, dim=-1)
            safe, inside = _local_targets(tgt_c[i], ignore_index, lo,
                                          emb.shape[0])
            picked_c[i] = torch.where(
                inside, logits.gather(1, safe[:, None])[:, 0], 0.0)
        if tp is not None:
            both = coll._all_gather(torch.stack([lse_c, picked_c]),
                                    tp.group).view(-1, 2, *lse_c.shape)
            lse_c = torch.logsumexp(both[:, 0], dim=0)
            picked_c = both[:, 1].sum(0)
        tot = torch.zeros((), dtype=torch.float32, device=rows_c.device)
        cnt = torch.zeros((), dtype=torch.int64, device=rows_c.device)
        for i in range(n):
            mask = tgt_c[i] != ignore_index
            tot += torch.where(mask, lse_c[i] - picked_c[i], 0.0).sum()
            cnt += mask.sum()
        cnt, ranks = _token_count(cnt, group)
        ctx.save_for_backward(rows_c, emb, tgt_c, lse_c, cnt)
        ctx.ignore_index, ctx.ranks, ctx.tp, ctx.lo = (ignore_index, ranks,
                                                      tp, lo)
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
            safe, inside = _local_targets(tgt_c[i], ctx.ignore_index, ctx.lo,
                                          emb.shape[0])
            p.scatter_add_(1, safe[:, None],
                           torch.where(inside, -1.0, 0.0)[:, None])
            dlb = (p * (scale * mask)[:, None]).to(emb.dtype)
            dx[i] = dlb @ emb
            demb += matmul_f32(dlb.t(), rows_c[i])
        if ctx.tp is not None:
            dx = coll._all_reduce(dx, ctx.tp.group)
        return dx, demb.to(emb.dtype), None, None, None, None


def _local_targets(tgt: torch.Tensor, ignore_index: int, lo: int, n: int):
    """(column of each row's target in a vocabulary block ``[lo, lo+n)``,
    0 where the target is masked or outside; whether it is inside)."""
    safe = torch.where(tgt != ignore_index, tgt, 0) - lo
    inside = (safe >= 0) & (safe < n)
    return torch.where(inside, safe, 0), inside


def chunked_cross_entropy(hidden, embedding, targets,
                          ignore_index: int = -1,
                          chunk_size: int = 2048, group=None, tp=None):
    """Cross-entropy that never materializes the full (B, S, vocab)
    logits: the tied LM head and the loss run per row chunk, with a
    hand-written backward that recomputes each chunk's logits and reuses
    the saved per-row log-sum-exp. Rows that do not fill the last chunk
    are padded with zeros and ``ignore_index`` targets.

    With ``group`` (a process group whose ranks hold other tokens) the
    token count is summed over the group and this rank's loss is its sum
    times the group's size over that count: the mean of the ranks'
    losses, which the train step takes, is the mean over every token, and
    so are the gradients the step averages. With ``tp`` (a
    ``parallel.sharding.Split``) ``embedding`` is this rank's block of the
    vocabulary and the loss is vocab-parallel (:class:`ChunkedCrossEntropyFn`)."""
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
        tgt.reshape(n, chunk), ignore_index, group, tp)


def gpt2_loss_fn(fused_ce: bool = True, ce_chunk: int = 2048):
    """``(model, batch) -> scalar loss``; batch = {tokens, targets}.

    The JAX counterpart takes ``(params, batch)`` with the flax module
    bound outside; here the ``GPT2`` module holds its parameters and is
    the first argument. On a mesh whose data axes hold more than one rank
    the loss is this rank's share of the mean over their tokens (the
    ``group`` of :func:`chunked_cross_entropy`); under ``tp`` the
    cross-entropy is vocab-parallel. ``fused_ce`` (default) uses the
    chunked LM-head + cross-entropy path; False materializes full float32 logits (not
    differentiable on the card: an evaluation path)."""

    def loss_fn(model: GPT2, batch):
        group = loss_group(model.mesh)
        if fused_ce:
            h = model(batch["tokens"], return_hidden=True)
            return chunked_cross_entropy(h, model.wte.weight,
                                         batch["targets"],
                                         chunk_size=ce_chunk, group=group,
                                         tp=model.tp)
        return cross_entropy_loss(model(batch["tokens"]), batch["targets"],
                                  group=group)

    return loss_fn
