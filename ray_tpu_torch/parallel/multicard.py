"""Every mesh route of the port across several NCCL ranks, one card each,
held against the one-card mesh-less captured step.

:func:`run` starts ``n`` ranks with :func:`parallel.dryrun.spawn` (rank r
on ``cuda:r``) and runs the cases of :data:`CASES` in each, in order.
Every rank first runs, on its own card, the mesh-less step of each model
a case uses, from the same weights (seed 0) on the same global batch
(numpy seed 0): the reference. The rank then runs the case's mesh route
and compares it with that reference itself, so no tensor crosses
processes; what comes back are readings (losses, gradient norms, per-layer
gradient errors, times, launch counts, the NCCL kernels of one profiled
step). :func:`checks` turns them into pass/fail lines against the limits
below, each with its rounding argument. ``chip_smoke.py --cards 4`` (phase
16) and ``tests/test_torch_cuda_multicard.py`` are its callers.

The cases (``scale="full"``: the widths and batches of the chip_smoke
phases; ``"tiny"``, with ``device="cpu"``, gloo ranks on the CPU, where
the routes run on the kernels' plain versions):

- ``a``: GPT-2 on ``dp n``, captured: the flat-bucket gradient all-reduce
  in the graph, ``compile_count`` 1, buffers donated, the first losses and
  gradient norms;
- ``b``: TinyLlama on ``fsdp n`` (FSDP2, eager by rule): the step-0 loss,
  peak memory per rank against the one-card step's;
- ``c``: GPT-2 on ``sp n`` with ring attention, TinyLlama on ``sp n`` with
  Ulysses: losses and every layer's step-0 gradient; the ring's
  rotations timed alone;
- ``d``: GPT-2 and TinyLlama on ``dp n/2 × tp 2`` and ``tp n``, captured;
- ``e``: the switch-MoE transformer on ``dp n/2 × ep 2`` and ``ep n``,
  captured: losses and the routers' step-0 gradients;
- ``f``: ``spmd_pipeline`` over ``pp n`` (GPT-2's blocks cut into n
  stages), PIPE_MICROBATCHES microbatches: the loss and each stage's block
  gradients against the whole batch's, and the bubble;
- ``g``: ViT and ResNet on ``dp n/2 × tp 2``, and ViT on ``sp n`` (the
  sequence padded to n blocks, the bidirectional ring on the non-causal
  rectangle; ``models/vit.py``), captured; ViT on ``sp n`` launches each
  rectangle kernel once a layer for each block with a valid row;
- ``h``: GPT-2 saved on ``tp n`` after 2 steps, restored on ``dp n`` and
  off any mesh: every parameter bit-equal to the saved one.

``fault`` names a planted fault of :data:`FAULTS`, applied in every rank
before the cases run, to show that the checks fail a wrong route.
"""

from __future__ import annotations

import datetime
import inspect
import math
import os
import shutil
import tempfile
import textwrap
import time
import traceback
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

CASES = ("a", "b", "c", "d", "e", "f", "g", "h")

STEPS = 4               # captured steps whose losses are compared
LLAMA_STEPS = 2         # TinyLlama's (its step takes ~0.4 s on an H100)
TIMED = 4               # steps timed after them (host clock, ending in a sync)
PIPE_MICROBATCHES = 4
CASE_WAIT_S = 300       # how long a rank waits for the others to end a case

# --- limits, each with its rounding argument --------------------------------
#
# The mesh routes and the one-card step run the same bf16 model from the
# same weights on the same tokens; they differ in the order of float32
# sums (a loss and a gradient summed over ranks, a gradient bucket
# all-reduced) and in the shapes of the products each card runs (8 rows
# of 1024 tokens instead of 32, a tp rank's columns), for which cuBLAS
# and cuDNN may pick kernels that round bf16 outputs differently. The
# gloo tests hold the same routes in float32 (tests/test_torch_mesh_train.py,
# tests/test_torch_tensor_parallel.py: loss 2e-5, gradient norm 2e-3).
#
# Step 0: both take the same weights, and the loss and the gradient norm
# differ only by those roundings, averaged over 32,768 tokens (16,384 for
# TinyLlama): the gloo limits hold. A route that drops or doubles a sum
# (a gradient averaged over the wrong ranks, a missing tp all-reduce) is
# off by its factor here.
STEP0_LOSS_RTOL = 2e-5
STEP0_GNORM_RTOL = 2e-3
# Except on tp, whose row products round each rank's partial product to
# bf16 before the all-reduce sums them (reduce_from), by design: two
# roundings of every residual-stream addition instead of one, in each of
# TinyLlama's 22 layers. That is the kind of difference chip_smoke's
# STEP0_LOSS_TOL holds between the kernels and the plain attention (1e-3
# on ~11 nats): 1e-4 relative.
STEP0_TP_LOSS_RTOL = 1e-4
# The later steps start from weights that already differ: AdamW's first
# updates are lr·sign(g), so every entry whose gradient lies within
# rounding of zero moves by 2·lr (6e-4 here) between the two runs with
# even odds, and the first steps from random init pass a loss spike (the
# one-card step's own gradient norm triples at GPT-2 124M's step 2),
# which amplifies such differences in the weights. So the later losses
# are held within 1e-3 relative (0.011 nats on ~11: an order below what
# one step of training moves them) and the gradient norms within 5e-2;
# float32 ranks on gloo round 2^16 times finer and need none of this.
LOSS_RTOL = 1e-3
GNORM_RTOL = 5e-2
# Every layer's step-0 gradient, sequence-parallel route against the
# whole sequence: the ring merges its hops in float32 and rounds o, dq,
# dk, dv once, the unsplit kernel rounds them after one pass, and 12 bf16
# layers at initial weights grow that into ~2% on the last layers' q and
# k gradients, as chip_smoke's GRAD_TOL (3.5e-2) reads for the kernels
# against their plain versions. float32 ranks on gloo have no rounding to
# grow, which is why the card needs this limit where gloo needs none.
LAYER_GRAD_RTOL = 3.5e-2
# The routers' step-0 gradients (float32 sums of bf16 products over the
# same tokens; the index form is bit-equal to the one-hot form on one
# card): the sum over ranks reorders them, 1e-3 as chip_smoke's
# MOE_FORM_GRAD_TOL.
ROUTER_GRAD_RTOL = 1e-3
# The pipeline, as chip_smoke phase 13 holds it at pp = 1: the loss within
# PIPE_LOSS_RTOL of the whole batch's, each block gradient within
# PIPE_GRAD_RTOL relative norm (each microbatch's bf16 weight gradient is
# rounded before the sum; 2.6e-3 read at pp = 1).
PIPE_LOSS_RTOL = 1e-5
PIPE_GRAD_RTOL = 1e-2
# ViT and ResNet on dp x tp (case g). Here the routes round differently
# by design, not only in the order of float32 sums: ViT's mlp_proj rounds
# two partial products and then their sum to bf16 instead of one product,
# and a tp rank's convolutions (half the output channels, half the
# images) may run another cuDNN algorithm, whose outputs round
# differently by up to one bf16 unit (2^-9 relative). The loss is a mean
# over 128 images, not over 32,768 tokens, so each image's rounding keeps
# ~16x more weight in it than a token's in GPT-2's: chip_smoke holds
# ViT-B/16's step-0 loss through the kernels against the plain attention,
# the same kind of difference, within 5e-3 (VIT_STEP0_LOSS_TOL), and so
# are the first losses here; the gradient norms (sums of squares of the
# same rounded products) within 2e-2. The float32 gloo test
# (tests/test_torch_vision_tp.py) holds the arithmetic of these routes to
# the JAX package within 2e-5.
VISION_LOSS_RTOL = 5e-3
VISION_GNORM_RTOL = 2e-2
# ResNet's running statistics after the compared steps, whole on every
# rank: relative to each buffer's largest entry, within 2e-2 (the
# statistics are means of the activations above; the variance of a
# channel whose mean is near zero is a small difference of rounded terms).
STATS_RTOL = 2e-2


@dataclass(frozen=True)
class Scale:
    gpt2: Callable
    llama: Callable
    moe: Callable
    vit: Callable
    resnet: Callable
    lm_batch: tuple[int, int]
    llama_batch: tuple[int, int]
    image_batch: int
    image_size: int


def scale(name: str) -> Scale:
    """The models and batches of a scale: ``"full"`` (GPT-2 124M at 32 x
    1024, TinyLlama 1.1B at 8 x 2048, ``MoEConfig()``, ViT-B/16 and
    ResNet-50 at 128 x 224²: the token and image counts the limits'
    arguments assume) or ``"tiny"`` (the tiny configs, for gloo ranks on
    the CPU)."""
    from ray_tpu_torch.models import (GPT2Config, LlamaConfig, MoEConfig,
                                      ResNet50Config, ViTConfig)
    if name == "full":
        return Scale(GPT2Config.small, LlamaConfig.tinyllama_1b, MoEConfig,
                     ViTConfig.base, ResNet50Config, (32, 1024), (8, 2048),
                     128, 224)
    if name == "tiny":
        return Scale(
            lambda **kw: GPT2Config.tiny(n_layer=4, **kw),
            lambda **kw: LlamaConfig.tiny(n_head=8, n_kv_head=4, **kw),
            lambda **kw: MoEConfig.tiny(n_layer=4, **kw),
            ViTConfig.tiny, ResNet50Config.tiny, (8, 64), (4, 64), 8, 32)
    raise ValueError(f"unknown scale {name!r}")


# --- planted faults -----------------------------------------------------------

# name: (the route, its text, the same text with the fault). The ring
# backward's dk, dv stop one rotation short of home: each rank keeps its
# left neighbour's key and value gradients.
FAULTS = {
    "ring_dkv_home": ("RingAttentionFn.backward", "        if n > 1:\n",
                      "        if n > 1 and i < n - 1:\n"),
}


def plant_fault(name: str) -> None:
    """Rebind the route of fault ``name`` (in ``ops.attention``) to its
    source with the fault, in this process."""
    from ray_tpu_torch.ops import attention
    route, old, new = FAULTS[name]
    cls, method = route.split(".")
    src = textwrap.dedent(inspect.getsource(
        getattr(getattr(attention, cls), method)))
    if src.count(old) != 1:
        raise RuntimeError(f"the anchor of fault {name} is not in {route}")
    scope = dict(vars(attention))
    exec(compile(src.replace(old, new), attention.__file__, "exec"),  # noqa: S102
         scope)
    setattr(getattr(attention, cls), method, scope[method])


# --- helpers ----------------------------------------------------------------

def lm_batch(vocab: int, b: int, t: int) -> dict:
    """The global LM batch of numpy seed 0 (chip_smoke's ``train_batch``)."""
    toks = np.random.default_rng(0).integers(0, vocab, (b, t)) \
        .astype(np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, 1)}


def image_batch(b: int, size: int, classes: int, keys) -> dict:
    rng = np.random.default_rng(0)
    return {keys[0]: rng.standard_normal((b, size, size, 3))
            .astype(np.float32),
            keys[1]: rng.integers(0, classes, (b,)).astype(np.int32)}


def lm_opt():
    """The LM phases' optimizer (``bench.py:371``)."""
    from ray_tpu_torch.train import adamw
    return adamw(3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _barrier(dev):
    """A barrier of the whole world; on NCCL it names this rank's card,
    which the group would otherwise guess."""
    if dev.type == "cuda":
        dist.barrier(device_ids=[dev.index])
    else:
        dist.barrier()


def _to_device(batch: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def profile_nccl(fn: Callable, dev) -> dict | None:
    """Device time of one call of ``fn`` under ``torch.profiler``: the
    kernels' busy time and each NCCL kernel's count and ms. None on the
    CPU and when the profiler records no device time ("not measured")."""
    if dev.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # Kineto keeps only the device records inside its window on the
        # host's clock: wait on each side of the call.
        time.sleep(0.1)
        fn()
        _sync(dev)
        time.sleep(0.1)
    rows = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0))
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = [r for r in rows if r[2] > 0]
    busy = sum(r[2] for r in rows) / 1e3
    if busy == 0:
        return None
    nccl = {key[:60]: [count, us / 1e3] for key, count, us in rows
            if "nccl" in key.lower()}
    return {"busy_ms": busy, "nccl_ms": sum(v[1] for v in nccl.values()),
            "nccl": nccl}


def _launches() -> dict:
    from ray_tpu_torch.ops.cuda import flash_attention as fa
    return {k: v for k, v in fa.launch_counts().items() if v}


def run_steps(model, loss_fn, opt, batch, mesh, steps: int, timed: int,
              has_extra: bool = False) -> dict:
    """``steps`` steps of ``make_train_step`` on ``batch`` (device tensors)
    from ``model``'s weights, placed on ``mesh`` (None: off any mesh),
    then ``timed`` timed steps and one profiled step. Peak memory is over
    the whole run, above what the card held when it began."""
    from ray_tpu_torch.ops.cuda import flash_attention as fa
    from ray_tpu_torch.train import (buffers_donated, compile_count,
                                     init_train_state, make_train_step)
    dev = batch[next(iter(batch))].device
    _sync(dev)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = init_train_state(model, opt, mesh=mesh, extra=(
        model.batch_stats() if has_extra else None))
    step = make_train_step(loss_fn, opt, has_extra=has_extra)
    fa.reset_launch_counts()
    metrics = [step(state, batch)[1] for _ in range(steps)]
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    counts = _launches()
    stats = ({k: v.detach().clone() for k, v in state.extra.items()}
             if has_extra else None)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(timed):
        _, m = step(state, batch)
    if timed:
        float(m["loss"])
    step_ms = (time.perf_counter() - t0) / max(timed, 1) * 1e3
    prof = profile_nccl(lambda: step(state, batch), dev)
    out = {"losses": losses, "grad_norms": norms, "counts": counts,
           "step_ms": step_ms, "compile_count": compile_count(step),
           "donated": buffers_donated(step, state), "nccl": prof,
           "peak": (torch.cuda.max_memory_allocated(dev) - base
                    if dev.type == "cuda" else 0)}
    if has_extra:
        out["stats"] = stats
    return out


def step0_grads(model, loss_fn, batch, mesh) -> tuple[float, dict]:
    """The step-0 loss and every parameter's gradient, eagerly, reduced
    over the data axes as the train step reduces them (``train.step``)."""
    from ray_tpu_torch.train.step import _reduce
    named = list(model.named_parameters())
    for _, p in named:
        p.grad = None
    loss = loss_fn(model, batch)
    loss.backward()
    grads = [p.grad for _, p in named]
    loss = loss.detach()
    if mesh is not None:
        loss = _reduce(grads, loss, mesh)
    out = {n: g.detach().float().clone() for (n, _), g in zip(named, grads)
           if g is not None}
    for _, p in named:
        p.grad = None
    return float(loss), out


def layer_errors(got: dict, want: dict) -> dict[str, float]:
    """``||got - want|| / ||want||`` over each layer's gradients (``h.i``,
    else the parameter's first name)."""
    sq: dict[str, list[float]] = {}
    for name, w in want.items():
        parts = name.split(".")
        layer = ".".join(parts[:2]) if parts[0] == "h" else parts[0]
        d = float(torch.linalg.vector_norm(got[name] - w)) ** 2
        s = sq.setdefault(layer, [0.0, 0.0])
        s[0] += d
        s[1] += float(torch.linalg.vector_norm(w)) ** 2
    return {k: math.sqrt(d / max(r, 1e-30)) for k, (d, r) in sq.items()}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _free(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


class Refs:
    """The one-card, mesh-less references of one rank, each made once:
    ``run_steps`` and the step-0 loss and gradients of a model from seed
    0 on the global batch, on this rank's card."""

    def __init__(self, s: Scale, dev):
        self.s, self.dev = s, dev
        self._done: dict[str, dict] = {}

    def get(self, kind: str) -> dict:
        if kind not in self._done:
            self._done[kind] = self._make(kind)
            _free(self.dev)
        return self._done[kind]

    def _make(self, kind: str) -> dict:
        from ray_tpu_torch.models import (GPT2, Llama, MoETransformer,
                                          ResNet, ViT, llama_loss_fn,
                                          moe_loss_fn, resnet_loss_fn,
                                          vit_loss_fn)
        from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
        from ray_tpu_torch.train import adamw, sgd
        s, dev = self.s, self.dev
        if kind in ("gpt2", "llama", "moe"):
            cfg = {"gpt2": s.gpt2, "llama": s.llama, "moe": s.moe}[kind]()
            cls = {"gpt2": GPT2, "llama": Llama, "moe": MoETransformer}[kind]
            loss_fn = {"gpt2": gpt2_loss_fn, "llama": llama_loss_fn,
                       "moe": moe_loss_fn}[kind](ce_chunk=2048)
            b, t = s.llama_batch if kind == "llama" else s.lm_batch
            host = lm_batch(cfg.vocab_size, b, t)
            model = cls(cfg, seed=0, device=dev)
            batch = _to_device(host, dev)
            loss0, grads = step0_grads(model, loss_fn, batch, None)
            run = run_steps(model, loss_fn, lm_opt(), batch, None,
                            LLAMA_STEPS if kind == "llama" else STEPS, TIMED)
            run.update(loss0=loss0, grads=grads, items=b * t)
            return run
        cfg = (s.vit if kind == "vit" else s.resnet)()
        keys = ("images", "labels") if kind == "vit" else ("image", "label")
        host = image_batch(s.image_batch, s.image_size, cfg.num_classes, keys)
        if kind == "vit":
            model = ViT(cfg, seed=0, device=dev)
            run = run_steps(model, vit_loss_fn(), adamw(3e-3),
                            _to_device(host, dev), None, STEPS, TIMED)
        else:
            model = ResNet(cfg, seed=0, device=dev)
            run = run_steps(model, resnet_loss_fn(),
                            sgd(0.1, momentum=0.9, nesterov=True),
                            _to_device(host, dev), None, STEPS, TIMED,
                            has_extra=True)
        run["items"] = s.image_batch
        return run


# --- the cases ------------------------------------------------------------------

def _mesh_run(ctx, kind: str, axes: dict, seq_sharded: bool = False,
              attn_impl: str | None = None, grads: bool = False) -> dict:
    """``kind``'s model from seed 0 placed on a mesh of ``axes``, its
    steps on this rank's block of the global batch against the reference
    (losses, gradient norms; with ``grads`` every layer's step-0
    gradient)."""
    from ray_tpu_torch.models import (GPT2, Llama, MoETransformer, ResNet,
                                      ViT, llama_loss_fn, moe_loss_fn,
                                      resnet_loss_fn, vit_loss_fn)
    from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.sharding import place_params
    from ray_tpu_torch.train import adamw, sgd, shard_batch
    s, dev = ctx.s, ctx.dev
    ref = ctx.refs.get(kind)
    mesh = make_mesh(axes, device=dev.type)
    kw = {} if attn_impl is None else {"attn_impl": attn_impl}
    if kind in ("gpt2", "llama", "moe"):
        cfg = {"gpt2": s.gpt2, "llama": s.llama, "moe": s.moe}[kind](**kw)
        cls = {"gpt2": GPT2, "llama": Llama, "moe": MoETransformer}[kind]
        loss_fn = {"gpt2": gpt2_loss_fn, "llama": llama_loss_fn,
                   "moe": moe_loss_fn}[kind](ce_chunk=2048)
        b, t = s.llama_batch if kind == "llama" else s.lm_batch
        host = lm_batch(cfg.vocab_size, b, t)
        opt, has_extra = lm_opt(), False
        steps = LLAMA_STEPS if kind == "llama" else STEPS
    else:
        cfg = (s.vit if kind == "vit" else s.resnet)()
        cls = ViT if kind == "vit" else ResNet
        keys = ("images", "labels") if kind == "vit" else ("image", "label")
        host = image_batch(s.image_batch, s.image_size, cfg.num_classes, keys)
        loss_fn = vit_loss_fn() if kind == "vit" else resnet_loss_fn()
        opt = (adamw(3e-3) if kind == "vit"
               else sgd(0.1, momentum=0.9, nesterov=True))
        has_extra, steps = kind == "resnet", STEPS
    model = place_params(cls(cfg, seed=0, mesh=mesh), mesh)
    batch = shard_batch(host, mesh, seq_sharded=seq_sharded)
    out = {"axes": dict(axes)}
    if grads:
        loss0, g = step0_grads(model, loss_fn, batch, mesh)
        out["loss0"] = loss0
        out["loss0_rel"] = _rel(loss0, ref["loss0"])
        if kind == "moe":       # the experts are cut over ep
            out["layer_errors"] = {
                n: float(torch.linalg.vector_norm(g[n] - r)
                         / torch.linalg.vector_norm(r))
                for n, r in ref["grads"].items() if n.endswith("router")}
        else:
            out["layer_errors"] = layer_errors(g, ref["grads"])
        del g
    run = run_steps(model, loss_fn, opt, batch, mesh, steps, TIMED,
                    has_extra=has_extra)
    del model, batch
    _free(dev)
    run["step0_loss_rel"] = _rel(run["losses"][0], ref["losses"][0])
    run["step0_gnorm_rel"] = _rel(run["grad_norms"][0],
                                  ref["grad_norms"][0])
    run["loss_rel"] = max(_rel(a, b) for a, b in zip(run["losses"],
                                                     ref["losses"]))
    run["gnorm_rel"] = max(_rel(a, b) for a, b in zip(run["grad_norms"],
                                                      ref["grad_norms"]))
    if has_extra:
        run["stats_rel"] = max(
            float((v - ref["stats"][k]).abs().max()
                  / ref["stats"][k].abs().max().clamp_min(1e-30))
            for k, v in run.pop("stats").items())
    run["ref_losses"] = ref["losses"]
    run["ref_grad_norms"] = ref["grad_norms"]
    run["ref_step_ms"] = ref["step_ms"]
    run["ref_peak"] = ref["peak"]
    run["items"] = ref["items"]
    out.update(run)
    return out


def case_a(ctx) -> dict:
    return {"gpt2 dp": _mesh_run(ctx, "gpt2", {"dp": ctx.n})}


def case_b(ctx) -> dict:
    return {"llama fsdp": _mesh_run(ctx, "llama", {"fsdp": ctx.n})}


def case_c(ctx) -> dict:
    out = {"gpt2 sp ring": _mesh_run(ctx, "gpt2", {"sp": ctx.n},
                                     seq_sharded=True, attn_impl="ring",
                                     grads=True),
           "llama sp ulysses": _mesh_run(ctx, "llama", {"sp": ctx.n},
                                         seq_sharded=True,
                                         attn_impl="ulysses", grads=True)}
    out["rotations"] = ring_rotations(ctx)
    return out


def ring_rotations(ctx) -> dict | None:
    """The ring's rotations alone at GPT-2's layer shape on ``sp n`` (this
    rank's ``[B*H, T/n, D]`` block): one k, v hop (bf16) and one dk, dv
    rotation home (float32), each 10 times under the profiler."""
    from ray_tpu_torch.ops.attention import _Rotation
    from ray_tpu_torch.parallel.mesh import make_mesh
    dev = ctx.dev
    mesh = make_mesh({"sp": ctx.n}, device=dev.type)
    group = mesh.group("sp")
    cfg = ctx.s.gpt2()
    b, t = ctx.s.lm_batch
    shape = (b * cfg.n_head, t // ctx.n, cfg.head_dim)
    kv = [torch.randn(shape, device=dev).to(cfg.dtype) for _ in range(2)]
    dkv = [torch.randn(shape, device=dev) for _ in range(2)]
    out = {"shape": list(shape)}
    for name, tensors in (("kv", kv), ("dkv", dkv)):
        _Rotation(tensors, group).wait()          # the communicator exists
        prof = profile_nccl(lambda: [_Rotation(tensors, group).wait()
                                     for _ in range(10)], dev)
        out[name] = None if prof is None else prof["nccl_ms"] / 10
        out[f"{name}_bytes"] = sum(x.numel() * x.element_size()
                                   for x in tensors)
    return out


def case_d(ctx) -> dict:
    n = ctx.n
    return {f"{kind} {name}": _mesh_run(ctx, kind, axes)
            for kind in ("gpt2", "llama")
            for name, axes in (("dp x tp 2", {"dp": n // 2, "tp": 2}),
                               (f"tp {n}", {"tp": n}))}


def case_e(ctx) -> dict:
    n = ctx.n
    return {f"moe {name}": _mesh_run(ctx, "moe", axes, grads=True)
            for name, axes in (("dp x ep 2", {"dp": n // 2, "ep": 2}),
                               (f"ep {n}", {"ep": n}))}


def case_f(ctx) -> dict:
    """``spmd_pipeline`` over ``pp n``: GPT-2's blocks cut into n stages of
    consecutive blocks, PIPE_MICROBATCHES microbatches of the global batch,
    then ``ln_f`` and the chunked CE on every rank; against the plain block
    stack on the whole batch (this rank's card). Twice each, the second
    timed; then one stage on one microbatch alone, for the bubble."""
    from ray_tpu_torch.models import GPT2
    from ray_tpu_torch.models.gpt2 import chunked_cross_entropy
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.pipeline import spmd_pipeline
    s, dev, n = ctx.s, ctx.dev, ctx.n
    mesh = make_mesh({"pp": n}, device=dev.type)
    cfg = s.gpt2()
    b, t = s.lm_batch
    model = GPT2(cfg, seed=0, device=dev)
    batch = _to_device(lm_batch(cfg.vocab_size, b, t), dev)
    r = mesh.axis_index("pp")
    per = cfg.n_layer // n
    mine = list(model.h)[r * per:(r + 1) * per]
    dt = cfg.dtype

    def stack(blocks, x):
        for blk in blocks:
            x = blk(x, model.attn_fn)
        return x

    pipe = spmd_pipeline(stack, PIPE_MICROBATCHES, mesh=mesh)
    params = [p for blk in mine for p in blk.parameters()]

    def loss_and_grads(body):
        x = F.embedding(batch["tokens"], model.wte.weight.to(dt)) \
            + model.wpe.weight[:t].to(dt)
        loss = chunked_cross_entropy(model.ln_f(body(x)), model.wte.weight,
                                     batch["targets"])
        return float(loss.detach()), torch.autograd.grad(loss, params)

    from ray_tpu_torch.ops.cuda import flash_attention as fa
    out = {}
    for name, body in (("pipeline", lambda x: pipe(mine, x)),
                       ("whole", lambda x: stack(model.h, x))):
        for _ in range(2):
            fa.reset_launch_counts()
            _sync(dev)
            t0 = time.perf_counter()
            loss, grads = loss_and_grads(body)
            _sync(dev)
            out[name] = (loss, grads, (time.perf_counter() - t0) * 1e3,
                         _launches())
    prof = profile_nccl(lambda: loss_and_grads(lambda x: pipe(mine, x)), dev)
    # One stage on one microbatch, forward and backward: the work a rank
    # does for each microbatch that leaves the pipeline.
    x = torch.randn(b // PIPE_MICROBATCHES, t, cfg.n_embd, device=dev) \
        .to(dt).requires_grad_()
    for _ in range(2):
        _sync(dev)
        t0 = time.perf_counter()
        y = stack(mine, x)
        torch.autograd.grad(y.float().sum(), params)
        _sync(dev)
        stage_ms = (time.perf_counter() - t0) * 1e3
    lp, gp, ms, counts = out["pipeline"]
    lw, gw, whole_ms, _ = out["whole"]
    grad_rel = max(float(torch.linalg.vector_norm(a.float() - c.float())
                         / torch.linalg.vector_norm(c.float()))
                   for a, c in zip(gp, gw))
    useful = PIPE_MICROBATCHES * stage_ms
    return {"pipeline": {
        "stage": r, "blocks": [r * per, (r + 1) * per - 1],
        "loss": lp, "whole_loss": lw, "loss_rel": _rel(lp, lw),
        "grad_rel": grad_rel, "step_ms": ms, "whole_ms": whole_ms,
        "stage_ms": stage_ms, "bubble": 1 - useful / ms,
        "bubble_schedule": (n - 1) / (PIPE_MICROBATCHES + n - 1),
        "counts": counts, "nccl": prof, "items": b * t}}


def case_g(ctx) -> dict:
    from ray_tpu_torch.models.vit import seq_blocks
    n = ctx.n
    out = {f"{kind} dp x tp 2": _mesh_run(ctx, kind, {"dp": n // 2, "tp": 2})
           for kind in ("vit", "resnet")}
    sp = _mesh_run(ctx, "vit", {"sp": n})
    cfg = ctx.s.vit()
    _, lengths = seq_blocks(cfg.num_patches + 1, n)
    hops = STEPS * cfg.n_layer * sum(1 for t in lengths if t)
    sp["want_counts"] = {name: hops for name in (
        "flash_fwd_nc_rect", "flash_bwd_dq_nc_rect", "flash_bwd_dkv_nc_rect")}
    out[f"vit sp {n}"] = sp
    return out


def case_h(ctx) -> dict:
    """GPT-2 on ``tp n``: 2 steps, saved; restored into fresh states of
    other weights on ``dp n`` and off any mesh. Each rank compares its
    ``tp`` block of every parameter with the restored ones."""
    from ray_tpu_torch.models import GPT2
    from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.train import (init_train_state, make_train_step,
                                     shard_batch)
    from ray_tpu_torch.train.checkpoint import (restore_train_state,
                                                save_train_state)
    s, dev, n = ctx.s, ctx.dev, ctx.n
    cfg = s.gpt2()
    host = lm_batch(cfg.vocab_size, *s.lm_batch)
    directory = os.path.join(ctx.directory, "h")
    mesh = make_mesh({"tp": n}, device=dev.type)
    model = GPT2(cfg, seed=0, mesh=mesh)
    opt = lm_opt()
    state = init_train_state(model, opt, mesh=mesh)
    step = make_train_step(gpt2_loss_fn(ce_chunk=2048), opt)
    batch = shard_batch(host, mesh)
    for _ in range(2):
        step(state, batch)
    _sync(dev)
    t0 = time.perf_counter()
    save_train_state(state, directory)
    save_s = time.perf_counter() - t0
    saved = {name: p.detach().clone() for name, p in model.named_parameters()}
    placements = dict(model.placements)
    del model, state, step, batch
    out = {"save_s": save_s}
    for where, axes in ((f"dp {n}", {"dp": n}), ("one card", None)):
        m = None if axes is None else make_mesh(axes, device=dev.type)
        fresh = GPT2(cfg, seed=1, mesh=m, device=dev)
        st = init_train_state(fresh, lm_opt(), mesh=m)
        t0 = time.perf_counter()
        restore_train_state(directory, st)
        _sync(dev)
        load_s = time.perf_counter() - t0
        equal = all(torch.equal(placements[name].block(p.detach()),
                                saved[name])
                    for name, p in fresh.named_parameters())
        out[where] = {"equal": equal, "step": st.step, "restore_s": load_s}
        del fresh, st
    _free(dev)
    return out


CASE_FNS = {"a": case_a, "b": case_b, "c": case_c, "d": case_d,
            "e": case_e, "f": case_f, "g": case_g, "h": case_h}


@dataclass
class _Ctx:
    s: Scale
    dev: torch.device
    n: int
    refs: Refs
    directory: str


def rank_main(scale_name: str, cases: tuple, fault: str | None,
              directory: str) -> dict:
    """One rank's run of ``cases`` (see the module docstring)."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    if fault is not None:
        plant_fault(fault)
    rank = dist.get_rank()
    s = scale(scale_name)
    ctx = _Ctx(s, dev, dist.get_world_size(), Refs(s, dev), directory)
    cuda = dev.type == "cuda"
    out = {"card": {"rank": rank, "device": str(dev),
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "uuid": (str(torch.cuda.get_device_properties(dev).uuid)
                             if cuda else None),
                    "peer_access": ([torch.cuda.can_device_access_peer(
                        dev.index, j) for j in range(torch.cuda.device_count())
                        if j != dev.index] if cuda else None)},
           "seconds": {}}
    # A case that raises on every rank alike is reported and the next one
    # runs; a rank that does not finish a case within CASE_WAIT_S (stuck in
    # a collective that a failed rank left) fails the others' wait, and
    # ``spawn`` ends the world.
    store = dist.distributed_c10d._get_default_store()
    for name in cases:
        _barrier(dev)
        t0 = time.perf_counter()
        try:
            out[name] = CASE_FNS[name](ctx)
            _sync(dev)
        except Exception:  # noqa: BLE001 — reported per case
            out[name] = {"error": traceback.format_exc()}
        out["seconds"][name] = time.perf_counter() - t0
        store.set(f"multicard/{name}/{rank}", "done")
        store.wait([f"multicard/{name}/{r}" for r in range(ctx.n)],
                   datetime.timedelta(seconds=CASE_WAIT_S))
        if rank == 0:
            print(f"multicard: case {name} done in "
                  f"{out['seconds'][name]:.1f} s"
                  + (" (raised)" if "error" in out[name] else ""),
                  flush=True)
        _free(dev)
    _barrier(dev)
    return out


def run(n: int = 4, scale_name: str = "full", cases=CASES,
        fault: str | None = None, device=None,
        timeout: float = 1200.0) -> list[dict]:
    """Each rank's readings of ``cases`` over ``n`` ranks (NCCL, one card
    each, by default; gloo with ``device="cpu"``)."""
    from ray_tpu_torch.parallel.dryrun import spawn
    directory = tempfile.mkdtemp(prefix="multicard_")
    try:
        return spawn(rank_main, n, (scale_name, tuple(cases), fault,
                                    directory), device=device,
                     timeout=timeout)
    finally:
        shutil.rmtree(directory, ignore_errors=True)


# --- the checks --------------------------------------------------------------

def _runs(results: list[dict], case: str):
    """``(rank, name, run)`` for every mesh run of ``case``."""
    for r in results:
        for name, run in r.get(case, {}).items():
            if isinstance(run, dict) and "losses" in run:
                yield r["card"]["rank"], name, run


def checks(results: list[dict], captured: bool = True) -> list[tuple]:
    """``(what, ok, reading)`` for every check of the cases that ran.
    ``captured``: the card, where every route but FSDP2 and the pipeline
    must run as one CUDA graph (``compile_count`` 1)."""
    out = []
    cases = [c for c in CASES if c in results[0]]
    uuids = {r["card"]["uuid"] for r in results}
    out.append(("each rank on a card of its own",
                not captured or len(uuids) == len(results),
                f"{len(uuids)} distinct cards for {len(results)} ranks"))
    for case in cases:
        for r in results:
            if "error" in r[case]:
                out.append((f"({case}) rank {r['card']['rank']} ran the case",
                            False, r[case]["error"].strip().splitlines()[-1]))
    cases = [c for c in cases if not any("error" in r[c] for r in results)]
    for case in cases:
        for rank, name, run in _runs(results, case):
            where = f"({case}) {name}, rank {rank}"
            if name.startswith(("vit", "resnet")):
                limits = [("losses", "loss_rel", VISION_LOSS_RTOL),
                          ("gradient norms", "gnorm_rel", VISION_GNORM_RTOL)]
            else:
                tp = run["axes"].get("tp", 1) > 1
                limits = [("step-0 loss", "step0_loss_rel",
                           STEP0_TP_LOSS_RTOL if tp else STEP0_LOSS_RTOL),
                          ("step-0 gradient norm", "step0_gnorm_rel",
                           STEP0_GNORM_RTOL),
                          ("losses", "loss_rel", LOSS_RTOL),
                          ("gradient norms", "gnorm_rel", GNORM_RTOL)]
            for what, key, tol in limits:
                out.append((f"{where}: {what} within {tol} of the one-card "
                            "step's", run[key] <= tol, f"{run[key]:.3g}"))
            eager = "fsdp" in name
            want = None if (eager or not captured) else 1
            out.append((f"{where}: compile_count {want}"
                        + (" (FSDP2 runs eagerly by rule)" if eager else ""),
                        run["compile_count"] == want,
                        str(run["compile_count"])))
            if want == 1:
                out.append((f"{where}: buffers donated", run["donated"],
                            str(run["donated"])))
            if "layer_errors" in run:
                limit = (ROUTER_GRAD_RTOL if name.startswith("moe")
                         else LAYER_GRAD_RTOL)
                worst = max(run["layer_errors"].items(), key=lambda x: x[1])
                out.append((f"{where}: step-0 gradients of every "
                            f"{'router' if limit == ROUTER_GRAD_RTOL else 'layer'}"
                            f" within {limit}", worst[1] <= limit,
                            f"{worst[1]:.3g} ({worst[0]})"))
                out.append((f"{where}: eager step-0 loss within "
                            f"{STEP0_LOSS_RTOL}",
                            run["loss0_rel"] <= STEP0_LOSS_RTOL,
                            f"{run['loss0_rel']:.3g}"))
            if "want_counts" in run and captured:
                out.append((f"{where}: launches {run['want_counts']} and no "
                            "other kernel",
                            run["counts"] == run["want_counts"],
                            str(run["counts"])))
            if "stats_rel" in run:
                out.append((f"{where}: running statistics within "
                            f"{STATS_RTOL}", run["stats_rel"] <= STATS_RTOL,
                            f"{run['stats_rel']:.3g}"))
            if "fsdp" in name and captured:
                out.append((f"{where}: peak memory below the one-card "
                            "step's", run["peak"] < run["ref_peak"],
                            f"{run['peak']} vs {run['ref_peak']} B"))
    if "f" in cases:
        for r in results:
            p = r["f"]["pipeline"]
            where = f"(f) pipeline stage {p['stage']}"
            out.append((f"{where}: loss within {PIPE_LOSS_RTOL} of the whole "
                        "batch's", p["loss_rel"] <= PIPE_LOSS_RTOL,
                        f"{p['loss_rel']:.3g}"))
            out.append((f"{where}: block gradients within {PIPE_GRAD_RTOL}",
                        p["grad_rel"] <= PIPE_GRAD_RTOL,
                        f"{p['grad_rel']:.3g}"))
    if "h" in cases:
        for r in results:
            for where in [k for k in r["h"] if k != "save_s"]:
                h = r["h"][where]
                out.append((f"(h) restored from tp {len(results)} on "
                            f"{where}, rank {r['card']['rank']}: parameters "
                            "bit-equal, step 2",
                            h["equal"] and h["step"] == 2,
                            f"equal {h['equal']}, step {h['step']}"))
    return out


def nccl_summary(prof: dict | None) -> str:
    if prof is None:
        return "not measured"
    kernels = "; ".join(f"{k} x{c} {ms:.3f} ms"
                        for k, (c, ms) in sorted(prof["nccl"].items()))
    return (f"NCCL {prof['nccl_ms']:.3f} ms of {prof['busy_ms']:.3f} ms busy"
            f" ({kernels})")


def report(results: list[dict], n_cards: int) -> list[str]:
    """One line for each mesh run and rank: step ms and items/s per GPU
    beside the one-card step's, the NCCL kernels of one profiled step,
    the launch counts; the pipeline, the rotations, the checkpoint."""
    lines = []
    for r in results:
        c = r["card"]
        lines.append(f"rank {c['rank']}: {c['device']}, "
                     f"CUDA_VISIBLE_DEVICES={c['visible']}, uuid {c['uuid']}"
                     f", peer access to the other cards {c['peer_access']}"
                     f"; cases took " + ", ".join(
                         f"{k} {v:.1f} s" for k, v in r["seconds"].items()))
    for case in [c for c in CASES if c in results[0]]:
        if "error" in results[0][case]:
            lines.append(f"({case}) raised on rank 0:\n"
                         f"{results[0][case]['error']}")
        for rank, name, run in _runs(results, case):
            per_gpu = run["items"] / (run["step_ms"] / 1e3) / n_cards
            one = run["items"] / (run["ref_step_ms"] / 1e3)
            lines.append(
                f"({case}) {name} {run['axes']}, rank {rank}: losses "
                f"{run['losses']} vs one card {run['ref_losses']} (largest "
                f"relative difference {run['loss_rel']:.3g}, bit-equal "
                f"{run['losses'] == run['ref_losses']}); gradient norms "
                f"{run['grad_norms']} vs {run['ref_grad_norms']}; step "
                f"{run['step_ms']:.2f} ms, "
                f"{per_gpu:.1f} items/s per GPU vs one card "
                f"{run['ref_step_ms']:.2f} ms, {one:.1f} items/s; peak "
                f"{run['peak']} B (one card {run['ref_peak']} B); "
                f"compile_count {run['compile_count']}; one step: "
                f"{nccl_summary(run['nccl'])}; launches {run['counts']}"
                + (f"; worst layer gradients "
                   f"{sorted(run['layer_errors'].items(), key=lambda x: -x[1])[:3]}"
                   if "layer_errors" in run else ""))
    if "rotations" in results[0].get("c", {}):
        for r in results:
            rot = r["c"]["rotations"]
            lines.append(
                f"(c) ring rotations alone, rank {r['card']['rank']}, block "
                f"{rot['shape']}: k, v hop {rot['kv']} ms for "
                f"{rot['kv_bytes']} B; dk, dv rotation {rot['dkv']} ms for "
                f"{rot['dkv_bytes']} B (device time of the NCCL kernels)")
    if "pipeline" in results[0].get("f", {}):
        for r in results:
            p = r["f"]["pipeline"]
            lines.append(
                f"(f) pipeline pp {n_cards}, stage {p['stage']} (blocks "
                f"{p['blocks']}): loss {p['loss']} vs whole batch "
                f"{p['whole_loss']} (relative {p['loss_rel']:.3g}); block "
                f"gradients {p['grad_rel']:.3g}; forward+backward "
                f"{p['step_ms']:.2f} ms (whole stack on one card "
                f"{p['whole_ms']:.2f} ms); one stage on one microbatch "
                f"{p['stage_ms']:.2f} ms, so the bubble is "
                f"{p['bubble']:.1%} of the step (the schedule's "
                f"{p['bubble_schedule']:.1%}); {nccl_summary(p['nccl'])}; "
                f"launches {p['counts']}")
    if "save_s" in results[0].get("h", {}):
        for r in results:
            lines.append(f"(h) rank {r['card']['rank']}: {r['h']}")
    return lines
