#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --eager                 (every train step eager)
    python3 chip_smoke.py --plant-fault KERNEL    (any kernel of FAULTS)

Phases, each printed as it ends; any failed check raises and the script
exits non-zero without its result line:

1. Card: name and power limit from nvidia-smi.
2. Build: every CUDA kernel of ``ray_tpu_torch/ops/cuda/csrc`` with
   nvcc (one process per source, in parallel), with ptxas' register and
   spill counts and its notes (wgmma serialization).
3. Kernels: each square flash-attention kernel at GPT-2 small widths
   (H=12, D=64, bf16, causal), at T=1024 (the training shape, batch 32)
   and at T=2048 (batch 8), held against its plain PyTorch version on
   the same inputs by ``flash_attention.agreement`` (per element and
   overall, limits in ``AGREEMENT_TOL``), and timed with CUDA events
   beside its bound, the plain version and
   ``F.scaled_dot_product_attention`` on the same inputs (a yardstick
   only: the port never calls it).
4. Train: GPT-2 124M (``GPT2Config.small()``, random weights from seed
   0) on ``cuda:0`` at batch 32 and seq 1024. First, at step 0 on one
   batch: each layer's attention kernels, on the q, k, v and output
   gradient that layer gives them, are held against the plain versions
   by ``agreement``; the gradients of every layer's attention weights
   (the q, k and v thirds of ``qkv_kernel``, and ``proj_kernel``)
   through the kernels against those through the plain attention
   within GRAD_TOL; and the step-0 loss against the plain-attention,
   full-f32-logit path's within STEP0_LOSS_TOL. Then it trains through
   ``prefetch_to_device``
   and ``make_multi_train_step`` with ``adamw(3e-4, weight_decay=0.1,
   mu_dtype=bf16)`` on that batch, repeated. Checks: the loss is finite
   and falls; each kernel launched 12 times (one per layer) per step.
5. Bands: the band kernels of the causal split (``flash_fwd_rect``,
   ``flash_bwd_dq_rect``, ``flash_bwd_dkv_rect``) at B=32, T=1024, on
   every band of split 2 and split 4, read in place from the [BH, T, D]
   tensors, held against their plain versions by ``agreement`` and
   timed beside their bound, the plain version and SDPA with a
   bottom-right causal mask (``causal_lower_right``). The whole split
   (``RAY_TPU_FLASH_SPLIT``) is held against the unsplit kernels (o bit
   for bit, gradients by ``agreement``) and the plain whole attention,
   and timed beside the unsplit attention.
6. Split training: phase 4's model and batch with
   ``RAY_TPU_FLASH_SPLIT`` 2, then 4 (set for the phase, restored
   after). Checks: the band kernels on layers 0 and 11's own q, k, v and
   output gradient; the step-0 loss within STEP0_LOSS_TOL of phase 4's;
   the loss finite and falling; n_split x 12 launches per step of each
   band kernel and none of the square ones.
7. Remat: phase 4's model under each ``remat_policy``. Checks: the
   step-0 loss and every gradient match the model without remat
   (REMAT_LOSS_TOL, REMAT_GRAD_TOL); per layer per step 2 forward
   launches (1 under "everything") and 1 of each backward kernel; peak
   memory under "nothing" below phase 4's.
8. TinyLlama 1.1B (``LlamaConfig.tinyllama_1b()``, random weights from
   seed 0, 32 heads on 4 kv heads, D=64) at batch 8 and seq 2048, chunked
   CE with chunk 2048, trained and profiled as in phase 4. Checks: the
   kernels on layers 0, 11 and 21's own q, k, v and output gradient (all
   256 folded heads, the shape training gives them); the step-0 loss
   against the
   plain-attention, full-logit path's; the loss finite and falling; each
   square kernel launched 22 times per step.
9. ResNet-50 (``ResNet50Config()``, 1000 classes, random weights from
   seed 0) at batch 128, 224x224, bf16 in ``channels_last`` (cuDNN
   convolutions), ``sgd(0.1, momentum=0.9, nesterov=True)`` with the
   BatchNorm statistics through the step (``has_extra``), on images drawn
   on the card behind the prefetcher. Checks: the step-0 train-mode
   logits at batch 8 against the same weights' float32 forward on the
   CPU (RESNET_LOGIT_TOL); the loss finite and falling; every running
   mean and variance finite and moved, and an eval-mode forward that
   reads them; no flash kernel launched. Prints step ms, images/s, peak
   bytes, the input stall, one profiled dispatch (convolutions, products,
   reductions, the rest) and the share of the bf16 peak from the FLOPs of
   its products and convolutions.
10. ViT-B/16 (``ViTConfig.base()``, random weights from seed 0) at batch
   128, 224x224 (T = 197), ``adamw(3e-3)``. Checks: the square kernels
   with ``causal=False`` on layers 0 and 11's own q, k, v and output
   gradient (all 1536 folded heads) by ``agreement``; the step-0 loss
   against the plain attention within VIT_STEP0_LOSS_TOL; the loss
   finite and falling; 12 launches per step of each square kernel, none
   of the band routes. Prints the kernels' times at that shape beside their bound,
   plain versions and SDPA with no mask, and the run as for ResNet-50.

11. MoE (``MoEConfig()``: GPT-2 small widths, 12 layers, 8 experts in
   every 2nd block, capacity factor 2, 322 M parameters, random weights
   from seed 0) at batch 32 and seq 1024, ``adamw(3e-4,
   weight_decay=0.1, mu_dtype=bf16)`` and chunked CE. Checks: the square
   kernels on MoE layers 1 and 11's own q, k, v and output gradient; the
   step-0 loss against the plain attention within STEP0_LOSS_TOL; the
   aux losses finite; on the first MoE layer's own first 4096 tokens the
   index-form switch FFN against the one-hot einsum form (MOE_FORM_*);
   the loss falling; 12 launches per step of each square kernel, none of
   the bands. Prints step ms, tokens/s, FLOPs a step, the share of the
   bf16 peak, peak bytes, the busy share, and each MoE layer's dropped
   share and per-expert load at step 0 and at the end.

12. Mesh, on a one-rank NCCL group (``parallel.initialize``) and a mesh
   whose axes all have one rank. (a) GPT-2 124M at batch 32 x 1024 on
   ``dp = 1`` through ``init_train_state(mesh=)``, ``shard_batch`` and the
   captured step, the gradient all-reduce inside its graph. Checks: the
   first CAPTURE_STEPS losses against the mesh-less captured step's from
   the same weights (CAPTURE_LOSS_RTOL), ``compile_count`` 1 and buffers
   donated, 12 launches per kernel per step; step ms over
   MESH_TIMED_STEPS steps beside the mesh-less step's and phase 4's.
   (b) The same under FSDP2 (``fsdp = 1``, forced): parameters sharded,
   the step eager by rule (``compile_count`` None), the step-0 loss
   against (a)'s. (c) Ring attention's hops at ``sp = 4`` (RING_SP) at
   GPT-2's (B 32, T 1024, H 12) and TinyLlama's (B 8, T 2048, H 32)
   attention shapes, every rank's in this process through the functions
   ``ring_attention`` calls: o, lse, dq, dk and dv of the whole against
   the plain whole causal attention by ``agreement``, 1 + r launches of
   each kernel on rank r; the hops' summed kernel time beside the
   unsplit kernels'. (d) Ulysses over the ``sp`` group at world 1 equal
   to ``causal_attention`` bit for bit (output and gradients), and
   ``moe_ffn`` over the ``ep`` group within one bf16 unit of the one-hot
   einsum form at ``MoEConfig()``'s width on 4096 tokens. (e)
   ``dryrun_multichip(1)`` with no device named: one spawned NCCL rank on
   ``cuda:0`` takes a GPT-2 tiny train step (head dim 64) through the
   kernels, a finite loss.

Every train phase trains through the captured step (one CUDA graph,
replayed; ``train.step``) and checks that it was captured once
(``compile_count`` 1 after warm-up and after the timed dispatches) and
updated the state in place (``buffers_donated``); its profiled dispatch
cross-checks the launch counters against the flash kernels the profiler
sees in the replay. GPT-2 and ResNet-50 also hold their first
CAPTURE_STEPS losses against the same step under ``disable_capture()``
from the same weights (CAPTURE_LOSS_RTOL).

Then it prints the ``kernels`` JSON line (the ViT run's non-causal
readings as entries with ``"causal": false``), the card line again, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero when no
GPU is visible, and when the package is not beside it.

``--plant-fault NAME`` shows what the checks read on a wrong kernel: it
builds a copy of kernel NAME's source (under the gitignored build
directory, never in the source tree) carrying the fault of FAULTS, binds
the wrapper to it, and prints what each check reads. Square kernels:
``flash_fwd`` and ``flash_bwd_dq`` mask every score of key tile 3 for
the last query tile (a dropped late key tile), ``flash_bwd_dkv`` masks
the last query tile for every key block but the diagonal one; the run
exits 0 only if the kernel check fails it at both shapes and the
per-layer check on some layer. Band kernels: the diagonal is misaligned
(row0 forced to 0, top left instead of bottom right); the run exits 0
only if the band check fails it on every band with tq < tk and the split
phase's per-layer check on some layer at both splits. Both print
whether the gradient check fails the fault too.

Each kernel line prints the kernel's time over SDPA's from the same run
(``kernel / library``), and each shape the host time of one wrapper
call (checks, tensor-map geometry and encoding, allocation, launch).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ray_tpu_torch.core.accelerator import default_device
from ray_tpu_torch.models import (
    GPT2,
    GPT2Config,
    Llama,
    LlamaConfig,
    MoEBlock,
    MoEConfig,
    MoETransformer,
    ResNet,
    ResNet50Config,
    ViT,
    ViTConfig,
    llama_loss_fn,
    moe_loss_fn,
    resnet_loss_fn,
    vit_loss_fn,
)
from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
from ray_tpu_torch.ops.attention import (
    causal_attention,
    ring_finish,
    ring_hop_backward,
    ring_hop_forward,
    ring_merge,
    ulysses_attention,
)
from ray_tpu_torch.ops.cuda import build
from ray_tpu_torch.ops.cuda import flash_attention as fa
from ray_tpu_torch.ops.moe import (
    capacity_for,
    dense_switch_ffn_reference,
    moe_ffn,
    top1_route,
)
from ray_tpu_torch.parallel import initialize, make_mesh
from ray_tpu_torch.parallel.dryrun import dryrun_multichip
from ray_tpu_torch.parallel.sharding import _place_fsdp2
from ray_tpu_torch.train import (
    adamw,
    buffers_donated,
    compile_count,
    disable_capture,
    init_train_state,
    make_multi_train_step,
    make_train_step,
    prefetch_to_device,
    sgd,
    shard_batch,
)

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core
# rate and HBM3 bandwidth, at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# lse is float32 in both versions: only summation order differs.
LSE_TOL = 1e-4
# ||g_kernels - g_plain|| / ||g_plain|| of each layer's q, k, v thirds of
# qkv_kernel and of proj_kernel at step 0. Both paths run the same bf16
# model and differ only where the kernels round o, dq, dk, dv to bf16
# differently from the plain version, but 12 bf16 layers at initial
# weights (near-uniform softmax, so ds is a small difference of near
# equal terms) grow that into ~2% on the last layers' q and k gradients
# (H100). This end-to-end check therefore only sees a fault that moves
# the gradients by more than that; the per-layer check holds each layer's
# attention tightly.
GRAD_TOL = 3.5e-2
# |step-0 loss (kernels, chunked CE) - step-0 loss (plain attention,
# full f32 logits)| on ~11 nats: the paths differ in where attention
# rounds to bf16 and in the order of the CE sums. At initial weights the
# loss barely depends on attention; this check holds the CE paths, the
# gradient check above holds attention.
STEP0_LOSS_TOL = 1e-3
# The same for ViT-B/16 (kernels against plain attention, on ~7.4 nats):
# its loss is the mean over 128 images, GPT-2's over 32,768 tokens, so
# the same per-item rounding differences leave ~16x more in the mean
# (9.2e-4 read on an H100). Attention that saw the wrong keys (a causal
# mask, say) would move the CLS token, and the loss, by far more.
VIT_STEP0_LOSS_TOL = 5e-3
# Remat against no remat, same weights and batch on the card: the
# recomputed forward repeats the same kernels and products, so the two
# agree to the last bit unless a library product picks another
# algorithm; a wrong recompute or a stale saved tensor moves them by
# orders of magnitude more.
REMAT_LOSS_TOL = 1e-5
REMAT_GRAD_TOL = 1e-3
# ||logits(bf16 model, card) - logits(float32 model, CPU)|| / ||logits||
# at step 0, train mode, same weights and images: every convolution rounds
# its output to bf16 (2^-9 relative) and BatchNorm renormalises it, so
# the paths drift apart by about a percent (1.2e-2 for ResNet-50 at 64x64
# on the CPU); a window shifted by uneven SAME padding, a wrong layout or
# statistics taken over the wrong axes move the logits by tens of percent.
RESNET_LOGIT_TOL = 5e-2
# The captured step against the same step run eagerly (disable_capture),
# from the same weights on the same batch, over its first CAPTURE_STEPS
# losses: the graph replays the kernels the eager step launches, on the
# same inputs, so only a library product that picks another algorithm
# inside a capture could move a loss, in its last places.
CAPTURE_LOSS_RTOL = 1e-6
CAPTURE_STEPS = 4
# The index-form switch FFN (scatter, gather) against the one-hot einsum
# form on one MoE layer's own tokens: each slot holds one token, so each
# einsum sums one nonzero term and only the rounding of the bf16 products
# may differ: the output within one bf16 unit of each element
# (2^-8 |y|, or 2^-133 where y is 0), the router gradient (float32 sums of
# those products) within 1e-3 relative norm.
MOE_FORM_Y_RTOL = 2.0 ** -8
MOE_FORM_GRAD_TOL = 1e-3

# A spin of the card (~50 ms at the H100's clock) queued ahead of each
# timed run, long enough for the host to queue every call of the run.
HOLD_CYCLES = 100_000_000

# False under --eager: every train phase runs its step eagerly
# (disable_capture) and expects no capture.
CAPTURE = True

H, D = 12, 64
SHAPES = ((32, 1024), (8, 2048))   # (batch, seq)
TRAIN_BATCH, TRAIN_SEQ = 32, 1024
SPLITS = (2, 4)
REMAT_POLICIES = ("nothing", "dots", "dots_no_batch", "everything")
SPLIT_CHECK_LAYERS = (0, 11)
LLAMA_BATCH, LLAMA_SEQ = 8, 2048
LLAMA_CHECK_LAYERS = (0, 11, 21)
IMAGE_SIZE = 224
RESNET_BATCH = 128                 # bench.py's ResNet-50 batch per chip
RESNET_CHECK_BATCH = 8             # step-0 logits against the CPU
VIT_BATCH = 128                    # DeiT's 1024 over 8 GPUs
VIT_CHECK_LAYERS = (0, 11)
MOE_CHECK_LAYERS = (1, 11)         # MoE blocks sit at odd layers
MOE_FORM_TOKENS = 4096             # where the [T, E, C] one-hot fits
K_STEPS = 2                        # optimizer steps per dispatch
TIMED_DISPATCHES = 3
SHORT_TIMED_DISPATCHES = 2         # split, remat and TinyLlama phases
MESH_TIMED_STEPS = 4               # single steps timed in the mesh phase
RING_SP = 4                        # ranks of the ring whose hops run here
RING_SHAPES = ((32, 1024, 12), (8, 2048, 32))  # GPT-2 small, TinyLlama

SQUARE = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
BAND = ("flash_fwd_rect", "flash_bwd_dq_rect", "flash_bwd_dkv_rect")
WRAPPERS = {"flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
            "flash_bwd_dkv": fa.flash_bwd_dkv,
            "flash_fwd_rect": fa.flash_fwd_rect,
            "flash_bwd_dq_rect": fa.flash_bwd_dq_rect,
            "flash_bwd_dkv_rect": fa.flash_bwd_dkv_rect}
_CSRC = "ray_tpu_torch/ops/cuda/csrc"
SOURCES = {name: f"{_CSRC}/{fa._KERNELS[name].source}.cu"
           for name in SQUARE + BAND}
# The TPU kernel each replaces on the training path (T=1024 runs the
# single-block Pallas kernels; T=2048, TinyLlama's, the streaming ones,
# :77/:218/:255; the split runs the band kernels).
_PALLAS = "ray_tpu/ops/pallas/flash_attention.py"
REPLACES = {
    "flash_fwd": f"{_PALLAS}:122",
    "flash_bwd_dq": f"{_PALLAS}:296",
    "flash_bwd_dkv": f"{_PALLAS}:296",
    "flash_fwd_rect": f"{_PALLAS}:418",
    "flash_bwd_dq_rect": f"{_PALLAS}:436",
    "flash_bwd_dkv_rect": f"{_PALLAS}:436",
}
# --plant-fault: (text of the source, the same text with the fault). The
# forward and dq drop key tile 3 of the last query tile (every score
# masked); dk/dv drops the last query tile for every key block but the
# diagonal one (every p masked); the band faults misalign the diagonal
# (row0 = 0, top left instead of bottom right). Each keeps the kernel's
# barrier protocol intact (every tile is still loaded and consumed), so a
# fault changes values and never hangs the card.
_FWD_MASK = ("    bool masked = min(a.tk, a.causal ? a.row0 + wrow0 + 1 : a.tk) - k0"
             " < kFwdBK;\n")
_DQ_MASK = ("      bool masked = min(a.tk, a.causal ? a.row0 + wrow0 + 1 : a.tk) - k0"
            " < kBK;\n")
_DKV_QEND = "    int q_end = a.tq;\n"
_ARGS_ROW0 = "  args.row0 = row0;"
FAULTS = {
    "flash_fwd": (_FWD_MASK, _FWD_MASK + "    if (j == 3 && q0 + kFwdBQ >= a.tq)"
                  " masked = true, lim[0] = lim[1] = 0;\n"),
    "flash_bwd_dq": (_DQ_MASK, _DQ_MASK + "      if (j == 3 && q0 + kDqBQ >= a.tq)"
                     " masked = true, lim[0] = lim[1] = 0;\n"),
    "flash_bwd_dkv": (_DKV_QEND, _DKV_QEND
                      + "    if (iq == n_qt - 1 && iq != first) q_end = 0;\n"),
    "flash_fwd_rect": (_ARGS_ROW0, "  args.row0 = 0;"),
    "flash_bwd_dq_rect": (_ARGS_ROW0, "  args.row0 = 0;"),
    "flash_bwd_dkv_rect": (_ARGS_ROW0, "  args.row0 = 0;"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ptxas_usage(log: str) -> str:
    """'bf16 D=64: 96 registers, 0 B spilled; ...' from ptxas -v output,
    with ptxas' numbered notes after it (wgmma serialization, setmaxnreg)."""
    out = []
    for fn, body in re.findall(r"Compiling entry function '(\S+)'(.*?)"
                               r"(?=Compiling entry function|\Z)", log, re.S):
        dtype = "fp16" if "__half" in fn else "bf16"
        d = re.search(r"Li(\d+)E", fn).group(1)
        regs = re.search(r"Used (\d+) registers", body).group(1)
        spill = re.search(r"(\d+) bytes spill stores", body).group(1)
        out.append(f"{dtype} D={d}: {regs} registers, {spill} B spilled")
    notes = sorted({re.sub(r"(around line \d+ )|( in the function)?( in "
                             r"function)? '\S+'", "", w).strip()
                    for w in re.findall(r"ptxas \w+\s*: (\(C\d+\) .*)", log)})
    return "; ".join(sorted(out)) + "".join(f"; ptxas {w}" for w in notes)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls. The
    calls queue behind a hold of HOLD_CYCLES, so the card runs them back
    to back and the events read device time, not the rate at which the
    host issues calls (which bounds the small bands)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 50) -> float:
    """Mean host time (us) of issuing ``fn`` ``iters`` times back to back:
    the wrapper's checks, tensor-map geometry and encoding, allocation and
    launch. The device runs behind and is waited for after the clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


@contextlib.contextmanager
def flash_split(n: int):
    """``RAY_TPU_FLASH_SPLIT=n`` (unset for 0) inside the block, restored
    after."""
    old = os.environ.get("RAY_TPU_FLASH_SPLIT")
    if n:
        os.environ["RAY_TPU_FLASH_SPLIT"] = str(n)
    else:
        os.environ.pop("RAY_TPU_FLASH_SPLIT", None)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("RAY_TPU_FLASH_SPLIT", None)
        else:
            os.environ["RAY_TPU_FLASH_SPLIT"] = old


def work(bh: int, tq: int, tk: int, causal: bool = True
         ) -> dict[str, tuple[float, float]]:
    """{kernel: (tensor-core FLOPs, bytes)} of each kernel on q [BH, tq,
    D] against k, v [BH, tk, D] with the causal diagonal bottom-right
    aligned: each input read once, each output written once, and the
    tq * (tk - tq) + tq (tq + 1) / 2 causal pairs this input needs (all
    tq * tk pairs when not ``causal``). ``flash_bwd`` is the backward as
    one function (what the TPU's fused kernels compute): 5 products, where
    the dq and dkv kernels together do 7."""
    pairs = tq * (tk - tq) + tq * (tq + 1) / 2 if causal else tq * tk
    mm = 2.0 * bh * pairs * D                    # one causal product
    row = bh * D * 2                             # one bf16 row of BH heads
    stats = bh * tq * 4                          # one f32 [BH, tq]
    return {
        "flash_fwd": (2 * mm, row * (2 * tq + 2 * tk) + stats),
        "flash_bwd_dq": (3 * mm, row * (3 * tq + 2 * tk) + 2 * stats),
        "flash_bwd_dkv": (4 * mm, row * (2 * tq + 4 * tk) + 2 * stats),
        "flash_bwd": (5 * mm, row * (3 * tq + 4 * tk) + 2 * stats),
    }


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) for this work and what bounds it: the larger of its
    FLOPs over the bf16 peak and its bytes over the memory rate."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bounds(bh: int, tq: int, tk: int, causal: bool = True
           ) -> dict[str, tuple[float, str]]:
    return {name: bound(*w) for name, w in work(bh, tq, tk, causal).items()}


def kernel_inputs(b: int, t: int, dev):
    gen = torch.Generator(device=dev).manual_seed(t)
    q, k, v, do = (torch.randn(b * H, t, D, device=dev, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    return q, k, v, do


def kernel_readings(q, k, v, do, band: bool = False,
                    causal: bool = True) -> dict[str, dict]:
    """Each kernel's outputs held against its plain version's on the same
    inputs: {kernel: {output: fa.agreement(...)}}, lse beside. The square
    kernels on ``[BH, T, D]`` inputs (``causal`` or not), or (``band``)
    the band kernels on q, do ``[BH, tq, D]`` and k, v ``[BH, tk, D]``."""
    fwd, dq_k, dkv_k = BAND if band else SQUARE
    route = () if band else (causal,)
    scale = D ** -0.5
    o, lse = WRAPPERS[fwd](q, k, v, scale, *route)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, scale, causal)
    # The backward kernels take the plain lse and delta, so each is held
    # against its own plain version alone.
    delta = (o_ref.float() * do.float()).sum(-1)
    bwd = (q, k, v, do, lse_ref, delta, scale)
    dq = WRAPPERS[dq_k](*bwd, *route)
    dq_ref = fa.flash_bwd_dq_reference(*bwd, causal)
    dk, dv = WRAPPERS[dkv_k](*bwd, *route)
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(*bwd, causal)
    torch.cuda.synchronize()
    out = {fwd: {"o": fa.agreement(o, o_ref)},
           dq_k: {"dq": fa.agreement(dq, dq_ref)},
           dkv_k: {"dk": fa.agreement(dk, dk_ref),
                   "dv": fa.agreement(dv, dv_ref)}}
    lse_err = float((lse - lse_ref).abs().max())
    out[fwd]["lse"] = {"max_abs_err": lse_err, "ok": lse_err < LSE_TOL}
    return out


def bands(q, k, v, do, n: int):
    """The n bands of the causal split of folded ``[BH, T, D]`` tensors,
    as views: (tq, tk, (q band, k prefix, v prefix, do band))."""
    s = q.shape[1] // n
    for r in range(n):
        lo, hi = r * s, (r + 1) * s
        yield s, hi, (q[:, lo:hi], k[:, :hi], v[:, :hi], do[:, lo:hi])


def worst(readings: list[dict[str, dict]]) -> dict[str, dict]:
    """The worst reading of each kernel output over several readings."""
    out: dict[str, dict] = {}
    for reading in readings:
        for name, outs in reading.items():
            for o_name, r in outs.items():
                cur = out.setdefault(name, {}).get(o_name)
                key = (not r["ok"], r.get("elem", 0.0), r["max_abs_err"])
                if cur is None or key > (not cur["ok"], cur.get("elem", 0.0),
                                         cur["max_abs_err"]):
                    out[name][o_name] = r
    return out


def describe(readings: dict[str, dict]) -> str:
    return "; ".join(
        f"{o_name} " + ", ".join(f"{key} {val:.4g}" for key, val in r.items()
                                 if key != "ok")
        + ("" if r["ok"] else " FAILS")
        for outs in readings.values() for o_name, r in outs.items())


def check_readings(readings: dict[str, dict], where: str) -> None:
    tol = fa.AGREEMENT_TOL[torch.bfloat16]
    for name, outs in readings.items():
        for o_name, r in outs.items():
            check(r["ok"], f"{name} {o_name} agrees with its plain version "
                  f"{where} (limits {tol}, lse {LSE_TOL}; got {r})")


def kernel_phase(b: int, t: int, dev) -> dict[str, dict]:
    q, k, v, do = kernel_inputs(b, t, dev)
    readings = kernel_readings(q, k, v, do)
    print(f"agreement B={b} T={t}: {describe(readings)}", flush=True)
    check_readings(readings, f"at B={b} T={t}")
    return kernel_times(b, q, k, v, do, readings, f"B={b} T={t} H={H}")


def kernel_times(b: int, q, k, v, do, readings, what: str,
                 causal: bool = True) -> dict[str, dict]:
    """The square kernels on ``[B*heads, T, D]`` inputs timed (CUDA events)
    beside their bounds, their plain versions and SDPA on the same inputs
    (forward, and its whole backward for the backward kernels), causal or
    not."""
    bh, t, _ = q.shape
    scale = D ** -0.5
    o, lse = fa.flash_fwd(q, k, v, scale, causal)
    delta = (o.float() * do.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, scale, causal)

    # The yardstick: one library call computing the same function.
    q4, k4, v4, do4 = (x.view(b, bh // b, t, D) for x in (q, k, v, do))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal), 20)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), do4, retain_graph=True), 20)

    times = {
        "flash_fwd": (
            cuda_ms(lambda: fa.flash_fwd(q, k, v, scale, causal), 20),
            cuda_ms(lambda: fa.flash_fwd_reference(q, k, v, scale, causal),
                    3, 1),
            lib_fwd),
        "flash_bwd_dq": (
            cuda_ms(lambda: fa.flash_bwd_dq(*bwd), 20),
            cuda_ms(lambda: fa.flash_bwd_dq_reference(*bwd), 3, 1),
            lib_bwd),
        "flash_bwd_dkv": (
            cuda_ms(lambda: fa.flash_bwd_dkv(*bwd), 20),
            cuda_ms(lambda: fa.flash_bwd_dkv_reference(*bwd), 3, 1),
            lib_bwd),
    }
    bnd = bounds(bh, t, t, causal)
    rows = {}
    for name, (ms, p_ms, l_ms) in times.items():
        err = max(r["max_abs_err"] for o_name, r in readings[name].items()
                  if o_name != "lse")
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": p_ms,
                      "bound_ms": bnd[name][0], "bound_by": bnd[name][1],
                      "library_ms": l_ms}
        print(f"kernel {name} {what} D={D} bf16 "
              f"{'causal' if causal else 'non-causal'}: "
              f"max abs err {err:.3g}, {ms:.4f} ms, "
              f"bound {bnd[name][0]:.4f} ms ({bnd[name][1]}), "
              f"plain {p_ms:.4f} ms, library {l_ms:.4f} ms, kernel / "
              f"library {ms / l_ms:.3f}x", flush=True)
    hosts = {name: host_us(fn) for name, fn in (
        ("flash_fwd", lambda: fa.flash_fwd(q, k, v, scale, causal)),
        ("flash_bwd_dq", lambda: fa.flash_bwd_dq(*bwd)),
        ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(*bwd)))}
    # The forward's parts: its tensor-map geometry in Python, and the C
    # entry point alone (three encodes and the launch).
    maps = fa._tensor_maps((q, fa._FWD_BOX_ROWS[0]), (k, fa._FWD_BOX_ROWS[1]),
                           (v, fa._FWD_BOX_ROWS[1]))
    c_fn = fa._KERNELS["flash_fwd"]._fn
    c_args = (maps, ctypes.c_void_p(o.data_ptr()),
              ctypes.c_void_p(lse.data_ptr()), bh, t, t, 0, D, scale,
              int(causal), 0,
              ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    geo_us = host_us(lambda: fa._tensor_maps(
        (q, fa._FWD_BOX_ROWS[0]), (k, fa._FWD_BOX_ROWS[1]),
        (v, fa._FWD_BOX_ROWS[1])))
    c_us = host_us(lambda: c_fn(*c_args))
    print(f"host per call {what}: " + ", ".join(
        f"{name} {us:.1f} us" for name, us in hosts.items())
        + f" (flash_fwd encodes 3 tensor maps, flash_bwd_dq and "
        f"flash_bwd_dkv 4; of flash_fwd's, the geometry {geo_us:.1f} us "
        f"and the C entry point, 3 encodes and the launch, {c_us:.1f} us)",
        flush=True)
    pair_ms = times["flash_bwd_dq"][0] + times["flash_bwd_dkv"][0]
    pair_plain = cuda_ms(lambda: fa.flash_bwd_reference(
        q, k, v, o, lse, do, scale, causal), 3, 1)
    print(f"kernel pair flash_bwd_dq+flash_bwd_dkv {what}: {pair_ms:.4f}"
          f" ms, bound of the backward as one function (5 products) "
          f"{bnd['flash_bwd'][0]:.4f} ms ({bnd['flash_bwd'][1]}), "
          f"{pair_ms / bnd['flash_bwd'][0]:.2f}x it; the split's 7 "
          f"products bound it at "
          f"{bnd['flash_bwd_dq'][0] + bnd['flash_bwd_dkv'][0]:.4f} ms; "
          f"plain whole backward {pair_plain:.4f} ms, library {lib_bwd:.4f} "
          f"ms", flush=True)
    return rows


def band_times(b: int, tq: int, tk: int, q, k, v, do, readings) -> dict:
    """One band's kernels timed (CUDA events) beside their bound, their
    plain versions and SDPA with a bottom-right causal mask on the same
    inputs (the library yardstick: forward for the forward kernel, its
    whole backward for the backward kernels)."""
    from torch.nn.attention.bias import causal_lower_right

    scale = D ** -0.5
    o, lse = fa.flash_fwd_rect(q, k, v, scale)
    delta = (o.float() * do.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, scale)
    mask = causal_lower_right(tq, tk)
    q4, do4 = (x.reshape(b, H, tq, D).contiguous() for x in (q, do))
    k4, v4 = (x.reshape(b, H, tk, D).contiguous() for x in (k, v))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask), 20)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), do4, retain_graph=True), 20)
    times = {
        "flash_fwd_rect": (
            cuda_ms(lambda: fa.flash_fwd_rect(q, k, v, scale), 20),
            cuda_ms(lambda: fa.flash_fwd_rect_reference(q, k, v, scale),
                    3, 1), lib_fwd),
        "flash_bwd_dq_rect": (
            cuda_ms(lambda: fa.flash_bwd_dq_rect(*bwd), 20),
            cuda_ms(lambda: fa.flash_bwd_dq_reference(*bwd, True), 3, 1),
            lib_bwd),
        "flash_bwd_dkv_rect": (
            cuda_ms(lambda: fa.flash_bwd_dkv_rect(*bwd), 20),
            cuda_ms(lambda: fa.flash_bwd_dkv_reference(*bwd, True), 3, 1),
            lib_bwd),
    }
    w = work(b * H, tq, tk)
    rows = {}
    for name, sq in zip(BAND, SQUARE):
        ms, p_ms, l_ms = times[name]
        err = max(r["max_abs_err"] for o_name, r in readings[name].items()
                  if o_name != "lse")
        flops, nbytes = w[sq]
        bnd_ms, bnd_by = bound(flops, nbytes)
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": p_ms,
                      "library_ms": l_ms, "flops": flops, "bytes": nbytes,
                      "bound_ms": bnd_ms, "bound_by": bnd_by}
        print(f"kernel {name} B={b} tq={tq} tk={tk} H={H} D={D} bf16: max "
              f"abs err {err:.3g}, {ms:.4f} ms, bound {bnd_ms:.4f} ms "
              f"({bnd_by}), plain {p_ms:.4f} ms, library {l_ms:.4f} ms, "
              f"kernel / library {ms / l_ms:.3f}x", flush=True)
    return rows


def split_composition(b: int, t: int, n: int, q, k, v, do,
                      kernel_ms: float) -> None:
    """The whole split on ``[B, T, H, D]`` through autograd against the
    unsplit kernels (o bit for bit, gradients by ``agreement``) and the
    plain whole attention, and its fwd+bwd time beside the unsplit one's
    and beside the sum of its band kernels' times."""
    def unfold(x):
        return x.view(b, H, t, D).transpose(1, 2)

    ins = [unfold(x).detach().requires_grad_() for x in (q, k, v)]
    do4 = unfold(do)
    results = {}
    for m in (n, 0):
        with flash_split(m):
            out = fa.flash_attention(*ins)
            grads = torch.autograd.grad(out, ins, do4)

            def step():
                torch.autograd.grad(fa.flash_attention(*ins), ins, do4)

            results[m] = (fold4(out.detach()), [fold4(g) for g in grads],
                          cuda_ms(step, 10))
    scale = D ** -0.5
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, scale, True)
    plain = (o_ref, *fa.flash_bwd_reference(q, k, v, o_ref, lse_ref, do,
                                            scale, True))
    got, whole = results[n], results[0]
    vs_whole = {name: fa.agreement(x, y) for name, x, y in zip(
        ("dq", "dk", "dv"), got[1], whole[1])}
    vs_plain = {name: fa.agreement(x, y) for name, x, y in zip(
        ("o", "dq", "dk", "dv"), (got[0], *got[1]), plain)}
    o_equal = torch.equal(got[0], whole[0])
    dq_equal = torch.equal(got[1][0], whole[1][0])
    print(f"split {n} B={b} T={t}: o equals the unsplit kernels' bit for "
          f"bit: {o_equal}; dq too: {dq_equal}; vs unsplit "
          f"{describe({'': vs_whole})}; vs plain {describe({'': vs_plain})}",
          flush=True)
    rest = got[2] - kernel_ms
    print(f"split {n} B={b} T={t} fwd+bwd through autograd: {got[2]:.4f} ms "
          f"(band kernels {kernel_ms:.4f} ms, the rest {rest:.4f} ms: folds, "
          f"delta, cat and the sum of band dk/dv into the prefix); unsplit "
          f"{whole[2]:.4f} ms", flush=True)
    check(o_equal, f"split {n}: o equals the unsplit kernels' bit for bit")
    check_readings({"split vs unsplit": vs_whole, "split vs plain": vs_plain},
                   f"for the whole split {n} at B={b} T={t}")


def band_phase(b: int, t: int, dev) -> dict[int, dict[str, dict]]:
    """Every band of split 2 and 4 at (b, t): agreement and times. Returns
    {n: {kernel: the sums over the n bands}} for the kernels line."""
    q, k, v, do = kernel_inputs(b, t, dev)
    sums = {}
    for n in SPLITS:
        per_band = []
        whole_bwd = [0.0, 0.0]      # the 5-product backward, over the bands
        for tq, tk, band in bands(q, k, v, do, n):
            readings = kernel_readings(*band, band=True)
            print(f"agreement split {n} band tq={tq} tk={tk}: "
                  f"{describe(readings)}", flush=True)
            check_readings(readings, f"on band tq={tq} tk={tk}")
            per_band.append(band_times(b, tq, tk, *band, readings))
            for j, x in enumerate(work(b * H, tq, tk)["flash_bwd"]):
                whole_bwd[j] += x
        total = {}
        for name in BAND:
            rows = [r[name] for r in per_band]
            flops = sum(r["flops"] for r in rows)
            nbytes = sum(r["bytes"] for r in rows)
            bnd_ms, bnd_by = bound(flops, nbytes)
            total[name] = {
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": bnd_ms, "bound_by": bnd_by,
                "library_ms": sum(r["library_ms"] for r in rows)}
            print(f"kernel {name} split {n} B={b} T={t}, all {n} bands: "
                  f"{total[name]['ms']:.4f} ms, bound {bnd_ms:.4f} ms "
                  f"({bnd_by}), plain {total[name]['plain_ms']:.4f} ms, "
                  f"library {total[name]['library_ms']:.4f} ms, kernel / "
                  f"library {total[name]['ms'] / total[name]['library_ms']:.3f}"
                  "x", flush=True)
        dq, dkv = total["flash_bwd_dq_rect"], total["flash_bwd_dkv_rect"]
        pair_ms = dq["ms"] + dkv["ms"]
        bwd_ms, bwd_by = bound(*whole_bwd)
        print(f"kernel pair flash_bwd_dq_rect+flash_bwd_dkv_rect split {n} "
              f"B={b} T={t}, all {n} bands: {pair_ms:.4f} ms, bound of the "
              f"band backward as one function (5 products, "
              f"_bwd_rect_kernel) {bwd_ms:.4f} ms ({bwd_by}), "
              f"{pair_ms / bwd_ms:.2f}x it; the dq and dkv kernels' 7 "
              f"products bound it at "
              f"{dq['bound_ms'] + dkv['bound_ms']:.4f} ms", flush=True)
        sums[n] = total
        split_composition(b, t, n, q, k, v, do,
                          sum(total[name]["ms"] for name in BAND))
    return sums


class PlainAttention(torch.autograd.Function):
    """Attention on [BH, T, D] through the plain versions, forward and
    backward, saving only what the kernels' Function saves."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal=True):
        o, lse = fa.flash_fwd_reference(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*fa.flash_bwd_reference(q, k, v, o, lse, do.contiguous(),
                                        ctx.scale, ctx.causal), None, None)


def fold4(x):
    """[B, T, H, D] -> contiguous [B*H, T, D], as the kernels take it."""
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d).contiguous()


def plain_attention(q, k, v, causal: bool = True):
    """Attention through the plain versions, on [B, T, H, D]."""
    b, t, h, d = q.shape
    o = PlainAttention.apply(fold4(q), fold4(k), fold4(v), d ** -0.5, causal)
    return o.view(b, h, t, d).transpose(1, 2)


def layer_inputs(model, loss, layers) -> dict[int, list]:
    """{layer: [q, k, v, do]} at step 0, folded ``[BH, T, D]``: the
    attention inputs and output gradient ``loss(model)`` gives each of
    ``layers``."""
    seen = {}
    kernel_attn = model.attn_fn
    calls = [0]

    def capture(q, k, v):
        i = calls[0]
        calls[0] += 1
        out = kernel_attn(q, k, v)
        if i in layers:
            seen[i] = [q.detach(), k.detach(), v.detach(), None]
            out.register_hook(lambda g, entry=seen[i]:
                              entry.__setitem__(3, g))
        return out

    model.attn_fn = capture
    try:
        torch.autograd.grad(loss(model), next(model.parameters()))
    finally:
        model.attn_fn = kernel_attn
    return {i: [fold4(x) for x in entry] for i, entry in sorted(seen.items())}


def layer_readings(model, batch, layers=None, n_split: int = 0
                   ) -> list[dict[str, dict]]:
    """Each GPT-2 layer's attention at step 0, on the q, k, v and output
    gradient the model gives it on ``batch``: :func:`kernel_readings` for
    each of ``layers`` (default all), in order; under ``n_split`` the
    band kernels on every band (the worst reading over the bands)."""
    layers = range(len(model.h)) if layers is None else layers
    captured = layer_inputs(
        model, lambda m: gpt2_loss_fn(ce_chunk=2048)(m, batch), set(layers))
    out = []
    for i, xs in captured.items():
        if n_split:
            readings = worst([kernel_readings(*band, band=True)
                              for _, _, band in bands(*xs, n_split)])
        else:
            readings = kernel_readings(*xs)
        out.append(readings)
        route = f" (split {n_split})" if n_split else ""
        print(f"agreement layer {i}{route}: {describe(readings)}", flush=True)
    return out


def attention_grad_readings(model, batch) -> dict[str, tuple[float, int]]:
    """{weight: (largest ||g_kernels - g_plain|| / ||g_plain|| over the
    layers, the layer)} for the q, k, v thirds of ``qkv_kernel`` and for
    ``proj_kernel``, at the model's weights on ``batch``."""
    loss_fn = gpt2_loss_fn(ce_chunk=2048)
    params = [p for blk in model.h
              for p in (blk.attn.qkv_kernel, blk.attn.proj_kernel)]
    kernel_attn = model.attn_fn
    grads = {}
    for name, attn in (("kernels", kernel_attn), ("plain", plain_attention)):
        model.attn_fn = attn
        grads[name] = torch.autograd.grad(loss_fn(model, batch), params)
    model.attn_fn = kernel_attn
    worst_rel = {}
    for i in range(len(model.h)):
        gk_qkv, gk_proj = grads["kernels"][2 * i: 2 * i + 2]
        gp_qkv, gp_proj = grads["plain"][2 * i: 2 * i + 2]
        pairs = {"q": (gk_qkv[:, 0], gp_qkv[:, 0]),
                 "k": (gk_qkv[:, 1], gp_qkv[:, 1]),
                 "v": (gk_qkv[:, 2], gp_qkv[:, 2]),
                 "proj": (gk_proj, gp_proj)}
        for w, (gk, gp) in pairs.items():
            rel = float(torch.linalg.vector_norm(gk - gp)
                        / torch.linalg.vector_norm(gp))
            if rel > worst_rel.get(w, (-1.0, 0))[0]:
                worst_rel[w] = (rel, i)
    print("attention grads vs plain (largest relative norm error over the "
          "layers, layer): " + ", ".join(
              f"{w} {r:.4g} (layer {i})" for w, (r, i) in worst_rel.items())
          + f"; limit {GRAD_TOL}", flush=True)
    return worst_rel


def step0_losses(model, batch, loss_fn=gpt2_loss_fn) -> tuple[float, float]:
    """Step-0 loss through the kernels and the chunked CE, and through
    the plain attention and full float32 logits, same weights and batch."""
    kernel_attn = model.attn_fn
    with torch.no_grad():
        loss_kernel = float(loss_fn()(model, batch))
        model.attn_fn = plain_attention
        loss_plain = float(loss_fn(fused_ce=False)(model, batch))
    model.attn_fn = kernel_attn
    print(f"train step-0 loss: kernels {loss_kernel:.6f}, plain "
          f"{loss_plain:.6f}, |diff| {abs(loss_kernel - loss_plain):.3g} "
          f"(limit {STEP0_LOSS_TOL})", flush=True)
    return loss_kernel, loss_plain


def train_batch(vocab: int, b: int = TRAIN_BATCH, t: int = TRAIN_SEQ):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, vocab, (b, t)).astype(np.int32)
    return toks, np.roll(toks, -1, 1)


def device_batch(toks, tgts, dev) -> dict:
    return {"tokens": torch.from_numpy(toks).to(dev),
            "targets": torch.from_numpy(tgts).to(dev)}


# Kernel-name markers of each device-time group of ``profile_dispatch``,
# matched in this order on the lower-cased name: cuDNN's convolutions
# (forward, data and weight gradients) before the products, since both
# may carry "gemm" or "xmma"; "reductions" are the row and column sums
# (BatchNorm's and LayerNorm's statistics, the loss); "other" is the
# elementwise work.
KERNEL_GROUPS = (
    ("flash kernels", ("rtt::flash",)),
    ("convolution", ("cudnn", "implicit_gemm", "fprop", "dgrad", "wgrad",
                     "convolution", "conv2d", "winograd", "nchwtonhwc",
                     "nhwctonchw")),
    ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("reductions", ("reduce", "norm")),
)


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, markers in KERNEL_GROUPS:
        if any(m in low for m in markers):
            return group
    return "other"


# The CUDA kernel behind each launch counter (both routes of a kernel run
# the same function).
KERNEL_NAMES = {"flash_fwd": "flash_fwd_kernel",
                "flash_bwd_dq": "flash_bwd_dq_kernel",
                "flash_bwd_dkv": "flash_bwd_dkv_kernel"}


def profile_dispatch(step, state, batch, card: str):
    """Run one dispatch (a replay of the captured step) under
    torch.profiler and print where the device time goes: the busy share of
    the wall time, the kernels with the most device time and every flash
    kernel. Cross-checks the launch counters against the flash kernels the
    profiler saw in the dispatch and fails where they differ. A profiler
    that records no device time prints "not measured" and fails nothing.
    Returns the state and the busy share (None when not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    fa.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # One small kernel, waited for, before the dispatch: an eager
        # dispatch's first kernels, issued while the profiler was still
        # starting, went unrecorded (4 of 96 band forwards in one run).
        torch.zeros(1, device=next(state.params.parameters()).device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    counted = fa.launch_counts()
    rows = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and getattr(e, "self_device_time_total", 0.0) > 0]
    busy_ms = sum(r[2] for r in rows) / 1e3
    if busy_ms == 0:
        print("profile: no device time recorded (not measured)", flush=True)
        return state, None
    seen = {name: sum(count for key, count, _ in rows if fn in key)
            for name, fn in KERNEL_NAMES.items()}
    want = {name: counted[name] + counted[f"{name}_rect"]
            for name in KERNEL_NAMES}
    print(f"profile: flash kernels the profiler saw in the replayed "
          f"dispatch {seen}; launch counters (both routes) {want}",
          flush=True)
    check(seen == want, "the launch counters match the flash kernels the "
          f"profiler saw in one replayed dispatch ({want} vs {seen})")
    groups = {"flash kernels": 0.0, "convolution": 0.0, "matmul": 0.0,
              "reductions": 0.0, "other": 0.0}
    for key, _, us in rows:
        groups[kernel_group(key)] += us
    print(f"profile: one dispatch of {K_STEPS} steps, wall {wall_ms:.2f} "
          f"ms, device busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}); "
          + ", ".join(f"{g} {us / 1e3:.2f} ms ({us / 1e3 / busy_ms:.1%})"
                      for g, us in groups.items())
          + f"; card {card}", flush=True)
    # The 12 kernels with the most device time, then the largest of each
    # group below them and the flash kernels.
    top = sorted(rows, key=lambda r: -r[2])
    shown = {kernel_group(r[0]) for r in top[:12]}
    below = []
    for r in top[12:]:
        group = kernel_group(r[0])
        if group == "flash kernels" or group not in shown:
            below.append(r)
            shown.add(group)
    for key, count, us in top[:12] + below:
        print(f"profile kernel {us / 1e3:9.3f} ms x{count:<5d} {key[:110]}",
              flush=True)
    return state, busy_ms / wall_ms


def lm_opt():
    """The LM phases' optimizer: ``adamw(3e-4, weight_decay=0.1,
    mu_dtype=bf16)`` (``bench.py:371``)."""
    return adamw(3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16)


def token_stack(toks, tgts) -> dict:
    """One batch repeated K_STEPS times: a host stack for the prefetcher."""
    return {"tokens": np.stack([toks] * K_STEPS),
            "targets": np.stack([tgts] * K_STEPS)}


def train_run(model, loss_fn, opt, stack, items: int, timed: int,
              profile_card: str | None = None, place=None,
              has_extra: bool = False) -> dict:
    """Train ``model`` on the repeated batch ``stack`` (K_STEPS steps a
    dispatch) through ``prefetch_to_device`` (placed by ``place`` when
    given) and ``make_multi_train_step`` with ``opt``, captured as a CUDA
    graph: one warm-up dispatch (the eager warm-up step, the capture and
    a replay), ``timed`` timed dispatches and, with ``profile_card``, one
    profiled dispatch (after the launch counts are read). Checks that the
    step was captured once and stayed so (``compile_count``) and that it
    updated the state in place (``buffers_donated``). ``items`` is what
    one step consumes (tokens or images). With ``has_extra`` the model's
    buffers are the step's ``extra``. Peak memory is over the whole
    run."""
    dev = next(model.parameters()).device
    state = init_train_state(model, opt, extra=(dict(model.named_buffers())
                                                if has_extra else None))
    step = make_multi_train_step(loss_fn, opt, has_extra=has_extra,
                                 grad_norm=False)
    n_dispatch = 1 + timed + (profile_card is not None)
    want_captures = 1 if CAPTURE else None
    busy = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with prefetch_to_device((stack for _ in range(n_dispatch)), dev,
                            place=place) as pf:
        fa.reset_launch_counts()
        state, metrics = step(state, next(pf))     # warm-up dispatch
        loss_warm = float(metrics["loss"])
        captures = compile_count(step)
        stall0 = pf.stall_s
        t0 = time.perf_counter()
        for _ in range(timed):
            state, metrics = step(state, next(pf))
        loss_final = float(metrics["loss"])        # waits for the device
        dt = time.perf_counter() - t0
        stall = pf.stall_s - stall0
        counts = fa.launch_counts()
        check(captures == want_captures
              and compile_count(step) == want_captures,
              f"the step was captured {want_captures} times, at warm-up, "
              f"and not again (compile_count {captures} after warm-up, "
              f"{compile_count(step)} after the timed dispatches)")
        if profile_card is not None:
            state, busy = profile_dispatch(step, state, next(pf),
                                           profile_card)
    n_steps = (1 + timed) * K_STEPS
    check(state.step == n_dispatch * K_STEPS, "every step ran")
    check(compile_count(step) == want_captures,
          f"compile_count stays {want_captures}")
    check(buffers_donated(step, state), "the step updated every parameter "
          "and optimizer-state tensor in place (buffers_donated)")
    check(np.isfinite(loss_final), "loss finite")
    return {"loss_warm": loss_warm, "loss_final": loss_final,
            "n_steps": n_steps, "counts": counts,
            "step_ms": dt / (timed * K_STEPS) * 1e3,
            "tok_s": items * timed * K_STEPS / dt, "busy": busy,
            "compile_count": compile_count(step),
            "peak": torch.cuda.max_memory_allocated(), "stall_ms": stall * 1e3}


def capture_vs_eager(make_model, loss_fn, make_opt, batch, what: str,
                     has_extra: bool = False) -> None:
    """The first CAPTURE_STEPS losses of the captured step against those of
    the same step under ``disable_capture()``, each from a fresh model of
    the same seed on ``batch``, repeated; within CAPTURE_LOSS_RTOL. Not
    under ``--eager``, which runs no capture."""
    if not CAPTURE:
        return
    losses = {}
    for captured in (True, False):
        model = make_model()
        opt = make_opt()
        state = init_train_state(model, opt, extra=(
            dict(model.named_buffers()) if has_extra else None))
        step = make_train_step(loss_fn, opt, has_extra=has_extra,
                               grad_norm=False)
        with contextlib.nullcontext() if captured else disable_capture():
            losses[captured] = [float(step(state, batch)[1]["loss"])
                                for _ in range(CAPTURE_STEPS)]
        check(compile_count(step) == (1 if captured else None),
              f"{what}: compile_count {compile_count(step)}")
        del model, opt, state, step
        torch.cuda.empty_cache()
    got, want = losses[True], losses[False]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"{what} captured vs eager, first {CAPTURE_STEPS} losses: captured "
          f"{got}, eager {want}; largest relative difference {rel:.3g} "
          f"(limit {CAPTURE_LOSS_RTOL}); bit-equal: {got == want}",
          flush=True)
    check(rel <= CAPTURE_LOSS_RTOL,
          f"{what}: the captured step's losses match the eager step's")


def check_counts(run: dict, per_step: dict[str, int], what: str) -> None:
    """Each kernel launched ``per_step[name]`` times per step (0 where not
    named) over the run's counted steps."""
    n = run["n_steps"]
    for name, got in run["counts"].items():
        want = per_step.get(name, 0)
        check(got == want * n, f"{what}: {name} launched {want} times per "
              f"step ({got} for {n} steps)")


def describe_run(what: str, run: dict, loss0: float, card: str,
                 unit: str = "tokens") -> str:
    busy = "not measured" if run["busy"] is None else f"{run['busy']:.1%}"
    return (f"train {what}, {run['n_steps']} steps: loss {loss0:.4f} -> "
            f"{run['loss_warm']:.4f} (step {K_STEPS}) -> "
            f"{run['loss_final']:.4f} (step {run['n_steps']}); step "
            f"{run['step_ms']:.2f} ms, {run['tok_s']:.1f} {unit}/s, peak "
            f"memory {run['peak']} B, input stall {run['stall_ms']:.3f} ms; "
            f"{'captured' if CAPTURE else 'eager'} step: compile_count "
            f"{run['compile_count']}, buffers donated, busy {busy} (one "
            f"profiled dispatch); "
            f"launches {run['counts']}; card {card}")


def train_phase(card: str) -> tuple[dict, float]:
    cfg = GPT2Config.small()
    model = GPT2(cfg, seed=0)                     # on the card by default
    dev = next(model.parameters()).device
    toks, tgts = train_batch(cfg.vocab_size)
    batch0 = device_batch(toks, tgts, dev)
    for i, readings in enumerate(layer_readings(model, batch0)):
        check_readings(readings, f"on layer {i}'s inputs")
    worst_rel = attention_grad_readings(model, batch0)
    for w, (rel, layer) in worst_rel.items():
        check(rel < GRAD_TOL, f"{w} gradient of layer {layer} within "
              f"{GRAD_TOL} of the plain path's (got {rel:.4g})")
    loss_kernel, loss_plain = step0_losses(model, batch0)
    check(np.isfinite(loss_kernel), "step-0 loss finite")
    check(abs(loss_kernel - loss_plain) < STEP0_LOSS_TOL,
          "step-0 loss matches the plain path")
    capture_vs_eager(lambda: GPT2(cfg, seed=0), gpt2_loss_fn(ce_chunk=2048),
                     lm_opt, batch0, "GPT-2 124M")
    del batch0

    run = train_run(model, gpt2_loss_fn(ce_chunk=2048), lm_opt(),
                    token_stack(toks, tgts), toks.size, TIMED_DISPATCHES,
                    profile_card=card)
    print(describe_run(f"GPT-2 124M B={TRAIN_BATCH} T={TRAIN_SEQ} bf16", run,
                       loss_kernel, card), flush=True)
    check(run["loss_final"] < run["loss_warm"] < loss_kernel,
          "loss falls on a repeated batch")
    check_counts(run, {name: cfg.n_layer for name in SQUARE},
                 "GPT-2 unsplit")
    return run, loss_kernel


def split_train_phase(n: int, loss_unsplit: float, card: str) -> dict:
    cfg = GPT2Config.small()
    model = GPT2(cfg, seed=0)
    dev = next(model.parameters()).device
    toks, tgts = train_batch(cfg.vocab_size)
    with flash_split(n):
        batch0 = device_batch(toks, tgts, dev)
        for i, readings in zip(SPLIT_CHECK_LAYERS, layer_readings(
                model, batch0, SPLIT_CHECK_LAYERS, n_split=n)):
            check_readings(readings, f"on layer {i}'s inputs, split {n}")
        with torch.no_grad():
            loss0 = float(gpt2_loss_fn(ce_chunk=2048)(model, batch0))
        print(f"train split {n} step-0 loss {loss0:.6f}, unsplit "
              f"{loss_unsplit:.6f}, |diff| {abs(loss0 - loss_unsplit):.3g} "
              f"(limit {STEP0_LOSS_TOL})", flush=True)
        check(abs(loss0 - loss_unsplit) < STEP0_LOSS_TOL,
              f"split {n} step-0 loss matches the unsplit run's")
        del batch0
        run = train_run(model, gpt2_loss_fn(ce_chunk=2048), lm_opt(),
                        token_stack(toks, tgts), toks.size,
                        SHORT_TIMED_DISPATCHES, profile_card=card)
    print(describe_run(f"GPT-2 124M split {n} B={TRAIN_BATCH} T={TRAIN_SEQ} "
                       "bf16", run, loss0, card), flush=True)
    check(run["loss_final"] < run["loss_warm"] < loss0,
          f"split {n}: loss falls on a repeated batch")
    check_counts(run, {name: n * cfg.n_layer for name in BAND},
                 f"GPT-2 split {n}")
    return run


def remat_phase(base_peak: int, card: str) -> dict[str, dict]:
    """Step-0 loss and gradients of each policy against no remat, then a
    short training run per policy."""
    toks, tgts = train_batch(GPT2Config.small().vocab_size)
    loss_fn = gpt2_loss_fn(ce_chunk=2048)

    def loss_and_grads(cfg):
        model = GPT2(cfg, seed=0)
        batch = device_batch(toks, tgts, next(model.parameters()).device)
        loss = loss_fn(model, batch)
        return float(loss), torch.autograd.grad(loss,
                                                list(model.parameters()))

    loss0, grads0 = loss_and_grads(GPT2Config.small())
    for policy in REMAT_POLICIES:
        loss, grads = loss_and_grads(GPT2Config.small(remat=True,
                                                      remat_policy=policy))
        rel = max(float(torch.linalg.vector_norm(g - g0)
                        / torch.linalg.vector_norm(g0))
                  for g, g0 in zip(grads, grads0))
        equal = sum(torch.equal(g, g0) for g, g0 in zip(grads, grads0))
        del grads
        print(f"remat {policy}: step-0 loss {loss:.6f} vs {loss0:.6f} "
              f"(|diff| {abs(loss - loss0):.3g}, limit {REMAT_LOSS_TOL}); "
              f"gradients: largest relative norm error {rel:.3g} (limit "
              f"{REMAT_GRAD_TOL}), {equal} of {len(grads0)} bit-equal",
              flush=True)
        check(abs(loss - loss0) <= REMAT_LOSS_TOL and rel <= REMAT_GRAD_TOL,
              f"remat {policy}: step-0 loss and gradients match no remat")
    del grads0
    torch.cuda.empty_cache()

    runs = {}
    for policy in REMAT_POLICIES:
        cfg = GPT2Config.small(remat=True, remat_policy=policy)
        run = train_run(GPT2(cfg, seed=0), loss_fn, lm_opt(),
                        token_stack(toks, tgts), toks.size,
                        SHORT_TIMED_DISPATCHES, profile_card=card)
        print(describe_run(f"GPT-2 124M remat {policy} B={TRAIN_BATCH} "
                           f"T={TRAIN_SEQ} bf16", run, loss0, card),
              flush=True)
        fwd = cfg.n_layer * (1 if policy == "everything" else 2)
        check_counts(run, {"flash_fwd": fwd, "flash_bwd_dq": cfg.n_layer,
                           "flash_bwd_dkv": cfg.n_layer}, f"remat {policy}")
        runs[policy] = run
        torch.cuda.empty_cache()
    print("remat peak memory (B): " + ", ".join(
        f"{p} {r['peak']}" for p, r in runs.items())
        + f"; no remat {base_peak}", flush=True)
    check(runs["nothing"]["peak"] < base_peak,
          "remat nothing: peak memory below the run without remat")
    return runs


def llama_phase(card: str) -> dict[str, dict]:
    cfg = LlamaConfig.tinyllama_1b()
    model = Llama(cfg, seed=0)
    dev = next(model.parameters()).device
    n_params = sum(p.numel() for p in model.parameters())
    toks, tgts = train_batch(cfg.vocab_size, LLAMA_BATCH, LLAMA_SEQ)
    batch0 = device_batch(toks, tgts, dev)
    captured = layer_inputs(
        model, lambda m: llama_loss_fn(ce_chunk=2048)(m, batch0),
        set(LLAMA_CHECK_LAYERS))
    readings = {}
    for i, xs in captured.items():
        readings[i] = kernel_readings(*xs)
        print(f"agreement TinyLlama layer {i}: {describe(readings[i])}",
              flush=True)
        check_readings(readings[i], f"on TinyLlama layer {i}'s inputs")
    # The kernels at TinyLlama's own shape, on its last layer's inputs.
    last = LLAMA_CHECK_LAYERS[-1]
    rows = kernel_times(LLAMA_BATCH, *captured[last], readings[last],
                        f"TinyLlama layer {last} B={LLAMA_BATCH} "
                        f"T={LLAMA_SEQ} H={cfg.n_head}")
    del captured
    torch.cuda.empty_cache()
    loss_kernel, loss_plain = step0_losses(model, batch0, llama_loss_fn)
    check(np.isfinite(loss_kernel), "TinyLlama step-0 loss finite")
    check(abs(loss_kernel - loss_plain) < STEP0_LOSS_TOL,
          "TinyLlama step-0 loss matches the plain path")
    del batch0
    torch.cuda.empty_cache()

    run = train_run(model, llama_loss_fn(ce_chunk=2048), lm_opt(),
                    token_stack(toks, tgts), toks.size,
                    SHORT_TIMED_DISPATCHES, profile_card=card)
    mfu = 6 * n_params * run["tok_s"] / PEAK_BF16_FLOPS
    print(describe_run(f"TinyLlama 1.1B ({n_params} params) B={LLAMA_BATCH} "
                       f"T={LLAMA_SEQ} bf16", run, loss_kernel, card)
          + f"; 6*N*tokens/s = {mfu:.4f} of the bf16 peak (attention FLOPs "
          "not counted)", flush=True)
    check(run["loss_final"] < run["loss_warm"] < loss_kernel,
          "TinyLlama: loss falls on a repeated batch")
    check_counts(run, {name: cfg.n_layer for name in SQUARE}, "TinyLlama")
    return rows


def image_place(size: int, classes: int, dev, keys=("image", "label")):
    """``place(seed)`` for ``prefetch_to_device``: one batch drawn on the
    card from ``seed`` (``[B, size, size, 3]`` float32 normal images,
    int32 labels) and repeated K_STEPS times as a ``[K_STEPS, ...]``
    stack. It runs on the prefetcher's side stream, so the next stack is
    drawn while a step runs (the on-device generator of ``bench.py``'s
    ResNet-50 lane, ``bench.py:566-594``)."""
    def place(batch_seed):
        b, seed = batch_seed
        gen = torch.Generator(device=dev).manual_seed(seed)
        image = torch.randn((b, size, size, 3), generator=gen, device=dev)
        label = torch.randint(0, classes, (b,), generator=gen, device=dev,
                              dtype=torch.int32)
        return {keys[0]: image.expand(K_STEPS, *image.shape),
                keys[1]: label.expand(K_STEPS, b)}
    return place


def flops_per_step(model, loss, batch) -> float:
    """FLOPs of one forward and backward of ``loss(model, batch)``, counted
    by ``torch.utils.flop_counter`` from the shapes of each product and
    convolution (the flash kernels are custom ops, which it does not
    count)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = loss(model, batch)
        out = out[0] if isinstance(out, tuple) else out
        torch.autograd.grad(out, [p for p in model.parameters()
                                  if p.requires_grad])
    return float(counter.get_total_flops())


def resnet_phase(card: str) -> dict:
    """ResNet-50 (``ResNet50Config()``, 1000 classes, random weights from
    seed 0) at batch 128, 224x224: step-0 logits against the float32 model
    on the CPU, then training with ``sgd(0.1, momentum=0.9,
    nesterov=True)`` and the BatchNorm statistics through the step
    (``bench.py:537-549``), on images drawn on the card behind the
    prefetcher."""
    cfg = ResNet50Config()
    model = ResNet(cfg, seed=0)
    dev = next(model.parameters()).device
    rng = np.random.default_rng(0)
    image = rng.standard_normal((RESNET_CHECK_BATCH, IMAGE_SIZE, IMAGE_SIZE,
                                 3)).astype(np.float32)
    # The float32 reference runs on the CPU, so TF32 cannot touch it.
    ref = ResNet(ResNet50Config(dtype=torch.float32), device="cpu", seed=0)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        got, _ = model(torch.from_numpy(image).to(dev), train=True)
        want, _ = ref(torch.from_numpy(image), train=True)
    del ref
    rel = float(torch.linalg.vector_norm(got.cpu() - want)
                / torch.linalg.vector_norm(want))
    print(f"ResNet-50 step-0 logits (train mode, B={RESNET_CHECK_BATCH}): "
          f"bf16 on the card vs float32 on the CPU, relative norm error "
          f"{rel:.4g} (limit {RESNET_LOGIT_TOL}), largest |diff| "
          f"{float((got.cpu() - want).abs().max()):.4g} of largest |logit| "
          f"{float(want.abs().max()):.4g}", flush=True)
    check(bool(torch.isfinite(got).all()) and rel < RESNET_LOGIT_TOL,
          "ResNet-50 step-0 logits match the float32 model on the CPU")

    place = image_place(IMAGE_SIZE, cfg.num_classes, dev)
    batch0 = {k: v[0] for k, v in place((RESNET_BATCH, 0)).items()}
    initial = {k: v.clone() for k, v in model.batch_stats().items()}
    with torch.no_grad():
        loss0 = float(resnet_loss_fn()(model, model.batch_stats(),
                                       batch0)[0])
    flops = flops_per_step(
        model, lambda m, b: resnet_loss_fn()(m, m.batch_stats(), b), batch0)
    capture_vs_eager(lambda: ResNet(cfg, seed=0), resnet_loss_fn(),
                     lambda: sgd(0.1, momentum=0.9, nesterov=True), batch0,
                     "ResNet-50", has_extra=True)
    del batch0
    torch.cuda.empty_cache()

    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True       # fixed shapes: autotune
    try:
        run = train_run(model, resnet_loss_fn(),
                        sgd(0.1, momentum=0.9, nesterov=True),
                        (RESNET_BATCH, 0), RESNET_BATCH,
                        SHORT_TIMED_DISPATCHES, profile_card=card,
                        place=place, has_extra=True)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    share = flops * run["tok_s"] / RESNET_BATCH / PEAK_BF16_FLOPS
    print(describe_run(f"ResNet-50 B={RESNET_BATCH} {IMAGE_SIZE}x"
                       f"{IMAGE_SIZE} bf16 channels_last, SGD-Nesterov",
                       run, loss0, card, unit="images")
          + f"; {flops:.4g} FLOPs a step (convolutions and the classifier, "
          f"forward and backward) = {share:.4f} of the bf16 peak", flush=True)
    check(run["loss_final"] < run["loss_warm"] < loss0,
          "ResNet-50: loss falls on a repeated batch")
    check_counts(run, {}, "ResNet-50 (no flash kernel)")

    stats = model.batch_stats()
    moved = [float((v != initial[k]).float().mean()) for k, v in stats.items()]
    print(f"ResNet-50 running statistics: {len(stats)} buffers, all finite: "
          f"{all(bool(torch.isfinite(v).all()) for v in stats.values())}; "
          f"share of entries moved from their initial value: least "
          f"{min(moved):.4f}, mean {sum(moved) / len(moved):.4f}", flush=True)
    check(all(bool(torch.isfinite(v).all()) for v in stats.values()),
          "ResNet-50 running statistics finite")
    check(all(not torch.equal(v, initial[k]) for k, v in stats.items()),
          "every ResNet-50 running statistic moved from its initial value")
    with torch.no_grad():
        x = torch.from_numpy(image).to(dev)
        eval_trained = model(x)
        eval_initial = model(x, batch_stats=initial)
    diff = float((eval_trained - eval_initial).abs().max())
    print(f"ResNet-50 eval mode (B={RESNET_CHECK_BATCH}): logits finite "
          f"{bool(torch.isfinite(eval_trained).all())}; largest change "
          f"against the initial statistics {diff:.4g}", flush=True)
    check(bool(torch.isfinite(eval_trained).all()) and diff > 0,
          "ResNet-50 eval mode reads the trained running statistics")
    return run


def vit_phase(card: str) -> tuple[dict, dict]:
    """ViT-B/16 (``ViTConfig.base()``, random weights from seed 0) at batch
    128, 224x224 (T = 197), ``adamw(3e-3)``: the kernels with
    ``causal=False`` on layers 0 and 11's own inputs and timed at that
    shape, the step-0 loss against the plain attention, then training."""
    cfg = ViTConfig.base()
    model = ViT(cfg, seed=0)
    dev = next(model.parameters()).device
    t = cfg.num_patches + 1
    place = image_place(cfg.image_size, cfg.num_classes, dev,
                        keys=("images", "labels"))
    batch0 = {k: v[0] for k, v in place((VIT_BATCH, 0)).items()}
    loss = vit_loss_fn()
    captured = layer_inputs(model, lambda m: loss(m, batch0),
                            set(VIT_CHECK_LAYERS))
    readings = {}
    for i, xs in captured.items():
        readings[i] = kernel_readings(*xs, causal=False)
        print(f"agreement ViT-B/16 layer {i} (non-causal, BH="
              f"{xs[0].shape[0]}, T={t}): {describe(readings[i])}",
              flush=True)
        check_readings(readings[i], f"on ViT-B/16 layer {i}'s inputs")
    last = VIT_CHECK_LAYERS[-1]
    rows = kernel_times(VIT_BATCH, *captured[last], readings[last],
                        f"ViT-B/16 layer {last} B={VIT_BATCH} T={t} "
                        f"H={cfg.n_head}", causal=False)
    del captured
    torch.cuda.empty_cache()

    kernel_attn = model.attn_fn
    with torch.no_grad():
        loss_kernel = float(loss(model, batch0))
        model.attn_fn = functools.partial(plain_attention, causal=False)
        loss_plain = float(loss(model, batch0))
    model.attn_fn = kernel_attn
    print(f"ViT-B/16 step-0 loss: kernels {loss_kernel:.6f}, plain "
          f"{loss_plain:.6f}, |diff| {abs(loss_kernel - loss_plain):.3g} "
          f"(limit {VIT_STEP0_LOSS_TOL})", flush=True)
    check(np.isfinite(loss_kernel)
          and abs(loss_kernel - loss_plain) < VIT_STEP0_LOSS_TOL,
          "ViT-B/16 step-0 loss matches the plain-attention path")
    flops = flops_per_step(model, loss, batch0)
    del batch0
    torch.cuda.empty_cache()

    run = train_run(model, loss, adamw(3e-3), (VIT_BATCH, 0), VIT_BATCH,
                    SHORT_TIMED_DISPATCHES, profile_card=card, place=place)
    share = flops * run["tok_s"] / VIT_BATCH / PEAK_BF16_FLOPS
    print(describe_run(f"ViT-B/16 B={VIT_BATCH} {cfg.image_size}x"
                       f"{cfg.image_size} (T={t}) bf16, adamw(3e-3)", run,
                       loss_kernel, card, unit="images")
          + f"; {flops:.4g} FLOPs a step in products and the patch "
          f"convolution (attention not counted) = {share:.4f} of the bf16 "
          "peak", flush=True)
    check(run["loss_final"] < run["loss_warm"] < loss_kernel,
          "ViT-B/16: loss falls on a repeated batch")
    check_counts(run, {name: cfg.n_layer for name in SQUARE}, "ViT-B/16")
    return rows, run


def moe_layer_inputs(model, batch) -> dict[int, torch.Tensor]:
    """{layer: the tokens ``[B·T, D]`` its SwitchFFN takes} of every MoE
    layer, at the model's weights on ``batch``."""
    seen = {}
    hooks = [blk.moe.register_forward_pre_hook(
        lambda m, args, i=i: seen.__setitem__(
            i, args[0].detach().reshape(-1, args[0].shape[-1])))
        for i, blk in enumerate(model.h) if isinstance(blk, MoEBlock)]
    try:
        with torch.no_grad():
            moe_loss_fn()(model, batch)
    finally:
        for hook in hooks:
            hook.remove()
    return dict(sorted(seen.items()))


def moe_routing(model, batch) -> str:
    """Each MoE layer's routing on ``batch``: the share of tokens dropped
    past capacity and each expert's share of the tokens (its load)."""
    cfg = model.config
    parts = []
    for i, x in moe_layer_inputs(model, batch).items():
        ffn = model.h[i].moe
        cap = capacity_for(x.shape[0], cfg.num_experts, cfg.capacity_factor)
        route = top1_route(x.float() @ ffn.router.float(), cfg.num_experts,
                           cap)
        load = torch.bincount(route.expert, minlength=cfg.num_experts)
        dropped = float((route.slot == cfg.num_experts * cap).float().mean())
        parts.append(f"layer {i} dropped {dropped:.4f}, load " + "/".join(
            f"{v:.3f}" for v in (load.float() / x.shape[0]).tolist()))
    return "; ".join(parts)


def moe_form_check(model, batch) -> None:
    """The index-form switch FFN (``moe_ffn``) against the one-hot einsum
    form (``dense_switch_ffn_reference``) on the first MOE_FORM_TOKENS
    tokens the first MoE layer takes, with that layer's weights: outputs,
    aux and router gradients."""
    cfg = model.config
    first, x = next(iter(moe_layer_inputs(model, batch).items()))
    x = x[:MOE_FORM_TOKENS]
    ffn = model.h[first].moe
    outs = {}
    for name, fn in (("index", moe_ffn), ("one-hot",
                                          dense_switch_ffn_reference)):
        router = ffn.router.detach().clone().requires_grad_()
        y, aux = fn(x, router, ffn.w_up.detach(), ffn.w_down.detach(),
                    capacity_factor=cfg.capacity_factor, dtype=cfg.dtype)
        grad, = torch.autograd.grad((y.float() ** 2).sum() + aux, router)
        outs[name] = (y.detach().float(), aux.detach(), grad)
    (y, aux, g), (y_ref, aux_ref, g_ref) = outs["index"], outs["one-hot"]
    y_ok = bool(((y - y_ref).abs()
                 <= MOE_FORM_Y_RTOL * y_ref.abs() + 2.0 ** -133).all())
    g_rel = float(torch.linalg.vector_norm(g - g_ref)
                  / torch.linalg.vector_norm(g_ref))
    print(f"MoE layer {first}, first {MOE_FORM_TOKENS} tokens: index form "
          f"vs one-hot einsum form: output bit-equal {torch.equal(y, y_ref)} "
          f"(largest |diff| {float((y - y_ref).abs().max()):.3g}, limit one "
          f"bf16 unit), aux {float(aux):.6f} vs {float(aux_ref):.6f}; router "
          f"gradient bit-equal {torch.equal(g, g_ref)}, relative norm error "
          f"{g_rel:.3g} (limit {MOE_FORM_GRAD_TOL})", flush=True)
    check(y_ok and abs(float(aux) - float(aux_ref)) <= 1e-6 * abs(
        float(aux_ref)) and g_rel <= MOE_FORM_GRAD_TOL,
        "the index-form switch FFN matches the one-hot einsum form")


def moe_phase(card: str) -> dict:
    """The switch-MoE transformer (``MoEConfig()``: GPT-2 small widths, 8
    experts every 2nd block, capacity factor 2, random weights from seed
    0) at batch 32 x 1024, ``adamw(3e-4, weight_decay=0.1,
    mu_dtype=bf16)`` and chunked CE, through the captured step."""
    cfg = MoEConfig()
    model = MoETransformer(cfg, seed=0)
    dev = next(model.parameters()).device
    n_params = sum(p.numel() for p in model.parameters())
    toks, tgts = train_batch(cfg.vocab_size)
    batch0 = device_batch(toks, tgts, dev)
    loss = moe_loss_fn(ce_chunk=2048)
    captured = layer_inputs(model, lambda m: loss(m, batch0),
                            set(MOE_CHECK_LAYERS))
    for i, xs in captured.items():
        readings = kernel_readings(*xs)
        print(f"agreement MoE layer {i}: {describe(readings)}", flush=True)
        check_readings(readings, f"on MoE layer {i}'s inputs")
    del captured
    loss_kernel, loss_plain = step0_losses(model, batch0, moe_loss_fn)
    check(np.isfinite(loss_kernel), "MoE step-0 loss finite")
    check(abs(loss_kernel - loss_plain) < STEP0_LOSS_TOL,
          "MoE step-0 loss matches the plain-attention path")
    with torch.no_grad():
        _, aux = model(batch0["tokens"], return_hidden=True)
    print(f"MoE step-0 aux losses per MoE layer {aux.tolist()}", flush=True)
    check(bool(torch.isfinite(aux).all()) and aux.numel() == cfg.n_layer // 2,
          "MoE aux losses finite, one per MoE layer")
    moe_form_check(model, batch0)
    routing0 = moe_routing(model, batch0)
    flops = flops_per_step(model, loss, batch0)
    torch.cuda.empty_cache()

    run = train_run(model, loss, lm_opt(), token_stack(toks, tgts), toks.size,
                    SHORT_TIMED_DISPATCHES, profile_card=card)
    share = flops * run["tok_s"] / toks.size / PEAK_BF16_FLOPS
    print(describe_run(f"MoE ({n_params} params, {cfg.num_experts} experts "
                       f"every {cfg.moe_every}nd block) B={TRAIN_BATCH} "
                       f"T={TRAIN_SEQ} bf16", run, loss_kernel, card)
          + f"; {flops:.4g} FLOPs a step in products (attention not "
          f"counted) = {share:.4f} of the bf16 peak", flush=True)
    print(f"MoE routing at step 0: {routing0}", flush=True)
    print(f"MoE routing after {run['n_steps'] + K_STEPS} steps: "
          f"{moe_routing(model, batch0)}", flush=True)
    check(run["loss_final"] < run["loss_warm"] < loss_kernel,
          "MoE: loss falls on a repeated batch")
    check_counts(run, {name: cfg.n_layer for name in SQUARE}, "MoE")
    return run


def mesh_train(mesh, fsdp2: bool, host_batch, what: str) -> dict:
    """GPT-2 124M from seed 0 with the LM optimizer through
    ``make_train_step``: off a mesh (``mesh`` None), or placed on ``mesh``
    by ``init_train_state`` (FSDP2 first where ``fsdp2``) with its batch
    from ``shard_batch``. CAPTURE_STEPS steps on the batch give the
    losses and the launch counts (counts set to 0 just before, read just
    after); MESH_TIMED_STEPS more are timed."""
    cfg = GPT2Config.small()
    model = GPT2(cfg, seed=0, mesh=mesh)
    dev = next(model.parameters()).device
    if fsdp2:
        _place_fsdp2(model, mesh)
    opt = lm_opt()
    state = init_train_state(model, opt, mesh=mesh)
    step = make_train_step(gpt2_loss_fn(ce_chunk=2048), opt, grad_norm=False)
    batch = (device_batch(*host_batch, dev) if mesh is None else
             shard_batch({"tokens": host_batch[0], "targets": host_batch[1]},
                         mesh))
    fa.reset_launch_counts()
    losses = [float(step(state, batch)[1]["loss"])
              for _ in range(CAPTURE_STEPS)]
    counts = fa.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_TIMED_STEPS):
        state, metrics = step(state, batch)
    float(metrics["loss"])
    dt = (time.perf_counter() - t0) / MESH_TIMED_STEPS
    params = list(model.parameters())
    run = {"losses": losses, "counts": counts, "step_ms": dt * 1e3,
           "tok_s": host_batch[0].size / dt,
           "compile_count": compile_count(step),
           "donated": buffers_donated(step, state),
           "sharded": sum(isinstance(p, DTensor) for p in params)}
    print(f"mesh {what}: {run['sharded']} of {len(params)} parameters "
          f"sharded by FSDP2; first {CAPTURE_STEPS} losses {losses}; step "
          f"{run['step_ms']:.2f} ms, {run['tok_s']:.1f} tokens/s over "
          f"{MESH_TIMED_STEPS} single steps; compile_count "
          f"{run['compile_count']} "
          f"({'captured' if run['compile_count'] else 'eager'}), buffers "
          f"donated {run['donated']}; launches {counts}", flush=True)
    del model, opt, state, step, batch
    torch.cuda.empty_cache()
    return run


def ring_check(b: int, t: int, h: int, dev, card: str) -> None:
    """All RING_SP ranks' hops of ring attention at ``[B*H, T, D]``, in this
    process, through the functions ``ring_attention`` calls: rank r's
    queries against each block src <= r (ring_hop_forward, ring_merge,
    ring_finish), then the backward hops with the merged lse
    (ring_hop_backward), the dk and dv of each block summed over the ranks
    that saw it. o, lse, dq, dk and dv of the whole are held against the
    plain whole causal attention by ``agreement``; each rank launches
    1 + r hops of each kernel. Then the ring's kernels, summed over the
    ranks' hops, are timed beside the unsplit kernels."""
    gen = torch.Generator(device=dev).manual_seed(t + h)
    q, k, v, do = (torch.randn(b * h, t, D, device=dev, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    scale = D ** -0.5
    s = t // RING_SP
    qs, ks, vs, dos = ([x[:, r * s:(r + 1) * s].contiguous()
                        for r in range(RING_SP)] for x in (q, k, v, do))
    outs, lses, deltas, dqs = [], [], [], []
    dks = [torch.zeros(b * h, s, D, device=dev) for _ in range(RING_SP)]
    dvs = [torch.zeros_like(x) for x in dks]
    for r in range(RING_SP):
        fa.reset_launch_counts()
        state = None
        for i in range(RING_SP):
            src = (r - i) % RING_SP
            part = ring_hop_forward(qs[r], ks[src], vs[src], src, r, scale)
            if part is not None:
                state = ring_merge(state, part)
        o_r, lse_r = ring_finish(state, q.dtype)
        delta = (o_r.float() * dos[r].float()).sum(-1)
        dq = torch.zeros(b * h, s, D, device=dev)
        for i in range(RING_SP):
            src = (r - i) % RING_SP
            part = ring_hop_backward(qs[r], ks[src], vs[src], dos[r], lse_r,
                                     delta, src, r, scale)
            if part is not None:
                dq += part[0].float()
                dks[src] += part[1].float()
                dvs[src] += part[2].float()
        counts = fa.launch_counts()
        check(all(counts[n] == r + 1 for n in SQUARE)
              and not any(counts[n] for n in BAND),
              f"ring rank {r}: {r + 1} launches of each square kernel "
              f"(got {counts})")
        outs.append(o_r)
        lses.append(lse_r)
        deltas.append(delta)
        dqs.append(dq.to(q.dtype))
    got = {"o": torch.cat(outs, 1), "dq": torch.cat(dqs, 1),
           "dk": torch.cat(dks, 1).to(q.dtype),
           "dv": torch.cat(dvs, 1).to(q.dtype)}
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, scale, True)
    dq_ref, dk_ref, dv_ref = fa.flash_bwd_reference(q, k, v, o_ref, lse_ref,
                                                    do, scale, True)
    want = {"o": o_ref, "dq": dq_ref, "dk": dk_ref, "dv": dv_ref}
    readings = {"ring": {n: fa.agreement(got[n], want[n]) for n in got}}
    lse_err = float((torch.cat(lses, 1) - lse_ref).abs().max())
    readings["ring"]["lse"] = {"max_abs_err": lse_err, "ok": lse_err < LSE_TOL}
    print(f"ring sp={RING_SP} B={b} T={t} H={h}: {describe(readings)}",
          flush=True)
    check_readings(readings, f"for the ring at B={b} T={t} H={h}")
    del o_ref, dq_ref, dk_ref, dv_ref, want
    torch.cuda.empty_cache()

    hops = [(r, src) for r in range(RING_SP) for src in range(r + 1)]
    lse_w, delta_w = torch.cat(lses, 1), torch.cat(deltas, 1)
    iters = 5
    ring = {
        "flash_fwd": lambda: [fa.flash_fwd(qs[r], ks[c], vs[c], scale, c == r)
                              for r, c in hops],
        "flash_bwd_dq": lambda: [
            fa.flash_bwd_dq(qs[r], ks[c], vs[c], dos[r], lses[r], deltas[r],
                            scale, c == r) for r, c in hops],
        "flash_bwd_dkv": lambda: [
            fa.flash_bwd_dkv(qs[r], ks[c], vs[c], dos[r], lses[r], deltas[r],
                             scale, c == r) for r, c in hops],
    }
    whole = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, scale, True),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse_w, delta_w,
                                                scale, True),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse_w, delta_w,
                                                  scale, True),
    }
    times = {n: (cuda_ms(ring[n], iters), cuda_ms(whole[n], iters))
             for n in SQUARE}
    total = [sum(t_[i] for t_ in times.values()) for i in (0, 1)]
    print(f"ring sp={RING_SP} B={b} T={t} H={h} kernel time, the "
          f"{len(hops)} hops of the {RING_SP} ranks summed vs the unsplit "
          f"kernel: " + "; ".join(f"{n} {a:.3f} ms vs {w:.3f} ms"
                                  for n, (a, w) in times.items())
          + f"; all {total[0]:.3f} ms vs {total[1]:.3f} ms "
          f"({total[0] / total[1]:.3f}x); card {card}", flush=True)


def exchange_check(mesh, dev) -> None:
    """The exchange ops at world 1: Ulysses (all_to_all over the mesh's
    ``sp`` group, then causal_attention) equal to causal_attention bit for
    bit, forward and gradients, at GPT-2's attention shape; ``moe_ffn``
    over the ``ep`` group equal to the one-hot einsum form within one bf16
    unit, at ``MoEConfig()``'s width on MOE_FORM_TOKENS tokens."""
    gen = torch.Generator(device=dev).manual_seed(7)
    shape = (TRAIN_BATCH, TRAIN_SEQ, H, D)
    q, k, v, dy = (torch.randn(shape, device=dev, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    outs = {}
    for name, fn in (("ulysses", functools.partial(ulysses_attention,
                                                   mesh=mesh)),
                     ("causal", causal_attention)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        y = fn(*leaves)
        y.backward(dy)
        outs[name] = [y.detach()] + [x.grad for x in leaves]
    same = [torch.equal(a, b) for a, b in zip(outs["ulysses"],
                                              outs["causal"])]
    print(f"Ulysses at world 1 vs causal_attention, B={TRAIN_BATCH} "
          f"T={TRAIN_SEQ} H={H}: bit-equal (out, dq, dk, dv) {same}",
          flush=True)
    check(all(same), "Ulysses at world 1 equals causal_attention bit for bit")

    cfg = MoEConfig()
    d, e = cfg.n_embd, cfg.num_experts
    x = torch.randn(MOE_FORM_TOKENS, d, device=dev, generator=gen) \
        .to(cfg.dtype)
    router, w_up, w_down = (
        torch.empty(shape_, device=dev).normal_(0.0, 0.02, generator=gen)
        for shape_ in ((d, e), (e, d, 4 * d), (e, 4 * d, d)))
    y, aux = moe_ffn(x, router, w_up, w_down, group=mesh.group("ep"),
                     capacity_factor=cfg.capacity_factor, dtype=cfg.dtype)
    y_ref, aux_ref = dense_switch_ffn_reference(
        x, router, w_up, w_down, capacity_factor=cfg.capacity_factor,
        dtype=cfg.dtype)
    y, y_ref = y.float(), y_ref.float()
    y_ok = bool(((y - y_ref).abs()
                 <= MOE_FORM_Y_RTOL * y_ref.abs() + 2.0 ** -133).all())
    print(f"moe_ffn over an ep group of 1 vs the one-hot einsum form, "
          f"{MOE_FORM_TOKENS} tokens x {d}, {e} experts: bit-equal "
          f"{torch.equal(y, y_ref)}, largest |diff| "
          f"{float((y - y_ref).abs().max()):.3g} (limit one bf16 unit), aux "
          f"{float(aux):.6f} vs {float(aux_ref):.6f}", flush=True)
    check(y_ok and abs(float(aux) - float(aux_ref))
          <= 1e-6 * abs(float(aux_ref)),
          "moe_ffn at ep = 1 matches the one-hot einsum form")


def mesh_phase(main_run: dict, card: str) -> None:
    """The port's mesh on one card: a one-rank NCCL group and a mesh with
    every axis of size 1. (a) GPT-2 124M on ``dp = 1`` through
    ``init_train_state(mesh=)``, ``shard_batch`` and the captured step,
    the gradient all-reduce inside the graph, against the same step off
    the mesh; (b) the same under FSDP2 (``fsdp = 1``); (c) ring attention's
    hops through the kernels at GPT-2's and TinyLlama's attention shapes;
    (d) Ulysses and ``moe_ffn`` over their groups at world 1; (e) the
    multi-rank dry run on its default device, one NCCL rank."""
    dev = initialize()
    mesh = make_mesh({"dp": 1})
    print(f"mesh: {mesh} over a {dist.get_backend()} group of "
          f"{dist.get_world_size()}", flush=True)
    host = train_batch(GPT2Config.small().vocab_size)
    plain = mesh_train(None, False, host, "off (mesh-less captured step)")
    dp = mesh_train(mesh, False, host, "dp=1 (gradient all-reduce in the "
                    "step)")
    rel = max(abs(a - b) / abs(b) for a, b in zip(dp["losses"],
                                                  plain["losses"]))
    overhead = dp["step_ms"] / plain["step_ms"] - 1
    over_phase4 = dp["step_ms"] / main_run["step_ms"] - 1
    print(f"mesh dp=1 vs mesh-less: first {CAPTURE_STEPS} losses bit-equal "
          f"{dp['losses'] == plain['losses']}, largest relative difference "
          f"{rel:.3g} (limit {CAPTURE_LOSS_RTOL}); step {dp['step_ms']:.2f} "
          f"ms vs {plain['step_ms']:.2f} ms ({overhead:+.2%}); phase 4's "
          f"step {main_run['step_ms']:.2f} ms, {main_run['tok_s']:.1f} "
          f"tokens/s (dp=1 {over_phase4:+.2%} over it); card {card}",
          flush=True)
    check(rel <= CAPTURE_LOSS_RTOL, "mesh dp=1: the first losses match the "
          "mesh-less step's")
    want_captures = 1 if CAPTURE else None
    check(dp["compile_count"] == want_captures and dp["donated"],
          f"mesh dp=1: captured {want_captures} time(s), buffers donated")
    n = GPT2Config.small().n_layer
    check_counts({"n_steps": CAPTURE_STEPS, "counts": dp["counts"]},
                 {name: n for name in SQUARE}, "mesh dp=1")

    fsdp = mesh_train(mesh, True, host, "fsdp=1 (FSDP2)")
    rel0 = abs(fsdp["losses"][0] - dp["losses"][0]) / abs(dp["losses"][0])
    print(f"mesh fsdp=1: step-0 loss {fsdp['losses'][0]} vs dp=1 "
          f"{dp['losses'][0]}, relative difference {rel0:.3g} (limit "
          f"{CAPTURE_LOSS_RTOL}); the step was "
          f"{'captured' if fsdp['compile_count'] else 'run eagerly'} "
          "(FSDP2 steps run eagerly by rule)", flush=True)
    check(rel0 <= CAPTURE_LOSS_RTOL, "mesh fsdp=1: step-0 loss matches dp=1")
    check(fsdp["sharded"] > 0 and fsdp["compile_count"] is None,
          "mesh fsdp=1: FSDP2 sharded parameters and compile_count is None "
          "(the FSDP2 step runs eagerly by rule)")
    check_counts({"n_steps": CAPTURE_STEPS, "counts": fsdp["counts"]},
                 {name: n for name in SQUARE}, "mesh fsdp=1")

    for b, t, h in RING_SHAPES:
        ring_check(b, t, h, dev, card)
    exchange_check(mesh, dev)
    dist.destroy_process_group()

    t0 = time.perf_counter()
    ranks = dryrun_multichip(1)
    print(f"mesh dryrun_multichip(1), no device named: {ranks} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(len(ranks) == 1 and ranks[0]["device"] == "cuda:0"
          and np.isfinite(ranks[0]["loss"]),
          "dryrun_multichip(1) runs one NCCL rank on the card by default")


def plant_fault(name: str) -> str:
    """Build kernel ``name``'s source with the fault of FAULTS, under the
    build directory, and bind that kernel's wrapper (and only it) to it.
    Returns the temporary directory, for the caller to remove."""
    old, new = FAULTS[name]
    kernel = fa._KERNELS[name]
    with open(build.sources()[kernel.source]) as f:
        src = f.read()
    check(src.count(old) == 1,
          f"the fault's anchor is in {kernel.source}.cu once")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="fault-", dir=build.BUILD_DIR)
    cu, lib = (os.path.join(tmp, f"{kernel.source}.cu"),
               os.path.join(tmp, "lib.so"))
    with open(cu, "w") as f:
        f.write(src.replace(old, new))
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.SRC_DIR,
                    "-o", lib, cu], check=True, capture_output=True,
                   timeout=600)
    fn = getattr(ctypes.CDLL(lib), kernel.symbol)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    kernel._fn = fn
    return tmp


def square_fault_result(name: str, dev) -> dict:
    def fails(readings):
        return not all(r["ok"] for r in readings[name].values())

    kernel_caught = []
    for b, t in SHAPES:
        readings = kernel_readings(*kernel_inputs(b, t, dev))
        print(f"agreement B={b} T={t}: {describe(readings)}", flush=True)
        kernel_caught.append(fails(readings))
    cfg = GPT2Config.small()
    model = GPT2(cfg, seed=0)
    batch0 = device_batch(*train_batch(cfg.vocab_size), dev)
    layer_caught = [fails(r) for r in layer_readings(model, batch0)]
    worst_rel = attention_grad_readings(model, batch0)
    loss_kernel, loss_plain = step0_losses(model, batch0)
    return {"fault": name, "kernel_check_fails_it": all(kernel_caught),
            "layer_check_fails_it_on_layers":
                [i for i, caught in enumerate(layer_caught) if caught],
            "grad_check_fails_it": any(rel >= GRAD_TOL
                                       for rel, _ in worst_rel.values()),
            "loss_check_fails_it":
                abs(loss_kernel - loss_plain) >= STEP0_LOSS_TOL,
            "caught": all(kernel_caught) and any(layer_caught)}


def band_fault_result(name: str, dev) -> dict:
    def fails(readings):
        return not all(r["ok"] for r in readings[name].values())

    q, k, v, do = kernel_inputs(TRAIN_BATCH, TRAIN_SEQ, dev)
    band_caught = {}
    for n in SPLITS:
        for tq, tk, band in bands(q, k, v, do, n):
            readings = kernel_readings(*band, band=True)
            print(f"agreement split {n} band tq={tq} tk={tk}: "
                  f"{describe(readings)}", flush=True)
            band_caught[f"{tq}x{tk}"] = fails(readings)
    cfg = GPT2Config.small()
    model = GPT2(cfg, seed=0)
    batch0 = device_batch(*train_batch(cfg.vocab_size), dev)
    layer_caught, grad_caught = {}, {}
    for n in SPLITS:
        with flash_split(n):
            readings = layer_readings(model, batch0, SPLIT_CHECK_LAYERS,
                                      n_split=n)
            worst_rel = attention_grad_readings(model, batch0)
        layer_caught[n] = [i for i, r in zip(SPLIT_CHECK_LAYERS, readings)
                           if fails(r)]
        grad_caught[n] = any(rel >= GRAD_TOL for rel, _ in worst_rel.values())
    rect = [key for key in band_caught
            if int(key.split("x")[0]) < int(key.split("x")[1])]
    return {"fault": name, "band_check_fails_it_on": band_caught,
            "split_layer_check_fails_it_on_layers": layer_caught,
            "split_grad_check_fails_it": grad_caught,
            "caught": (all(band_caught[key] for key in rect)
                       and all(layer_caught.values()))}


def fault_main(name: str, dev) -> int:
    build.ensure_built()
    tmp = plant_fault(name)
    try:
        print(f"planted fault in {name}: "
              f"{FAULTS[name][1].splitlines()[-1].strip()}", flush=True)
        result = (band_fault_result if name in BAND
                  else square_fault_result)(name, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(result), flush=True)
    return 0 if result["caught"] else 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--plant-fault", choices=sorted(FAULTS))
    parser.add_argument("--eager", action="store_true",
                        help="run every train step eagerly "
                        "(disable_capture), for the captured-vs-eager A/B")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = default_device()
    card = card_line()
    print(f"card: {card}", flush=True)
    if args.plant_fault:
        return fault_main(args.plant_fault, dev)
    if args.eager:
        global CAPTURE
        CAPTURE = False
        with disable_capture():
            return run_all(dev, card)
    return run_all(dev, card)


def run_all(dev, card: str) -> int:
    """Every phase, then the kernels line, the card line and the result
    line."""
    t0 = time.perf_counter()
    build.ensure_built()
    print(f"build: nvcc {time.perf_counter() - t0:.1f} s", flush=True)
    for name in build.sources():
        with open(build.log_path(name)) as f:
            print(f"build {name}: {ptxas_usage(f.read())}", flush=True)

    rows = {}
    for b, t in SHAPES:
        rows[(b, t)] = kernel_phase(b, t, dev)
    band_rows = band_phase(TRAIN_BATCH, TRAIN_SEQ, dev)

    main_run, loss_unsplit = train_phase(card)
    torch.cuda.empty_cache()
    split_runs = {}
    for n in SPLITS:
        split_runs[n] = split_train_phase(n, loss_unsplit, card)
        torch.cuda.empty_cache()
    remat_phase(main_run["peak"], card)
    llama_phase(card)
    torch.cuda.empty_cache()
    resnet_phase(card)
    torch.cuda.empty_cache()
    vit_rows, vit_run = vit_phase(card)
    torch.cuda.empty_cache()
    moe_phase(card)
    torch.cuda.empty_cache()
    mesh_phase(main_run, card)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s after the build "
          "began", flush=True)

    main_rows = rows[(TRAIN_BATCH, TRAIN_SEQ)]
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name],
                "launches": main_run["counts"][name], **main_rows[name]}
               for name in SQUARE]
    kernels += [{"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name],
                 "launches": split_runs[SPLITS[0]]["counts"][name],
                 **band_rows[SPLITS[0]][name]} for name in BAND]
    # The square kernels' non-causal route at ViT-B/16's shape, with the
    # ViT run's launches (the JAX ViT calls jax.nn.dot_product_attention;
    # the route is the causal=False arithmetic of the kernels replaced).
    kernels += [{"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "causal": False,
                 "launches": vit_run["counts"][name], **vit_rows[name]}
                for name in SQUARE]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
