#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --eager                 (every train step eager)
    python3 chip_smoke.py --plant-fault KERNEL    (any kernel of FAULTS)
    python3 chip_smoke.py --cards 4               (phase 16, on four cards)
    python3 chip_smoke.py --cards 4 --plant-fault ring_dkv_home
    python3 chip_smoke.py --plant-fault serve_left_pad

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
   ``dryrun_multichip(1)`` with no device named, run at the end of phase
   13 (its (g)): one spawned NCCL rank on ``cuda:0`` takes a GPT-2 tiny
   train step (head dim 64) through the kernels on the JAX dry run's
   ``dp × sp × tp`` factors (all 1), a finite loss.

13. Tensor and pipeline parallelism, the MoE transformer over ``ep`` and
   checkpoints, on phase 12's one-rank NCCL mesh at full width. (a) GPT-2
   124M at batch 32 x 1024 with the tp route forced on the one-rank
   ``tp`` axis (``sharding._place_forced``, as phase 12 forces FSDP2):
   every tp collective (``copy_to``, ``reduce_from``), the vocab-parallel
   lookup and cross-entropy run, captured. Checks: the first
   CAPTURE_STEPS losses against phase 12's mesh-less captured step's
   (CAPTURE_LOSS_RTOL), ``compile_count`` 1, buffers donated, 12 launches
   per kernel per step; step ms beside the mesh-less step's. (b)
   TinyLlama 1.1B at batch 8 x 2048 the same way: the step-0 loss against
   the mesh-less step's, 22 launches per kernel. (c) ``MoETransformer
   (MoEConfig())`` at batch 32 x 1024 on ``dp 1 × ep 1`` through the
   global routing (``ops.moe.top1_route`` over the batch's tokens) and
   the ep route forced:
   the first losses against the mesh-less MoE step's, and each MoE
   layer's dropped share at step 0 equal to the mesh-less routing's. (d)
   The square kernels at the head counts a tp rank runs (TP_KERNEL_SHAPES:
   GPT-2's shape at 6 and 3 heads, TinyLlama's at 8 q heads on 1 kv head,
   its tp 4) by ``agreement``, timed beside their bound, plain versions
   and SDPA. (e) ``spmd_pipeline`` at ``pp = 1``, GPT-2 124M's 12 blocks
   as the stage, PIPE_MICROBATCHES microbatches of 8 x 1024: the loss
   within PIPE_LOSS_RTOL of the plain block stack's, the block gradients
   within PIPE_GRAD_RTOL relative norm of the plain stack on the same
   microbatches and within PIPE_WHOLE_GRAD_RTOL of the whole batch's, 4
   launches per kernel per block. (f) Checkpoint: (a)'s
   state saved after 2 steps (``train.checkpoint.save_train_state``) and
   restored into a fresh state of other weights; the next 2 losses equal
   to the uninterrupted run's bit for bit. (g) Phase 12 (e). (h) ViT-B/16
   and ResNet-50 at batch 128, 224x224, with their tp routes forced on the
   one-rank ``tp`` axis (ViT: ``mlp_proj``'s rows, ``copy_to`` and
   ``reduce_from``; ResNet: every convolution's output channels, the
   channels gathered before each convolution, BatchNorm's slices of its
   scale and bias through ``copy_to`` and its statistics gathered, the
   pooled channels through ``gather_from``), captured: the first
   CAPTURE_STEPS losses
   against the mesh-less captured step's (CAPTURE_LOSS_RTOL; at one rank
   every collective is a copy), ``compile_count`` 1, buffers donated,
   ResNet's running statistics equal; step ms beside the mesh-less step's.

14. The runtime (``ray_tpu_torch.init``, tasks, actors, the object store,
   the GPU as a resource) and ``TorchTrainer`` on it, after the driver
   has freed its memory. (a) A fresh driver's ``init()`` in a new process
   counts the card as ``GPU`` and imports no torch (so holds no CUDA
   context); here, a plain task sees ``CUDA_VISIBLE_DEVICES=""`` and no
   device, a ``num_gpus=1`` task its card and only it
   (``CUDA_VISIBLE_DEVICES="0"``, one device, ``get_gpu_ids() == [0]``).
   (b) GPT-2's ``wte`` (bf16, on the card) through ``put``/``get``,
   through a CPU task and back, and as a CPU task's argument: CPU
   tensors, bit-equal; MB/s, and the time of a CPU task that reads it
   and returns nothing. (c) GPT-2
   124M at batch 32 x 1024: the driver's CAPTURE_STEPS captured steps
   from seed 0 on the LM batch (and MESH_TIMED_STEPS timed), then a
   ``num_gpus=1`` actor, given the same weights as numpy through the
   object store, runs the same steps (``gpt2_steps``, the same code):
   losses within CAPTURE_LOSS_RTOL, ``compile_count`` 1, 12 launches of
   each kernel a step counted inside the actor; a second ``num_gpus=1``
   task waits while the actor holds the card. (d)
   ``TorchTrainer(trainer_loop, scaling_config=ScalingConfig(
   num_workers=1, gpus_per_worker=1)).fit()``: one NCCL rank, the same
   steps, each reported; the reported losses against (c)'s; the trainer's
   checkpoint (``save_train_state``) restored here into other weights
   gives the trainer's next loss bit for bit. (e) The host rates of
   RUNTIME_TASKS no-op tasks and RUNTIME_ACTOR_CALLS calls to one actor
   (printed, not checked); the workers loaded the kernels the driver
   built (no library rebuilt).
15. The Data library (``ray_tpu_torch.data``) feeding GPT-2 124M at batch
   32 x 1024 from seed 0. (a) DATA_STEPS x 32 rows of 1025 token ids
   (numpy seed 0, GPT-2's vocabulary) written with ``data.tfrecord``
   (one int64 feature ``tokens``) into DATA_FILES TFRecord files; the
   native scanner (``native/tfrec.cpp``) must have loaded, and it and the
   Python codec read the same records (CRCs checked; MB/s of each).
   (b) ``read_tfrecords(dir).map_batches(lm_batch)`` alone:
   ``iter_batches(32, drop_last=True)`` gives exactly the numpy batches,
   in order (rows/s and MB/s of the second pass); a ``map_batches`` probe
   shows its block workers without torch, jax or ray_tpu and seeing
   ``CUDA_VISIBLE_DEVICES=""``. (c) The captured step in this process fed
   by ``ds.iterator().iter_device_batches(32)`` against the same step fed
   the numpy batches through ``prefetch_to_device``, from the same
   weights: losses within CAPTURE_LOSS_RTOL (bit-equal expected), the
   batches on the card bit-equal to numpy, ``compile_count`` 1, 12
   launches of each kernel a step; the input stall and the prefetcher's
   produce time, the step ms beside phase 4's. (d)
   ``TorchTrainer(data_trainer_loop, datasets={"train": ds},
   scaling_config=ScalingConfig(num_workers=1, gpus_per_worker=1))
   .fit()``: the rank reads ``get_dataset_shard("train")
   .iter_device_batches(32)`` and reports each step's loss and batch
   checksums (int64 sums of tokens and targets): the checksums equal the
   numpy batches', the losses within CAPTURE_LOSS_RTOL of (c)'s numpy
   feed, ``compile_count`` 1 and 12 launches a kernel a step; fit()'s
   time to the first report and whole, beside phase 14's.

16. Multi-card, only under ``--cards N`` (N >= 4 cards visible, else it
   exits 1 naming the count; the plain run prints that it needs them):
   the build, then ``parallel.multicard.run`` spawns N NCCL ranks, rank r
   on ``cuda:r``, each printing its card's UUID. Every rank runs, on its
   own card, the one-card mesh-less captured step of each model from seed
   0 on the global batch, and holds each mesh route against it within the
   limits of ``parallel.multicard`` (each with its rounding argument): (a)
   GPT-2 124M at 32 x 1024 on ``dp N``, the flat-bucket all-reduce in the
   graph, the first CAPTURE_STEPS losses and gradient norms; (b)
   TinyLlama 1.1B at 8 x 2048 on ``fsdp N``, eager by rule, peak memory
   per rank below the one-card step's; (c) GPT-2 with ring attention and
   TinyLlama with Ulysses on ``sp N``: losses and every layer's step-0
   gradient, and the ring's k, v hop and dk, dv rotation alone; (d) GPT-2
   and TinyLlama on ``dp N/2 x tp 2`` and ``tp N``; (e) the MoE
   transformer on ``dp N/2 x ep 2`` and ``ep N``, the routers' step-0
   gradients; (f) ``spmd_pipeline`` on ``pp N``, GPT-2's blocks in N
   stages, PIPE_MICROBATCHES microbatches: the loss and each stage's block
   gradients against the whole batch's, and the bubble; (g) ViT-B/16 and
   ResNet-50 at 128 x 224² on ``dp N/2 x tp 2``; (h) GPT-2 saved on ``tp
   N`` and restored on ``dp N`` and off any mesh, parameters bit-equal;
   (i) ``dryrun_multichip(N)`` with no device named. Every route but FSDP2
   and the pipeline runs captured (``compile_count`` 1, buffers donated).
   Prints each run's step ms and tokens (images) per second per GPU beside
   the one-card step's, the NCCL kernels of one profiled step (the bucket
   all-reduce, tp's all-reduces, the ring's send/receive), peak memory per
   rank and the launch counts per rank, beside every card's name and power
   limit and ``nvidia-smi topo -m``. Then its serve leg: phase 17's
   deployment with N replicas at ``num_gpus=1``, which must sit on N
   distinct cards (UUIDs, ``CUDA_VISIBLE_DEVICES`` 0..N-1);
   SERVE_CARDS_REQUESTS requests at 32 callers, each replica serving some;
   every response bit-equal to its batch recomputed on card 0 and within
   SERVE_ALONE_TOL of its request alone; requests/s. Phases 1-15 and 17
   do not run under ``--cards``; the last line keeps its form. With ``--plant-fault
   ring_dkv_home`` (``multicard.FAULTS``) it runs (c) with the ring
   backward's dk, dv stopped one rotation short of home and exits 0 only
   if the checks fail it.

17. Serve (``ray_tpu_torch.serve``) on the port's runtime: GPT-2 124M
   (``GPT2Config.small()``, bf16, random weights from seed 0 passed to the
   replicas by object ref) behind ``GPT2Server``, a deployment whose
   ``@serve.batch(max_batch_size=8, batch_wait_timeout_s=0.01)`` method
   runs one forward a batch under ``inference_mode``, right-padded to its
   longest request rounded up to 64; a request gets back its last valid
   position's float32 logits, its top-1 id and its batch's signature.
   Requests: SERVE_REQUESTS token sequences, lengths uniform in 64-1024
   (numpy seed 0). (a) A replica that holds no card cannot start (no CPU
   fallback); then ``serve.run`` of a ``num_gpus=1`` replica, with the
   HTTP proxy, to the first answer; the replica warms every padded length
   at batch 8 and profiles one forward's attention ops. (b) Every response
   bit-equal to its batch recomputed in this process by the same module
   and weights (the signature's requests, padded to its T), and within
   SERVE_ALONE_TOL of its request run alone, batch 1, unpadded. (c) In
   the replica: 12 ``flash_fwd`` launches a batch and no backward one,
   counted from the end of its warm-up, and the flash op, not SDPA, in
   its forward. (d) The requests through the handle at 1, 8 and 32
   callers (requests/s, tokens/s, p50 and p99 ms, mean batch), beside
   them the in-process forward of a full batch (8 x 1024) and of one
   request alone at the requests' mean length (padded to 64), each on
   the host clock as the replica runs it (tokens in, forward, logits
   out) with the card's busy time in it (torch.profiler), and
   SERVE_HTTP_REQUESTS requests over HTTP through the proxy with the
   checks of (b) (no HTTP leg, and a line saying so, where aiohttp does
   not import). (e) Two replicas at ``num_gpus=0.5`` on the one card: each
   serves some of SERVE_HALF_REQUESTS requests at 32 callers, and (b) and
   (c) hold for both. ``--plant-fault serve_left_pad`` runs (a) and (b)
   with the deployment padding on the left, takes (b)'s readings without
   raising and prints ``{"fault": ..., "caught": ...}``: caught when every
   response differs from its batch recomputed and one is off its request
   alone by more than SERVE_FAULT_MARGIN x SERVE_ALONE_TOL. It exits 1
   when caught, 2 when missed or when the run failed before (b).

Every train phase trains through the captured step (one CUDA graph,
replayed; ``train.step``) and checks that it was captured once
(``compile_count`` 1 after warm-up and after the timed dispatches) and
updated the state in place (``buffers_donated``); its profiled dispatch
cross-checks the launch counters against the flash kernels the profiler
sees in the replay. GPT-2 and ResNet-50 also hold their first
CAPTURE_STEPS losses against the same step under ``disable_capture()``
from the same weights (CAPTURE_LOSS_RTOL).

Then it prints the ``kernels`` JSON line (the ViT run's non-causal
readings as entries with ``"causal": false``; ``flash_fwd`` at phase 17's
full batch, 8 x 1024, with the replica's launches, as the entry with
``"path": "serve"``), the card line again, and
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
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback

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
from ray_tpu_torch.models.gpt2 import (
    chunked_cross_entropy,
    gpt2_loss_fn,
    matmul_f32,
)
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
from ray_tpu_torch.parallel import initialize, make_mesh, multicard
from ray_tpu_torch.parallel.dryrun import dryrun_multichip
from ray_tpu_torch.parallel.mesh import DATA_AXES
from ray_tpu_torch.parallel.pipeline import spmd_pipeline
from ray_tpu_torch.parallel.sharding import _place_forced
from ray_tpu_torch import serve
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
from ray_tpu_torch.train.checkpoint import (
    restore_train_state,
    save_train_state,
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
# spmd_pipeline at pp = 1 against the plain block stack: the loss against
# the whole batch's (the blocks act on each row alone, so only a product
# that picks another algorithm for 8 rows could move it); the block
# gradients against the plain stack on the same microbatches, since each
# microbatch's bf16 weight gradient is rounded before the sum (2.6e-3
# relative against the whole batch's read on an H100), and against the
# whole batch's within PIPE_WHOLE_GRAD_RTOL, so that a fault shared by both
# microbatched runs still shows.
PIPE_LOSS_RTOL = 1e-5
PIPE_GRAD_RTOL = 1e-3
PIPE_WHOLE_GRAD_RTOL = 1e-2
MOE_FORM_GRAD_TOL = 1e-3
# Phase 17: a served request's last-position logits (float32, from the
# bf16 model) against the same request run alone, batch 1, unpadded:
# max |served - alone| <= SERVE_ALONE_TOL * rms(alone). The attention of a
# valid row sees the same keys either way (the causal mask hides the
# padding), but every product runs at another M (B x T rows against 1 x
# len), so cuBLAS may sum in another order and round an element to the
# other bf16 neighbour (2^-8 relative) in any of the 12 layers, which the
# residual stream carries to the LM head. That is the rounding chain the
# kernel checks hold within 2^-3 rms (flash_attention.AGREEMENT_TOL).
# A left-padded batch moves the positions and lets attention see the
# padding: its logits are another function, off by O(rms).
SERVE_ALONE_TOL = 2.0 ** -3
# ``serve_left_pad`` is caught when (b) fails it by this many limits.
SERVE_FAULT_MARGIN = 8

# The host's wait on each side of a profiled dispatch (profile_dispatch).
PROFILE_MARGIN_S = 0.1

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
# (B, T, q heads, kv heads, what): the attention a tp rank runs.
TP_KERNEL_SHAPES = ((32, 1024, 6, 6, "GPT-2 at tp 2 (6 heads)"),
                    (32, 1024, 3, 3, "GPT-2 at tp 4 (3 heads)"),
                    (8, 2048, 8, 1, "TinyLlama at tp 4 (8 q heads on 1 kv "
                     "head)"))
PIPE_MICROBATCHES = 4
RUNTIME_WAIT_S = 2.0               # a second GPU task stays pending so long
RUNTIME_TASKS = 1000               # no-op tasks of the host rate
RUNTIME_ACTOR_CALLS = 2000         # calls to one actor of the host rate
DATA_STEPS = 12                    # steps (batches) of the Data feed
DATA_FILES = 8                     # TFRecord files the rows are cut into
SERVE_REQUESTS = 256               # requests of each load leg of phase 17
SERVE_CALLERS = (1, 8, 32)         # concurrent callers of the load legs
SERVE_LENGTHS = (64, 1024)         # request lengths, uniform (numpy seed 0)
SERVE_BATCH = 8                    # @serve.batch(max_batch_size=)
SERVE_WAIT_S = 0.01                # @serve.batch(batch_wait_timeout_s=)
PAD_MULTIPLE = 64                  # a batch's T: its longest, rounded up
SERVE_HTTP_REQUESTS = 32           # requests of the HTTP leg
SERVE_HALF_REQUESTS = 64           # requests to the two half-card replicas
SERVE_CARDS_REQUESTS = 128         # requests to the four-card replicas
ROOT = os.path.dirname(os.path.abspath(__file__))

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
# Faults of phase 17's deployment (user code, not a kernel).
SERVE_FAULTS = {"serve_left_pad": "GPT2Server pads each batch on the left"}
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
        # The profiler keeps only the device records that fall inside its
        # window on the host's clock, to which it maps the card's
        # timestamps. With the dispatch at the window's start, the first
        # flash forwards of a dispatch late in this script fell outside
        # now and then (1 or 4 of them). The host waits PROFILE_MARGIN_S
        # on each side of the dispatch.
        opened = time.perf_counter()
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_MARGIN_S)
        window_ms = (time.perf_counter() - opened) * 1e3
    counted = fa.launch_counts()
    rows = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and getattr(e, "self_device_time_total", 0.0) > 0]
    busy_ms = sum(r[2] for r in rows) / 1e3
    if busy_ms == 0:
        print("profile: no device time recorded (not measured)", flush=True)
        return state, None
    spans = [e.time_range for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    head = min(r.start for r in spans) / 1e3
    tail = window_ms - max(r.end for r in spans) / 1e3
    print(f"profile window: the first device record starts {head:.3f} ms "
          f"after the profiler's start, the last ends {tail:.3f} ms before "
          f"the host left it (the host waits {PROFILE_MARGIN_S * 1e3:.0f} "
          "ms on each side of the dispatch)", flush=True)
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


def moe_routes(model, batch) -> dict:
    """{layer: its Route} of every MoE layer on ``batch`` at the model's
    weights: the routing its ``SwitchFFN`` runs (``top1_route``, over the
    batch's tokens on a mesh)."""
    cfg, mesh = model.config, model.mesh
    ranks = 1 if mesh is None else mesh.axis_size(DATA_AXES)
    routes = {}
    for i, x in moe_layer_inputs(model, batch).items():
        cap = capacity_for(x.shape[0] * ranks, cfg.num_experts,
                           cfg.capacity_factor)
        routes[i] = top1_route(x.float() @ model.h[i].moe.router.float(),
                               cfg.num_experts, cap, mesh,
                               batch["tokens"].shape[0])
    return routes


def moe_routing(model, batch) -> str:
    """Each MoE layer's routing on ``batch``: the share of tokens dropped
    past capacity and each expert's share of the tokens (its load)."""
    cfg = model.config
    parts = []
    for i, route in moe_routes(model, batch).items():
        load = torch.bincount(route.expert, minlength=cfg.num_experts)
        dropped = 1.0 - float(route.kept.float().mean())
        parts.append(f"layer {i} dropped {dropped:.4f}, load " + "/".join(
            f"{v:.3f}" for v in (load.float() / load.sum()).tolist()))
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


def gpt2_small(mesh):
    return GPT2(GPT2Config.small(), seed=0, mesh=mesh)


def mesh_train(mesh, forced: tuple[str, ...], host_batch, what: str,
               make_model=gpt2_small, loss_fn=None, steps: int = CAPTURE_STEPS,
               timed: int = MESH_TIMED_STEPS, before=None) -> dict:
    """``make_model(mesh)`` (GPT-2 124M from seed 0 by default) with the
    LM optimizer through ``make_train_step``: off a mesh (``mesh`` None),
    or placed on ``mesh`` by ``init_train_state`` (after
    ``sharding._place_forced`` over ``forced``: FSDP2, the tp route or the
    ep route on a one-rank axis) with its batch from ``shard_batch``.
    ``before(model, batch)`` runs first, its result kept. ``steps`` steps
    on the batch give the losses and the launch counts (counts set to 0
    just before, read just after); ``timed`` more are timed."""
    model = make_model(mesh)
    dev = next(model.parameters()).device
    if forced:
        _place_forced(model, mesh, forced)
    opt = lm_opt()
    state = init_train_state(model, opt, mesh=mesh)
    step = make_train_step(loss_fn or gpt2_loss_fn(ce_chunk=2048), opt,
                           grad_norm=False)
    batch = (device_batch(*host_batch, dev) if mesh is None else
             shard_batch({"tokens": host_batch[0], "targets": host_batch[1]},
                         mesh))
    seen = before(model, batch) if before else None
    fa.reset_launch_counts()
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(steps)]
    counts = fa.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        state, metrics = step(state, batch)
    if timed:
        float(metrics["loss"])
    dt = (time.perf_counter() - t0) / max(timed, 1)
    params = list(model.parameters())
    run = {"losses": losses, "counts": counts, "step_ms": dt * 1e3,
           "tok_s": host_batch[0].size / dt,
           "compile_count": compile_count(step),
           "donated": buffers_donated(step, state),
           "sharded": sum(isinstance(p, DTensor) for p in params),
           "before": seen}
    print(f"mesh {what}: {run['sharded']} of {len(params)} parameters "
          f"sharded by FSDP2; first {steps} losses {losses}; step "
          f"{run['step_ms']:.2f} ms, {run['tok_s']:.1f} tokens/s over "
          f"{timed} single steps; compile_count "
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


def mesh_phase(main_run: dict, card: str) -> tuple:
    """The port's mesh on one card: a one-rank NCCL group and a mesh with
    every axis of size 1. (a) GPT-2 124M on ``dp = 1`` through
    ``init_train_state(mesh=)``, ``shard_batch`` and the captured step,
    the gradient all-reduce inside the graph, against the same step off
    the mesh; (b) the same under FSDP2 (``fsdp = 1``); (c) ring attention's
    hops through the kernels at GPT-2's and TinyLlama's attention shapes;
    (d) Ulysses and ``moe_ffn`` over their groups at world 1; (e) the
    multi-rank dry run, which :func:`tp_phase` runs last. Returns the mesh
    and the mesh-less run."""
    dev = initialize()
    mesh = make_mesh({"dp": 1})
    print(f"mesh: {mesh} over a {dist.get_backend()} group of "
          f"{dist.get_world_size()}", flush=True)
    host = train_batch(GPT2Config.small().vocab_size)
    plain = mesh_train(None, (), host, "off (mesh-less captured step)")
    dp = mesh_train(mesh, (), host, "dp=1 (gradient all-reduce in the "
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

    fsdp = mesh_train(mesh, ("fsdp",), host, "fsdp=1 (FSDP2)")
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
    return mesh, plain


def check_losses(got: dict, want: dict, what: str) -> float:
    """``got``'s first losses against ``want``'s within CAPTURE_LOSS_RTOL;
    the largest relative difference."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                  want["losses"],
                                                  strict=True))
    print(f"{what}: losses {got['losses']} vs {want['losses']}, bit-equal "
          f"{got['losses'] == want['losses']}, largest relative difference "
          f"{rel:.3g} (limit {CAPTURE_LOSS_RTOL}); step {got['step_ms']:.2f} "
          f"ms vs {want['step_ms']:.2f} ms "
          f"({got['step_ms'] / want['step_ms'] - 1:+.2%})", flush=True)
    check(rel <= CAPTURE_LOSS_RTOL, f"{what}: the losses match")
    return rel


def moe_dropped(model, batch) -> list[float]:
    """Each MoE layer's dropped share at the model's weights on ``batch``
    (``moe_routes``: global routing on a mesh)."""
    return [1.0 - float(route.kept.float().mean())
            for route in moe_routes(model, batch).values()]


def tp_kernel_inputs(b: int, t: int, h: int, kv: int, dev):
    """q, do ``[B*h, T, D]`` and k, v of ``kv`` heads each repeated to h
    (GQA's repeat on a tp rank), folded, bf16."""
    gen = torch.Generator(device=dev).manual_seed(t + h + kv)
    q, do = (torch.randn(b * h, t, D, device=dev, generator=gen)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, kv, t, D, device=dev, generator=gen)
            .to(torch.bfloat16).repeat_interleave(h // kv, dim=1)
            .reshape(b * h, t, D) for _ in range(2))
    return q, k, v, do


def pipeline_check(mesh, host, card: str) -> None:
    """(e) ``spmd_pipeline`` at ``pp = 1``: GPT-2 124M's 12 blocks as the
    stage, PIPE_MICROBATCHES microbatches of the training batch, then
    ``ln_f`` and the chunked CE. The loss against the plain block stack on
    the whole batch; every block gradient against the plain stack run on
    the same microbatches one after another (each microbatch's weight
    gradients are rounded to bf16 before they are summed, on both), and,
    at a looser limit, against the whole batch's."""
    model = gpt2_small(None)
    batch = device_batch(*host, mesh.device)
    dt = model.config.dtype

    def stack(x):
        return functools.reduce(lambda a, blk: blk(a, model.attn_fn),
                                model.h, x)

    pipe = spmd_pipeline(lambda blocks, x: stack(x), PIPE_MICROBATCHES,
                         mesh=mesh)
    variants = {
        "pipeline": lambda x: pipe(model.h, x),
        "plain, microbatched": lambda x: torch.cat(
            [stack(m) for m in x.chunk(PIPE_MICROBATCHES)]),
        "plain, whole batch": stack}
    params = list(model.h.parameters())
    out = {}
    for name, run in variants.items():
        for _ in range(2):                  # the second run is timed
            fa.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = F.embedding(batch["tokens"], model.wte.weight.to(dt)) \
                + model.wpe.weight[:TRAIN_SEQ].to(dt)
            loss = chunked_cross_entropy(model.ln_f(run(x)), model.wte.weight,
                                         batch["targets"])
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
            out[name] = (float(loss.detach()), grads,
                         time.perf_counter() - t0,
                         fa.launch_counts())
            del x, loss, grads

    def grad_err(a: str, b: str) -> float:
        return max(float(torch.linalg.vector_norm(x.float() - y.float())
                         / torch.linalg.vector_norm(y.float()))
                   for x, y in zip(out[a][1], out[b][1]))

    lp, _, tp_, cp = out["pipeline"]
    lw, _, tw, _ = out["plain, whole batch"]
    rel = abs(lp - lw) / abs(lw)
    g_micro = grad_err("pipeline", "plain, microbatched")
    g_whole = grad_err("pipeline", "plain, whole batch")
    rows = TRAIN_BATCH // PIPE_MICROBATCHES
    print(f"pipeline pp=1, GPT-2 124M's {len(model.h)} blocks as the stage, "
          f"{PIPE_MICROBATCHES} microbatches of {rows}x{TRAIN_SEQ}: loss "
          f"{lp} vs the plain whole batch's {lw} (relative {rel:.3g}, limit "
          f"{PIPE_LOSS_RTOL}); largest block gradient relative norm error "
          f"{g_micro:.3g} against the plain stack on the same microbatches "
          f"(limit {PIPE_GRAD_RTOL}), {g_whole:.3g} against the whole batch "
          f"(limit {PIPE_WHOLE_GRAD_RTOL}: bf16 weight gradients rounded per "
          f"microbatch); "
          f"forward+backward {tp_ * 1e3:.1f} ms, plain microbatched "
          f"{out['plain, microbatched'][2] * 1e3:.1f} ms, plain whole "
          f"{tw * 1e3:.1f} ms (host clock, eager, second run); launches "
          f"{cp}; card {card}", flush=True)
    check(rel <= PIPE_LOSS_RTOL and g_micro <= PIPE_GRAD_RTOL
          and g_whole <= PIPE_WHOLE_GRAD_RTOL,
          "spmd_pipeline at pp=1 matches the plain block stack")
    check(all(cp[k] == PIPE_MICROBATCHES * len(model.h) for k in SQUARE),
          "the pipeline ran each block's kernels once a microbatch")
    del model, out, params
    torch.cuda.empty_cache()


def checkpoint_check(mesh, host, card: str) -> None:
    """(f) GPT-2 124M on the tp route: its state saved after 2 steps and
    restored into a fresh state of other weights; the next 2 losses
    against the uninterrupted run's, bit for bit."""
    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        runs = {}
        for name in ("uninterrupted", "restored"):
            model = GPT2(GPT2Config.small(), seed=int(name == "restored"),
                         mesh=mesh)
            _place_forced(model, mesh, ("tp",))
            opt = lm_opt()
            state = init_train_state(model, opt, mesh=mesh)
            step = make_train_step(gpt2_loss_fn(ce_chunk=2048), opt,
                                   grad_norm=False)
            batch = shard_batch({"tokens": host[0], "targets": host[1]},
                                mesh)
            t0 = time.perf_counter()
            if name == "restored":
                restore_train_state(directory, state)
            else:
                for _ in range(2):
                    step(state, batch)
                save_train_state(state, directory)
            torch.cuda.synchronize()
            io_s = time.perf_counter() - t0
            at = state.step
            runs[name] = ([float(step(state, batch)[1]["loss"])
                           for _ in range(2)], at, io_s)
            del model, opt, state, step, batch
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    (want, at_w, save_s), (got, at_g, load_s) = (runs["uninterrupted"],
                                                 runs["restored"])
    print(f"checkpoint, GPT-2 124M on the tp route: losses after restore "
          f"{got} vs uninterrupted {want}, bit-equal {got == want}; step "
          f"{at_g} restored ({at_w} saved); 2 steps + save {save_s:.2f} s, "
          f"restore {load_s:.2f} s (host clock); card {card}", flush=True)
    check(got == want and at_g == at_w == 2,
          "the restored state's next losses equal the uninterrupted run's")


def vision_tp_check(mesh, card: str) -> None:
    """(h) ViT-B/16 and ResNet-50 at batch 128 with the tp route forced on
    the one-rank ``tp`` axis against the mesh-less captured step from the
    same weights on the same images."""
    want_captures = 1 if CAPTURE else None
    for name, make, loss_fn, make_opt, keys, has_extra in (
            ("ViT-B/16", lambda m: ViT(ViTConfig.base(), seed=0, mesh=m),
             vit_loss_fn(), lambda: adamw(3e-3), ("images", "labels"),
             False),
            ("ResNet-50", lambda m: ResNet(ResNet50Config(), seed=0, mesh=m),
             resnet_loss_fn(), lambda: sgd(0.1, momentum=0.9, nesterov=True),
             ("image", "label"), True)):
        host = multicard.image_batch(VIT_BATCH, IMAGE_SIZE, 1000, keys)
        runs = {}
        for what, m in (("mesh-less", None), ("tp=1", mesh)):
            model = make(m)
            if m is not None:
                _place_forced(model, m, ("tp",))
            batch = (shard_batch(host, m) if m is not None else
                     {k: torch.from_numpy(v).to(mesh.device)
                      for k, v in host.items()})
            runs[what] = multicard.run_steps(
                model, loss_fn, make_opt(), batch, m, CAPTURE_STEPS,
                MESH_TIMED_STEPS, has_extra=has_extra)
            del model, batch
            torch.cuda.empty_cache()
        got, want = runs["tp=1"], runs["mesh-less"]
        check_losses(got, want, f"mesh tp=1 (the tp route forced) vs "
                     f"mesh-less {name}")
        check(got["compile_count"] == want_captures and got["donated"],
              f"{name} tp=1: captured {want_captures} time(s), buffers "
              "donated")
        if has_extra:
            same = all(torch.equal(got["stats"][k], want["stats"][k])
                       for k in want["stats"])
            print(f"{name} tp=1: running statistics equal to the mesh-less "
                  f"step's {same}; card {card}", flush=True)
            check(same, f"{name} tp=1: the running statistics match")


def tp_phase(mesh, plain: dict, card: str) -> dict[str, dict]:
    """Phase 13: tensor parallelism, the MoE transformer's global routing
    over ``dp × ep``, the pipeline and checkpoints on the one-rank NCCL
    mesh of phase 12, at full width; then the multi-rank dry run. Returns
    the kernels' readings at the tp-local head counts."""
    dev = mesh.device
    n = GPT2Config.small().n_layer
    host = train_batch(GPT2Config.small().vocab_size)
    want_captures = 1 if CAPTURE else None
    # (a) GPT-2 124M on the tp route.
    tp = mesh_train(mesh, ("tp",), host, "tp=1 (the tp route forced: "
                    "copy_to/reduce_from, vocab-parallel lookup and CE)")
    check_losses(tp, plain, "mesh tp=1 vs mesh-less GPT-2 124M")
    check(tp["compile_count"] == want_captures and tp["donated"],
          f"mesh tp=1: captured {want_captures} time(s), buffers donated")
    check_counts({"n_steps": CAPTURE_STEPS, "counts": tp["counts"]},
                 {name: n for name in SQUARE}, "mesh tp=1")

    # (b) TinyLlama 1.1B on the tp route, step 0.
    llama_host = train_batch(LlamaConfig.tinyllama_1b().vocab_size,
                             LLAMA_BATCH, LLAMA_SEQ)
    runs = {}
    for what, m, forced in (("mesh-less", None, ()),
                            ("tp=1", mesh, ("tp",))):
        runs[what] = mesh_train(
            m, forced, llama_host, f"TinyLlama 1.1B {what}",
            make_model=lambda mm: Llama(LlamaConfig.tinyllama_1b(), seed=0,
                                        mesh=mm),
            loss_fn=llama_loss_fn(ce_chunk=2048), steps=1, timed=1)
    check_losses(runs["tp=1"], runs["mesh-less"],
                 "mesh tp=1 vs mesh-less TinyLlama 1.1B, step 0")
    check_counts({"n_steps": 1, "counts": runs["tp=1"]["counts"]},
                 {name: LlamaConfig.tinyllama_1b().n_layer
                  for name in SQUARE}, "TinyLlama tp=1")

    # (c) The MoE transformer's global routing on dp x ep.
    moe = {}
    for what, m, forced in (("mesh-less", None, ()),
                            ("dp=1 x ep=1", mesh, ("ep",))):
        moe[what] = mesh_train(
            m, forced, host, f"MoE {what}",
            make_model=lambda mm: MoETransformer(MoEConfig(), seed=0,
                                                 mesh=mm),
            loss_fn=moe_loss_fn(ce_chunk=2048), timed=2, before=moe_dropped)
    got, want = moe["dp=1 x ep=1"], moe["mesh-less"]
    check_losses(got, want, "mesh dp=1 x ep=1 (global routing, the ep "
                 "combine) vs mesh-less MoE")
    print(f"MoE dropped share per MoE layer at step 0: global routing "
          f"{got['before']}, mesh-less {want['before']}", flush=True)
    check(got["before"] == want["before"], "MoE: each layer's dropped share "
          "at step 0 equals the mesh-less routing's")
    check_counts({"n_steps": CAPTURE_STEPS, "counts": got["counts"]},
                 {name: n for name in SQUARE}, "MoE dp x ep")

    # (d) The kernels at tp-local head counts.
    rows = {}
    for b, t, h, kv, what in TP_KERNEL_SHAPES:
        q, k, v, do = tp_kernel_inputs(b, t, h, kv, dev)
        readings = kernel_readings(q, k, v, do)
        print(f"agreement {what}: {describe(readings)}", flush=True)
        check_readings(readings, f"at {what}")
        rows[what] = kernel_times(b, q, k, v, do, readings, what)
        del q, k, v, do
    torch.cuda.empty_cache()

    pipeline_check(mesh, host, card)
    checkpoint_check(mesh, host, card)
    vision_tp_check(mesh, card)
    dist.destroy_process_group()

    # (g) = phase 12 (e): the dry run, no device named.
    t0 = time.perf_counter()
    ranks = dryrun_multichip(1)
    print(f"mesh dryrun_multichip(1), no device named: {ranks} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(len(ranks) == 1 and ranks[0]["device"] == "cuda:0"
          and ranks[0]["factors"] == {"dp": 1, "sp": 1, "tp": 1}
          and np.isfinite(ranks[0]["loss"]),
          "dryrun_multichip(1) runs one NCCL rank on the card by default")
    return rows


# -- phase 14: the runtime and the trainer ---------------------------------


def fresh_driver() -> dict:
    """(a) ``ray_tpu_torch.init()`` in a new process: its ``GPU``
    resource, and whether it loaded torch (a process that never imports
    torch holds no CUDA context)."""
    code = ("import json, sys, time\n"
            "t0 = time.perf_counter()\n"
            "import ray_tpu_torch as rt\n"
            "rt.init()\n"
            "out = {'init_s': time.perf_counter() - t0,\n"
            "       'GPU': rt.cluster_resources().get('GPU', 0.0),\n"
            "       'torch': 'torch' in sys.modules}\n"
            "rt.shutdown()\n"
            "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"a fresh driver's init(): {proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def gpu_probe() -> dict:
    """What a task sees of the card (run in a runtime worker)."""
    import ray_tpu_torch
    return {"cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_count": torch.cuda.device_count(),
            "gpu_ids": ray_tpu_torch.get_gpu_ids()}


def echo(x):
    return x


def tensor_bytes(x) -> int:
    return x.numel() * x.element_size()


def noop():
    return None


class Pinger:
    """The actor of the host rate of actor calls."""

    def ping(self):
        return None


def numpy_weights(model) -> dict:
    return {n: p.detach().cpu().numpy() for n, p in model.named_parameters()}


def load_weights(model, weights: dict) -> None:
    """``numpy_weights``' arrays into ``model`` (a copy of each array the
    object store handed out read-only)."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(np.require(weights[n],
                                                requirements="W")))


def gpt2_steps(model, host, steps: int, timed: int, capture: bool,
               save_to: str | None = None, report=None) -> dict:
    """GPT-2 on the host batch ``host`` through ``make_train_step`` with
    the LM optimizer, off a mesh: ``steps`` steps give the losses and the
    launch counts (counts set to 0 just before, read just after), each
    passed to ``report`` when given; the state is saved to ``save_to``
    when given and one more step's loss kept (``next_loss``); ``timed``
    more steps are timed on the host clock. The same code runs in this
    process, in a runtime actor and in a TorchTrainer worker."""
    dev = next(model.parameters()).device
    opt = lm_opt()
    state = init_train_state(model, opt)
    step = make_train_step(gpt2_loss_fn(ce_chunk=2048), opt,
                           grad_norm=False)
    batch = device_batch(*host, dev)
    run = {"losses": []}
    with contextlib.nullcontext() if capture else disable_capture():
        fa.reset_launch_counts()
        for _ in range(steps):
            run["losses"].append(float(step(state, batch)[1]["loss"]))
            if report is not None:
                report({"loss": run["losses"][-1], "t": time.time()})
        run["counts"] = fa.launch_counts()
        if save_to is not None:
            save_train_state(state, save_to)
            run["next_loss"] = float(step(state, batch)[1]["loss"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            state, metrics = step(state, batch)
        if timed:
            float(metrics["loss"])
        run["step_ms"] = (time.perf_counter() - t0) / max(timed, 1) * 1e3
    run["compile_count"] = compile_count(step)
    run["donated"] = buffers_donated(step, state)
    return run


class GPT2Actor:
    """A runtime actor that trains GPT-2 124M on the card it holds."""

    def train(self, weights: dict, host, steps: int, timed: int,
              capture: bool) -> dict:
        t0 = time.perf_counter()
        model = GPT2(GPT2Config.small(), seed=1)    # other weights ...
        load_weights(model, weights)                # ... replaced
        run = gpt2_steps(model, host, steps, timed, capture)
        run["setup_s"] = time.perf_counter() - t0
        run["pid"] = os.getpid()
        return run


def trainer_loop(config: dict) -> None:
    """TorchTrainer's loop: one NCCL rank (``parallel.initialize``),
    GPT-2 124M from the weights in the object store, the steps of
    ``gpt2_steps`` reported one by one, the train state checkpointed."""
    import ray_tpu_torch
    from ray_tpu_torch import train
    t_start = time.time()
    dev = initialize()
    model = GPT2(GPT2Config.small(), seed=1, device=dev)
    load_weights(model, ray_tpu_torch.get(config["weights"]))
    t_weights = time.time()
    # report() copies the checkpoint into the trial directory before it
    # returns; the loop's own copy goes with the block.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as d:
        run = gpt2_steps(model, config["host"], config["steps"],
                         config["timed"], config["capture"],
                         save_to=os.path.join(d, "state"),
                         report=train.report)
        train.report({"loss": run["losses"][-1],
                      "next_loss": run["next_loss"],
                      "step_ms": run["step_ms"], "counts": run["counts"],
                      "compile_count": run["compile_count"],
                      "donated": run["donated"],
                      "backend": dist.get_backend(), "device": str(dev),
                      "t_start": t_start, "t_weights": t_weights,
                      "t": time.time()},
                     checkpoint=train.Checkpoint.from_directory(d))


def runtime_phase(card: str) -> dict:
    """Phase 14: the port's runtime on the card and TorchTrainer on it.
    Returns fit()'s time to the first report and its whole time."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    libs = {name: os.path.getmtime(build.lib_path(name))
            for name in build.sources()}
    n = GPT2Config.small().n_layer
    want_captures = 1 if CAPTURE else None

    # (a) Resources.
    fresh = fresh_driver()
    print(f"runtime (a) a fresh driver's init(): GPU resource "
          f"{fresh['GPU']}, torch imported {fresh['torch']}, "
          f"{fresh['init_s']:.3f} s; card {card}", flush=True)
    check(fresh["GPU"] == torch.cuda.device_count() and not fresh["torch"],
          "init() counts the card as GPU and imports no torch")
    t0 = time.perf_counter()
    rt.init()
    init_s = time.perf_counter() - t0
    res = rt.cluster_resources()
    check(res.get("GPU") == torch.cuda.device_count(),
          f"cluster_resources GPU {res.get('GPU')}")
    probe = rt.remote(gpu_probe)
    t0 = time.perf_counter()
    cpu = rt.get(probe.remote())
    first_cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gpu = rt.get(probe.options(num_gpus=1).remote())
    first_gpu_s = time.perf_counter() - t0
    print(f"runtime (a) init {init_s:.3f} s, resources {res}; a plain task "
          f"sees {cpu} (first call {first_cpu_s:.2f} s, the worker's start "
          f"and torch's import included); a num_gpus=1 task sees {gpu} "
          f"({first_gpu_s:.2f} s); card {card}", flush=True)
    check(cpu == {"cuda_visible": "", "device_count": 0, "gpu_ids": []},
          "a plain task sees no GPU")
    check(gpu["device_count"] == 1 and gpu["gpu_ids"] == [0]
          and gpu["cuda_visible"] == "0",
          "a num_gpus=1 task sees its card, and only it, as [0]")

    # (c) first: the in-process reference, then its memory freed.
    cfg = GPT2Config.small()
    host = train_batch(cfg.vocab_size)
    model = GPT2(cfg, seed=0)
    weights = numpy_weights(model)
    wte = model.wte.weight.detach().to(torch.bfloat16)
    ref_run = gpt2_steps(model, host, CAPTURE_STEPS, MESH_TIMED_STEPS,
                         CAPTURE)
    del model
    torch.cuda.empty_cache()

    # (b) Objects: a bf16 tensor on the card through put/get.
    nbytes = wte.numel() * wte.element_size()
    t0 = time.perf_counter()
    wte_ref = rt.put(wte)
    t1 = time.perf_counter()
    back = rt.get(wte_ref)
    t2 = time.perf_counter()
    trips = []                  # the first round trip, then steady state
    for _ in range(2):
        t3 = time.perf_counter()
        via_task = rt.get(rt.remote(echo).remote(wte_ref))
        trips.append(time.perf_counter() - t3)
    as_argument = rt.get(rt.remote(echo).remote(wte))   # no put
    into = []                   # the tensor in, nothing back
    for _ in range(2):
        t3 = time.perf_counter()
        check(rt.get(rt.remote(tensor_bytes).remote(wte_ref)) == nbytes,
              "a CPU task reads the whole tensor")
        into.append(time.perf_counter() - t3)
    for got in (back, via_task, as_argument):
        check(isinstance(got, torch.Tensor) and got.device.type == "cpu"
              and got.dtype == torch.bfloat16 and got.shape == wte.shape
              and torch.equal(got.view(torch.int16),
                              wte.cpu().view(torch.int16)),
              "the CUDA bf16 tensor comes back a CPU tensor, bit-equal")
    mb = nbytes / 1e6
    print(f"runtime (b) wte {tuple(wte.shape)} bf16 on the card, {mb:.1f} "
          f"MB: put {mb / (t1 - t0):.1f} MB/s (the copy to the host "
          f"included), get {mb / (t2 - t1):.1f} MB/s, through a CPU task "
          f"and back {mb / trips[0]:.1f} MB/s the first time, "
          f"{mb / trips[1]:.1f} MB/s the second (the return rides the "
          f"exec socket); into a CPU task with nothing back "
          f"{into[0] * 1e3:.1f} ms, then {into[1] * 1e3:.1f} ms (mapped "
          f"from shared memory, one host copy); as a task's argument too; "
          f"bit-equal CPU tensors; "
          f"card {card}", flush=True)
    del wte, back, via_task, as_argument

    # (c) A num_gpus=1 actor trains from the same weights.
    weights_ref = rt.put(weights)
    del weights
    t0 = time.perf_counter()
    actor = rt.remote(num_gpus=1)(GPT2Actor).remote()
    run_ref = actor.train.remote(weights_ref, host, CAPTURE_STEPS,
                                 MESH_TIMED_STEPS, CAPTURE)
    waiting = probe.options(num_gpus=1).remote()
    ready, _ = rt.wait([waiting], timeout=RUNTIME_WAIT_S)
    check(not ready, "a second num_gpus=1 task waits while the actor holds "
          "the card")
    actor_run = rt.get(run_ref)
    actor_s = time.perf_counter() - t0
    rt.kill(actor)
    after = rt.get(waiting, timeout=300)
    check(after["gpu_ids"] == [0], "the waiting task ran once the actor "
          "was gone")
    rel = max(abs(a - b) / abs(b) for a, b in zip(actor_run["losses"],
                                                  ref_run["losses"],
                                                  strict=True))
    print(f"runtime (c) GPT-2 124M B={TRAIN_BATCH} T={TRAIN_SEQ} in a "
          f"num_gpus=1 actor (pid {actor_run['pid']}): losses "
          f"{actor_run['losses']} vs in-process {ref_run['losses']}, "
          f"bit-equal {actor_run['losses'] == ref_run['losses']}, largest "
          f"relative difference {rel:.3g} (limit {CAPTURE_LOSS_RTOL}); step "
          f"{actor_run['step_ms']:.2f} ms vs in-process "
          f"{ref_run['step_ms']:.2f} ms "
          f"({actor_run['step_ms'] / ref_run['step_ms'] - 1:+.2%}) over "
          f"{MESH_TIMED_STEPS} steps; compile_count "
          f"{actor_run['compile_count']}; launches {actor_run['counts']}; "
          f"actor created to result {actor_s:.1f} s (its model built and "
          f"trained in {actor_run['setup_s']:.1f} s); a second num_gpus=1 "
          f"task waited; card {card}", flush=True)
    check(rel <= CAPTURE_LOSS_RTOL, "the actor's losses match the "
          "in-process step's")
    check(actor_run["compile_count"] == want_captures
          and actor_run["donated"], f"the actor's step captured "
          f"{want_captures} time(s), buffers donated")
    check_counts({"n_steps": CAPTURE_STEPS, "counts": actor_run["counts"]},
                 {name: n for name in SQUARE}, "the runtime actor")

    # (d) TorchTrainer.fit() with one NCCL worker on the card.
    storage = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        trainer = TorchTrainer(
            trainer_loop,
            train_loop_config={"weights": weights_ref, "host": host,
                               "steps": CAPTURE_STEPS,
                               "timed": MESH_TIMED_STEPS,
                               "capture": CAPTURE},
            scaling_config=ScalingConfig(num_workers=1, gpus_per_worker=1),
            run_config=RunConfig(name="gpt2", storage_path=storage))
        t_fit = time.time()
        result = trainer.fit()
        fit_s = time.time() - t_fit
        check(result.error is None, f"fit() failed: {result.error}")
        final = result.metrics
        t_first = result.metrics_history[0]["t"]
        first_s = t_first - t_fit
        reported = [m["loss"] for m in result.metrics_history[:-1]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            reported + [final["loss"]],
            actor_run["losses"] + actor_run["losses"][-1:], strict=True))
        # The checkpoint restored into other weights, one step in here.
        model = GPT2(cfg, seed=2)
        opt = lm_opt()
        state = init_train_state(model, opt)
        step = make_train_step(gpt2_loss_fn(ce_chunk=2048), opt,
                               grad_norm=False)
        restore_train_state(os.path.join(result.checkpoint_dir, "state"),
                            state)
        batch = device_batch(*host, next(model.parameters()).device)
        with contextlib.nullcontext() if CAPTURE else disable_capture():
            restored = float(step(state, batch)[1]["loss"])
        del model, opt, state, step, batch
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    print(f"runtime (d) TorchTrainer.fit(), 1 worker x 1 GPU "
          f"({final['backend']} on {final['device']}): reported losses "
          f"{reported}, Result loss {final['loss']} vs the actor's last "
          f"{actor_run['losses'][-1]} (relative {rel:.3g}, limit "
          f"{CAPTURE_LOSS_RTOL}); step {final['step_ms']:.2f} ms vs "
          f"in-process {ref_run['step_ms']:.2f} ms "
          f"({final['step_ms'] / ref_run['step_ms'] - 1:+.2%}); "
          f"compile_count {final['compile_count']}; launches "
          f"{final['counts']}; the checkpoint restored into other weights: "
          f"next loss {restored} vs the trainer's {final['next_loss']}, "
          f"bit-equal {restored == final['next_loss']}; fit() to the first "
          f"report {first_s:.1f} s (to the loop's start "
          f"{final['t_start'] - t_fit:.1f} s: the gang's placement, the "
          f"worker's start, its NCCL group; the model and its weights "
          f"{final['t_weights'] - final['t_start']:.1f} s; the first step "
          f"with its capture {t_first - final['t_weights']:.1f} s), whole "
          f"fit() {fit_s:.1f} s; card {card}", flush=True)
    check(rel <= CAPTURE_LOSS_RTOL, "the trainer's losses match the "
          "actor's")
    check(final["backend"] == "nccl" and final["compile_count"] ==
          want_captures and final["donated"],
          "the trainer's rank is NCCL and its step captured once")
    check_counts({"n_steps": CAPTURE_STEPS, "counts": final["counts"]},
                 {name: n for name in SQUARE}, "the TorchTrainer worker")
    check(restored == final["next_loss"], "the trainer's checkpoint "
          "restores bit-equal")

    # (e) Host rates.
    noop_task = rt.remote(noop)
    rt.get([noop_task.remote() for _ in range(100)])
    t0 = time.perf_counter()
    rt.get([noop_task.remote() for _ in range(RUNTIME_TASKS)])
    tasks_s = RUNTIME_TASKS / (time.perf_counter() - t0)
    counter = rt.remote(Pinger).remote()
    rt.get(counter.ping.remote())
    t0 = time.perf_counter()
    rt.get([counter.ping.remote() for _ in range(RUNTIME_ACTOR_CALLS)])
    calls_s = RUNTIME_ACTOR_CALLS / (time.perf_counter() - t0)
    rt.shutdown()
    print(f"runtime (e) host rates: {RUNTIME_TASKS} no-op tasks "
          f"{tasks_s:.1f}/s, {RUNTIME_ACTOR_CALLS} calls to one actor "
          f"{calls_s:.1f}/s; card {card}", flush=True)
    rebuilt = [name for name, t in libs.items()
               if os.path.getmtime(build.lib_path(name)) != t]
    check(not rebuilt, f"the workers loaded the kernels the driver built "
          f"(rebuilt: {rebuilt})")
    return {"first_s": first_s, "fit_s": fit_s}


# -- phase 15: the Data feed -------------------------------------------------


def data_rows(vocab: int) -> np.ndarray:
    """DATA_STEPS x TRAIN_BATCH rows of TRAIN_SEQ + 1 token ids, seed 0."""
    return np.random.default_rng(0).integers(
        0, vocab, (DATA_STEPS * TRAIN_BATCH, TRAIN_SEQ + 1))


def data_batches(rows: np.ndarray) -> list[dict]:
    """The LM batches of ``rows``, straight from numpy."""
    toks = rows.astype(np.int32)
    return [{"tokens": toks[i:i + TRAIN_BATCH, :-1],
             "targets": toks[i:i + TRAIN_BATCH, 1:]}
            for i in range(0, len(toks), TRAIN_BATCH)]


def lm_batch(batch: dict) -> dict:
    """The pipeline's map_batches function: a block's token rows (one
    list a row, as read_tfrecords gives a multi-value feature) as the
    LM's int32 tokens and targets."""
    toks = np.stack(batch["tokens"])
    return {"tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32)}


def block_probe(batch: dict) -> dict:
    """A map_batches probe: what a block task's worker has loaded and
    which cards it sees."""
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & {"torch", "jax", "ray_tpu"})
    n = len(batch["tokens"])
    return {"loaded": np.asarray([",".join(loaded)] * n),
            "cuda": np.asarray([os.environ.get("CUDA_VISIBLE_DEVICES",
                                               "unset")] * n)}


def batch_sums(batch) -> list[int]:
    """int64 sums of a batch's tokens and targets (numpy or tensors)."""
    return [int(batch[k].to(torch.int64).sum()) if isinstance(
        batch[k], torch.Tensor) else int(batch[k].astype(np.int64).sum())
        for k in ("tokens", "targets")]


def fed_steps(weights: dict, feed, timed_from: int = 1) -> dict:
    """GPT-2 124M from ``weights`` through ``make_train_step`` with the
    LM optimizer, one step a batch of ``feed`` (an iterator of batches on
    the card, with its ``DevicePrefetcher`` as ``feed.prefetcher`` or
    ``feed`` itself): the losses, each batch (a copy on the card), the
    launch counts (counts set to 0 just before, read just after), and the
    host clock and input stall over the steps after ``timed_from``, the
    first of which warms up and captures the step."""
    pf = getattr(feed, "prefetcher", feed)
    model = GPT2(GPT2Config.small(), seed=1)
    load_weights(model, weights)
    opt = lm_opt()
    state = init_train_state(model, opt)
    step = make_train_step(gpt2_loss_fn(ce_chunk=2048), opt,
                           grad_norm=False)
    losses, seen = [], []
    fa.reset_launch_counts()
    for i, batch in enumerate(feed):
        if i == timed_from:
            torch.cuda.synchronize()
            t0, stall0 = time.perf_counter(), pf.stall_s
        seen.append({k: v.clone() for k, v in batch.items()})
        losses.append(step(state, batch)[1]["loss"])
    losses = [float(x) for x in losses]     # waits for the device
    wall = time.perf_counter() - t0
    run = {"losses": losses, "seen": seen, "counts": fa.launch_counts(),
           "n_steps": len(losses), "compile_count": compile_count(step),
           "donated": buffers_donated(step, state),
           "step_ms": wall / (len(losses) - timed_from) * 1e3,
           "stall_s": pf.stall_s - stall0, "wall_s": wall,
           "produce_s": pf.produce_s, "batches": pf.batches}
    del model, opt, state, step
    torch.cuda.empty_cache()
    return run


def data_trainer_loop(config: dict) -> None:
    """TorchTrainer's loop on the Data feed: one NCCL rank, GPT-2 124M
    from the weights in the object store, one step a batch of
    ``get_dataset_shard("train").iter_device_batches``, each step's loss
    and batch checksums reported."""
    import ray_tpu_torch
    from ray_tpu_torch import train
    t_start = time.time()
    dev = initialize()
    model = GPT2(GPT2Config.small(), seed=1, device=dev)
    load_weights(model, ray_tpu_torch.get(config["weights"]))
    opt = lm_opt()
    state = init_train_state(model, opt)
    step = make_train_step(gpt2_loss_fn(ce_chunk=2048), opt,
                           grad_norm=False)
    feed = train.get_dataset_shard("train").iter_device_batches(TRAIN_BATCH)
    fa.reset_launch_counts()
    for batch in feed:
        sums = batch_sums(batch)
        loss = float(step(state, batch)[1]["loss"])
        train.report({"loss": loss, "sums": sums, "t": time.time()})
    pf = feed.prefetcher
    train.report({"counts": fa.launch_counts(),
                  "compile_count": compile_count(step),
                  "donated": buffers_donated(step, state),
                  "stall_s": pf.stall_s, "produce_s": pf.produce_s,
                  "backend": dist.get_backend(), "device": str(dev),
                  "t_start": t_start, "t": time.time()})


@contextlib.contextmanager
def python_tfrecord_reader():
    """``data.tfrecord.read_records`` through its pure-Python codec."""
    from ray_tpu_torch.native import tfrec
    get_lib = tfrec.get_lib
    tfrec.get_lib = lambda: None
    try:
        yield
    finally:
        tfrec.get_lib = get_lib


def data_phase(card: str, main_run: dict, runtime: dict) -> None:
    """Phase 15: the Data library on the port's runtime feeding GPT-2
    124M, in this process and through TorchTrainer(datasets=)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    from ray_tpu_torch.data import tfrecord
    from ray_tpu_torch.native import tfrec
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    cfg = GPT2Config.small()
    rows = data_rows(cfg.vocab_size)
    want = data_batches(rows)
    want_sums = [batch_sums(b) for b in want]
    n = cfg.n_layer
    want_captures = 1 if CAPTURE else None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as d:
        # (a) The files, and both TFRecord readers on them.
        t0 = time.perf_counter()
        for f, part in enumerate(np.array_split(rows, DATA_FILES)):
            tfrecord.write_records(
                os.path.join(d, f"part-{f:05d}.tfrecord"),
                [tfrecord.build_example({"tokens": r.tolist()})
                 for r in part])
        write_s = time.perf_counter() - t0
        paths = sorted(os.path.join(d, f) for f in os.listdir(d))
        file_mb = sum(os.path.getsize(p) for p in paths) / 1e6
        check(tfrec.get_lib() is not None, "the native TFRecord scanner "
              "(native/tfrec.cpp) built and loaded")
        t0 = time.perf_counter()
        native = [list(tfrecord.read_records(p, verify=True)) for p in paths]
        native_s = time.perf_counter() - t0
        with python_tfrecord_reader():
            t0 = time.perf_counter()
            python = [list(tfrecord.read_records(p, verify=True))
                      for p in paths]
            python_s = time.perf_counter() - t0
        check(native == python and sum(map(len, native)) == len(rows),
              "the native and Python readers give the same records")
        print(f"data (a) {len(rows)} rows of {TRAIN_SEQ + 1} token ids in "
              f"{DATA_FILES} TFRecord files, {file_mb:.1f} MB, written in "
              f"{write_s:.2f} s; read with CRCs checked: native scanner "
              f"{file_mb / native_s:.1f} MB/s, Python codec "
              f"{file_mb / python_s:.1f} MB/s, the same records; card "
              f"{card}", flush=True)

        # (b) The pipeline alone.
        rt.init()
        try:
            ds = data.read_tfrecords(d).map_batches(lm_batch)
            passes = []
            for _ in range(2):      # the first pass starts the workers
                t0 = time.perf_counter()
                got = list(ds.iterator().iter_batches(TRAIN_BATCH,
                                                      drop_last=True))
                passes.append(time.perf_counter() - t0)
                check(len(got) == DATA_STEPS and all(
                    g[k].dtype == np.int32 and np.array_equal(g[k], w[k])
                    for g, w in zip(got, want) for k in w),
                    "the pipeline's batches are the numpy batches, in order")
            probes = data.read_tfrecords(d).map_batches(block_probe
                                                        ).take_all()
            seen = {(p["loaded"], p["cuda"]) for p in probes}
            out_mb = sum(v.nbytes for b in want for v in b.values()) / 1e6
            print(f"data (b) read_tfrecords -> map_batches(lm) -> "
                  f"iter_batches({TRAIN_BATCH}): the numpy batches "
                  f"bit-equal; {len(rows) / passes[1]:.1f} rows/s, "
                  f"{file_mb / passes[1]:.1f} MB/s of files, "
                  f"{out_mb / passes[1]:.1f} MB/s of batches ({passes[1]:.2f}"
                  f" s; the first pass, workers starting, {passes[0]:.2f} s);"
                  f" block workers loaded {sorted(seen)} (modules, "
                  f"CUDA_VISIBLE_DEVICES); card {card}", flush=True)
            check(seen == {("", "")}, "block tasks run in workers without "
                  "torch, jax or ray_tpu that see no card")

            # (c) In process: the Data feed against the numpy feed.
            model = GPT2(cfg, seed=0)
            weights = numpy_weights(model)
            del model
            torch.cuda.empty_cache()
            dev = default_device()
            numpy_run = fed_steps(weights, prefetch_to_device(iter(want), dev))
            data_run = fed_steps(weights,
                                 ds.iterator().iter_device_batches(
                                     TRAIN_BATCH))
        finally:
            rt.shutdown()
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            data_run["losses"], numpy_run["losses"], strict=True))
        equal = all(torch.equal(g[k].cpu(), torch.from_numpy(w[k]))
                    for g, w in zip(data_run["seen"], want) for k in w)
        stall_share = data_run["stall_s"] / data_run["wall_s"]
        print(f"data (c) GPT-2 124M B={TRAIN_BATCH} T={TRAIN_SEQ}, "
              f"{DATA_STEPS} steps fed by iter_device_batches: losses "
              f"{data_run['losses']} vs fed numpy through prefetch_to_device "
              f"{numpy_run['losses']}, bit-equal "
              f"{data_run['losses'] == numpy_run['losses']}, largest relative "
              f"difference {rel:.3g} (limit {CAPTURE_LOSS_RTOL}); batches on "
              f"the card bit-equal to numpy {equal}; step "
              f"{data_run['step_ms']:.2f} ms vs the numpy feed's "
              f"{numpy_run['step_ms']:.2f} ms and phase 4's static batch "
              f"{main_run['step_ms']:.2f} ms (over steps 2-{DATA_STEPS}); "
              f"input stall {data_run['stall_s'] * 1e3:.2f} ms of "
              f"{data_run['wall_s'] * 1e3:.1f} ({stall_share:.2%}; the numpy "
              f"feed's {numpy_run['stall_s'] * 1e3:.2f} ms), produce_s "
              f"{data_run['produce_s']:.3f} s for {data_run['batches']} "
              f"batches (the numpy feed's {numpy_run['produce_s']:.3f} s); "
              f"compile_count {data_run['compile_count']}; launches "
              f"{data_run['counts']}; card {card}", flush=True)
        check(rel <= CAPTURE_LOSS_RTOL, "the Data feed's losses match the "
              "numpy feed's")
        check(equal, "the Data feed's batches are the numpy batches")
        for run in (data_run, numpy_run):
            check(run["n_steps"] == DATA_STEPS
                  and run["compile_count"] == want_captures
                  and run["donated"], f"{DATA_STEPS} steps, captured "
                  f"{want_captures} time(s), buffers donated")
            check_counts(run, {name: n for name in SQUARE},
                         "the Data feed" if run is data_run else
                         "the numpy feed")

        # (d) TorchTrainer(datasets=) with one NCCL worker on the card.
        storage = tempfile.mkdtemp(prefix="chip_smoke_data_train_")
        rt.init()
        try:
            ds = data.read_tfrecords(d).map_batches(lm_batch)
            trainer = TorchTrainer(
                data_trainer_loop,
                train_loop_config={"weights": rt.put(weights)},
                datasets={"train": ds},
                scaling_config=ScalingConfig(num_workers=1,
                                             gpus_per_worker=1),
                run_config=RunConfig(name="gpt2_data", storage_path=storage))
            t_fit = time.time()
            result = trainer.fit()
            fit_s = time.time() - t_fit
        finally:
            rt.shutdown()
            shutil.rmtree(storage, ignore_errors=True)
    check(result.error is None, f"fit() failed: {result.error}")
    steps, final = result.metrics_history[:-1], result.metrics
    first_s = steps[0]["t"] - t_fit if steps else float("nan")
    losses = [m["loss"] for m in steps]
    rel = max(abs(a - b) / abs(b) for a, b in zip(
        losses, numpy_run["losses"], strict=True))
    print(f"data (d) TorchTrainer(datasets={{'train': ds}}).fit(), 1 worker "
          f"x 1 GPU ({final['backend']} on {final['device']}), each rank "
          f"reading get_dataset_shard('train').iter_device_batches("
          f"{TRAIN_BATCH}): batch checksums equal to numpy's "
          f"{[m['sums'] for m in steps] == want_sums}; losses {losses} vs the "
          f"numpy feed's (relative {rel:.3g}, limit {CAPTURE_LOSS_RTOL}); "
          f"compile_count {final['compile_count']}; launches "
          f"{final['counts']}; input stall {final['stall_s'] * 1e3:.2f} ms, "
          f"produce_s {final['produce_s']:.3f} s; fit() to the first report "
          f"{first_s:.1f} s (to the loop's start "
          f"{final['t_start'] - t_fit:.1f} s), whole fit() {fit_s:.1f} s "
          f"(phase 14's: {runtime['first_s']:.1f} s and "
          f"{runtime['fit_s']:.1f} s); card {card}", flush=True)
    check([m["sums"] for m in steps] == want_sums, "each trainer batch's "
          "checksums are the numpy batch's")
    check(rel <= CAPTURE_LOSS_RTOL, "the trainer's losses match the numpy "
          "feed's")
    check(final["backend"] == "nccl" and final["compile_count"] ==
          want_captures and final["donated"],
          "the trainer's rank is NCCL and its step captured once")
    check_counts({"n_steps": DATA_STEPS, "counts": final["counts"]},
                 {name: n for name in SQUARE}, "the TorchTrainer Data feed")


# -- phase 17: Serve ---------------------------------------------------------


def serve_requests(n: int, vocab: int, seed: int = 0,
                   lengths: tuple[int, int] = SERVE_LENGTHS) -> list[dict]:
    """``n`` requests ``{"id", "tokens"}`` (int32), lengths uniform in
    ``lengths`` (inclusive), from numpy ``seed``."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lengths[0], lengths[1] + 1, n)
    return [{"id": i, "tokens": rng.integers(0, vocab, k).astype(np.int32)}
            for i, k in enumerate(lengths)]


def pad_batch(seqs, left: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """A batch's ``[B, T]`` int32 tokens, padded with 0 to its longest
    request rounded up to PAD_MULTIPLE, and each row's last valid
    position. Right padding leaves a causal forward's valid rows as they
    are; ``left`` (the planted fault ``serve_left_pad``) pads in front."""
    t = -(-max(len(s) for s in seqs) // PAD_MULTIPLE) * PAD_MULTIPLE
    tokens = np.zeros((len(seqs), t), np.int32)
    last = np.empty(len(seqs), np.int64)
    for i, seq in enumerate(seqs):
        if left:
            tokens[i, t - len(seq):], last[i] = seq, t - 1
        else:
            tokens[i, :len(seq)], last[i] = seq, len(seq) - 1
    return tokens, last


def last_logits(model, tokens, last):
    """GPT-2's float32 logits at each row's position ``last`` (``[B,
    vocab]``): the LM head on those rows only."""
    h = model(tokens, return_hidden=True)
    rows = h[torch.arange(len(last), device=h.device), last]
    dt = model.config.dtype
    return matmul_f32(rows.to(dt), model.wte.weight.to(dt).t())


def logits_of(model, tokens: np.ndarray, last: np.ndarray) -> np.ndarray:
    dev = model.wte.weight.device
    with torch.inference_mode():
        return last_logits(model, torch.from_numpy(tokens).to(dev),
                           torch.from_numpy(last).to(dev)).cpu().numpy()


class GPT2Server:
    """The deployment of phase 17 (user code): GPT-2 124M on the card
    the replica holds (``default_device()``, which raises without one),
    its weights from the object store. Each ``@serve.batch`` batch is one
    forward of the right-padded batch under ``inference_mode`` (entered
    in the batch's worker thread, where the forward runs). A request gets
    back its last valid position's float32 logits (numpy), the top-1 id
    and the batch's signature: the request ids in order, the padded T,
    the replica's pid and card and the flash launches of that forward."""

    def __init__(self, weights, left_pad: bool = False):
        import ray_tpu_torch
        t_init = time.time()
        t0 = time.perf_counter()
        self.left_pad = left_pad
        self.model = GPT2(GPT2Config.small(), seed=1)   # other weights ...
        load_weights(self.model, ray_tpu_torch.get(weights))  # ... replaced
        self.dev = self.model.wte.weight.device
        t1 = time.perf_counter()
        # Warm every padded length the batches can have, at a full batch.
        with torch.inference_mode():
            for t in range(PAD_MULTIPLE, SERVE_LENGTHS[1] + 1, PAD_MULTIPLE):
                last_logits(self.model, torch.zeros(
                    SERVE_BATCH, t, dtype=torch.int32, device=self.dev),
                    torch.full((SERVE_BATCH,), t - 1, device=self.dev))
            # The ops of one full batch's forward, as the profiler sees
            # them: the attention is the flash kernel's op, not SDPA.
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                last_logits(self.model, torch.zeros(
                    SERVE_BATCH, SERVE_LENGTHS[1], dtype=torch.int32,
                    device=self.dev), torch.full(
                        (SERVE_BATCH,), SERVE_LENGTHS[1] - 1, device=self.dev))
        torch.cuda.synchronize()
        # (An attribute named "ops" would make cloudpickle ship the
        # unpicklable torch.ops module with this class.)
        self.attention_ops = sorted({e.key for e in prof.key_averages()
                                     if "attention" in e.key
                                     or "flash" in e.key})
        fa.reset_launch_counts()
        self.info = {"pid": os.getpid(),
                     "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                     "device": str(self.dev),
                     "card": str(torch.cuda.get_device_properties(
                         self.dev).uuid),
                     "model_s": t1 - t0, "warm_s": time.perf_counter() - t1,
                     "t_init": t_init, "t_ready": time.time()}

    @serve.batch(max_batch_size=SERVE_BATCH, batch_wait_timeout_s=SERVE_WAIT_S)
    def forward(self, reqs):
        tokens, last = pad_batch([r["tokens"] for r in reqs], self.left_pad)
        before = fa.launch_counts()
        logits = logits_of(self.model, tokens, last)
        after = fa.launch_counts()
        sig = {"ids": [r["id"] for r in reqs], "T": int(tokens.shape[1]),
               "pid": self.info["pid"], "card": self.info["card"],
               "launches": {k: after[k] - before[k] for k in after
                            if after[k] != before[k]}}
        return [{"id": r["id"], "logits": logits[i],
                 "top1": int(logits[i].argmax()), "batch": sig}
                for i, r in enumerate(reqs)]

    def __call__(self, request):
        out = self.forward(request)
        if isinstance(request["tokens"], list):      # over HTTP: JSON
            out = dict(out, logits=out["logits"].tolist())
        return out

    def stats(self) -> dict:
        """The replica's card, start-up times, the attention ops of one
        forward, and the launches since its warm-up ended."""
        return dict(self.info, attention_ops=self.attention_ops,
                    counts=fa.launch_counts())


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def drive(call, reqs: list[dict], callers: int) -> dict:
    """Every request through ``call`` from ``callers`` threads at once
    (each takes the next request when its last is answered): responses in
    request order, per-request latency, requests/s, tokens/s (prompt
    tokens), p50 and p99 latency and the mean batch size."""
    out, lat, errors = [None] * len(reqs), [0.0] * len(reqs), []
    nxt, lock = iter(range(len(reqs))), threading.Lock()

    def caller():
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            t = time.perf_counter()
            try:
                out[i] = call(reqs[i])
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                return
            lat[i] = time.perf_counter() - t

    threads = [threading.Thread(target=caller) for _ in range(callers)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    batches = {(o["batch"]["pid"], tuple(o["batch"]["ids"])) for o in out}
    ms = np.asarray(lat) * 1e3
    return {"responses": out, "wall": wall, "rps": len(reqs) / wall,
            "tps": sum(len(r["tokens"]) for r in reqs) / wall,
            "p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99)),
            "mean_batch": len(reqs) / len(batches), "batches": batches}


def forward_times(model, b: int, n: int) -> dict:
    """The in-process forward of ``b`` requests of ``n`` tokens, padded as
    the replica pads them, run as the replica's batch runs it
    (``logits_of``: tokens in, forward, logits out), one call at a time:
    its mean time on the host clock over 20 calls, and the card's busy
    time in it (the device time torch.profiler records over 5 calls, None
    where it records none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tokens, last = pad_batch([np.zeros(n, np.int32)] * b)
    logits_of(model, tokens, last)
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        logits_of(model, tokens, last)
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)     # as in profile_dispatch
        for _ in range(5):
            logits_of(model, tokens, last)
        time.sleep(PROFILE_MARGIN_S)
    busy_us = sum(getattr(e, "self_device_time_total", 0.0)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return {"T": tokens.shape[1], "wall_ms": float(np.mean(walls)) * 1e3,
            "busy_ms": busy_us / 5e3 if busy_us else None}


def describe_forward(f: dict) -> str:
    if f["busy_ms"] is None:
        return (f"host clock {f['wall_ms']:.3f} ms, device busy not "
                f"measured")
    return (f"host clock {f['wall_ms']:.3f} ms, device busy "
            f"{f['busy_ms']:.3f} ms of it ({f['busy_ms'] / f['wall_ms']:.1%})")


def describe_leg(leg: dict) -> str:
    return (f"{leg['rps']:.2f} requests/s, {leg['tps']:.0f} tokens/s, p50 "
            f"{leg['p50']:.2f} ms, p99 {leg['p99']:.2f} ms, mean batch "
            f"{leg['mean_batch']:.2f} ({len(leg['batches'])} batches) in "
            f"{leg['wall']:.2f} s")


class Reference:
    """The driver's in-process GPT-2 (the replicas' weights, seed 0, on
    cuda:0): each served batch recomputed (cached by its signature) and
    each request run alone, batch 1, unpadded."""

    def __init__(self, model, reqs: list[dict]):
        self.model, self.reqs = model, {r["id"]: r["tokens"] for r in reqs}
        self.batches: dict[tuple, np.ndarray] = {}
        self.alone: dict[int, np.ndarray] = {}

    def batch(self, ids: tuple, t: int) -> np.ndarray:
        if (ids, t) not in self.batches:
            tokens, last = pad_batch([self.reqs[i] for i in ids])
            check(tokens.shape[1] == t, f"batch {ids} padded to {t}")
            self.batches[(ids, t)] = logits_of(self.model, tokens, last)
        return self.batches[(ids, t)]

    def single(self, i: int) -> np.ndarray:
        if i not in self.alone:
            seq = self.reqs[i]
            self.alone[i] = logits_of(self.model, seq[None], np.asarray(
                [len(seq) - 1]))[0]
        return self.alone[i]


def serve_readings(legs: list[list[dict]], ref: Reference) -> dict:
    """(b) and (c) over the responses of one or more runs (``legs``):
    bit-equality with each batch recomputed in process, the worst |served
    - alone| / rms(alone), top-1 against the logits' argmax, and the
    launches of every batch, keyed by (run, replica pid, request ids)."""
    unequal, worst_batch, worst_alone, top1, n = 0, 0.0, 0.0, True, 0
    launches = {}
    vocab = GPT2Config.small().vocab_size
    for k, responses in enumerate(legs):
        for o in responses:
            n += 1
            sig = o["batch"]
            got = np.asarray(o["logits"], dtype=np.float32)
            want = ref.batch(tuple(sig["ids"]), sig["T"])[
                sig["ids"].index(o["id"])]
            if not np.array_equal(got.view(np.int32), want.view(np.int32)):
                unequal += 1
                worst_batch = max(worst_batch,
                                  float(np.abs(got - want).max()))
            alone = ref.single(o["id"])
            rms = float(np.sqrt(np.mean(alone.astype(np.float64) ** 2)))
            worst_alone = max(worst_alone,
                              float(np.abs(got - alone).max()) / rms)
            top1 = (top1 and got.shape == (vocab,)
                    and bool(np.isfinite(got).all())
                    and o["top1"] == int(got.argmax()))
            launches[(k, sig["pid"], tuple(sig["ids"]))] = sig["launches"]
    return {"n": n, "unequal": unequal, "worst_batch": worst_batch,
            "worst_alone": worst_alone, "top1": top1, "launches": launches}


def batches_of(r: dict, pid: int) -> int:
    """Batches that replica ``pid`` served in readings ``r``."""
    return sum(1 for _, p, _ in r["launches"] if p == pid)


def describe_readings(r: dict) -> str:
    n = GPT2Config.small().n_layer
    bad = [v for v in r["launches"].values() if v != {"flash_fwd": n}]
    return (f"{r['n']} responses: {r['n'] - r['unequal']} bit-equal to their "
            f"batch recomputed in process (worst |diff| {r['worst_batch']:.3g})"
            f"; against each request alone (batch 1, unpadded) worst "
            f"|diff| / rms {r['worst_alone']:.4g} (limit {SERVE_ALONE_TOL}); "
            f"top-1 the argmax of finite logits of the vocabulary "
            f"{r['top1']}; {len(r['launches'])} batches, each {n} flash_fwd "
            f"launches and no other: {not bad}")


def check_serve(r: dict, what: str) -> None:
    check(r["unequal"] == 0, f"{what}: every response bit-equal to its batch "
          f"recomputed in process ({r['unequal']} of {r['n']} not; worst "
          f"|diff| {r['worst_batch']:.4g})")
    check(r["worst_alone"] <= SERVE_ALONE_TOL, f"{what}: every response "
          f"within {SERVE_ALONE_TOL} rms of its request alone (worst "
          f"{r['worst_alone']:.4g})")
    check(r["top1"], f"{what}: finite logits of the vocabulary, top-1 their "
          f"argmax")
    n = GPT2Config.small().n_layer
    check(all(v == {"flash_fwd": n} for v in r["launches"].values()),
          f"{what}: {n} flash_fwd launches a batch (one a layer) and no "
          f"backward")


def check_replica(stats: dict, cuda_visible: str, batches: int,
                  what: str) -> None:
    """(c) in the replica: on its card, the flash op in the forward and
    no SDPA, one flash_fwd launch a layer a batch served, no backward
    launch."""
    check(stats["device"] == "cuda:0" and stats["cuda_visible"] ==
          cuda_visible, f"{what}: the replica holds its card "
          f"(CUDA_VISIBLE_DEVICES {stats['cuda_visible']}, {stats['device']})")
    ops = stats["attention_ops"]
    check("ray_tpu_torch::flash_fwd" in ops and not any(
        "scaled_dot_product" in op for op in ops),
        f"{what}: the forward's attention is the flash op, no SDPA ({ops})")
    n = GPT2Config.small().n_layer
    want = {name: n * batches if name == "flash_fwd" else 0
            for name in stats["counts"]}
    check(stats["counts"] == want, f"{what}: launches since the warm-up "
          f"{stats['counts']}, want {want}")


def http_call(port: int):
    import urllib.request

    def call(req: dict) -> dict:
        body = json.dumps({"id": req["id"],
                           "tokens": req["tokens"].tolist()}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/", data=body, headers={
                    "Content-Type": "application/json"}), timeout=120) as r:
            return json.loads(r.read())
    return call


def handle_call(handle):
    return lambda req: handle.remote(req).result(timeout_s=120)


def replica_stats(rt, name: str) -> list[dict]:
    """stats() of every replica of deployment ``name``, straight from the
    controller's replica handles."""
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME
    controller = rt.get_actor(CONTROLLER_NAME)
    _, replicas = rt.get(controller.get_replicas.remote(name), timeout=60)
    return [rt.get(r.handle_request.remote("stats", (), {}), timeout=60)
            for r in replicas]


def serve_phase(card: str, dev, fault: str | None = None) -> dict:
    """Phase 17 (module docstring). With ``fault`` (``serve_left_pad``),
    only (a) and (b) on the first requests, and (b) must fail it."""
    import ray_tpu_torch as rt
    cfg = GPT2Config.small()
    model = GPT2(cfg, seed=0)
    weights = numpy_weights(model)
    reqs = serve_requests(SERVE_REQUESTS, cfg.vocab_size)
    ref = Reference(model, reqs)
    kernel_row = None if fault else kernel_phase(SERVE_BATCH,
                                                 SERVE_LENGTHS[1], dev)
    rt.init()
    try:
        return serve_legs(rt, card, weights, reqs, ref, kernel_row, fault)
    finally:
        serve.shutdown()
        rt.shutdown()


def serve_legs(rt, card, weights, reqs, ref, kernel_row, fault):
    from ray_tpu_torch.serve.replica import Replica
    weights_ref = rt.put(weights)
    # (a') No CPU fallback: a replica that holds no card cannot start.
    nocard = Replica.options(num_cpus=0).remote(GPT2Server, (weights_ref,),
                                                {}, "gpt2#nocard")
    try:
        rt.get(nocard.handle_request.remote("stats", (), {}), timeout=300)
        refused = "started"
    except Exception as e:  # noqa: BLE001 — the replica's start failed
        refused = str(e)
    rt.kill(nocard)
    said = [line for line in refused.splitlines() if "CUDA" in line]
    print(f"serve (a) a GPT2Server replica without a card refuses to start: "
          f"{'no CUDA device' in refused} ({(said or [refused])[-1][:200]})",
          flush=True)
    check("no CUDA device" in refused, "a replica without a card refuses "
          "to start (no CPU fallback)")

    # (a) Start: serve.run to the first answer, HTTP ingress on.
    try:
        import aiohttp  # noqa: F401 — the proxy's server
        port = free_port()
    except ImportError:
        port = None
        print("serve: aiohttp does not import on this machine, so no HTTP "
              "proxy and no HTTP leg (an optional dependency of the JAX "
              "package's Serve too)", flush=True)
    app = serve.deployment(GPT2Server).options(
        name="gpt2", ray_actor_options={"num_gpus": 1}).bind(
            weights_ref, left_pad=fault == "serve_left_pad")
    t0, t_run = time.perf_counter(), time.time()
    handle = serve.run(app, name="gpt2", http_port=port)
    t_returned = time.time()
    first = handle.remote(reqs[0]).result(timeout_s=300)
    start_s = time.perf_counter() - t0
    (stats,) = replica_stats(rt, "gpt2")
    print(f"serve (a) GPT-2 124M behind a num_gpus=1 replica (pid "
          f"{stats['pid']}, CUDA_VISIBLE_DEVICES {stats['cuda_visible']}, "
          f"{stats['device']}): serve.run to the first answer "
          f"{start_s:.2f} s: to the replica's __init__ "
          f"{stats['t_init'] - t_run:.2f} s (the controller, the worker's "
          f"start, its imports and the class's unpickling), __init__ "
          f"{stats['t_ready'] - stats['t_init']:.2f} s (the model and its "
          f"weights {stats['model_s']:.2f} s, the warm-up of "
          f"{SERVE_LENGTHS[1] // PAD_MULTIPLE} padded lengths at batch "
          f"{SERVE_BATCH} and one profiled forward {stats['warm_s']:.2f} s), "
          f"then to serve.run's return {t_returned - stats['t_ready']:.2f} s "
          f"(readiness probe, routing table); "
          f"attention ops of a forward {stats['attention_ops']}; card "
          f"{card}",
          flush=True)
    check(first["id"] == 0, "the first answer is the first request's")

    if fault:
        leg = drive(handle_call(handle), reqs[:SERVE_HALF_REQUESTS], 8)
        r = serve_readings([leg["responses"]], ref)
        print(f"serve (b) with the fault {fault}: {describe_readings(r)}; "
              f"card {card}", flush=True)
        return r

    # (d) Load through the handle, then (b) and (c) on every response.
    legs = {}
    for callers in SERVE_CALLERS:
        legs[callers] = leg = drive(handle_call(handle), reqs, callers)
        print(f"serve (d) {len(reqs)} requests through the handle at "
              f"{callers} caller(s): {describe_leg(leg)}; card {card}",
              flush=True)
    full = forward_times(ref.model, SERVE_BATCH, SERVE_LENGTHS[1])
    floor_ms = full["wall_ms"]
    mean_len = round(float(np.mean([len(r["tokens"]) for r in reqs])))
    alone = forward_times(ref.model, 1, mean_len)
    print(f"serve (d) the in-process forward, one call at a time as the "
          f"replica runs it (tokens in, forward, logits out): a full batch "
          f"({SERVE_BATCH} x {SERVE_LENGTHS[1]}) {describe_forward(full)}, "
          f"so {SERVE_BATCH / floor_ms * 1e3:.1f} requests/s at most from "
          f"one replica; one request alone at the requests' mean length "
          f"({mean_len} tokens, 1 x {alone['T']} padded) "
          f"{describe_forward(alone)}; card {card}", flush=True)
    responses = [[first]] + [leg["responses"] for leg in legs.values()]
    http = None
    if port is not None:
        http = drive(http_call(port), reqs[:SERVE_HTTP_REQUESTS], 8)
        hr = serve_readings([http["responses"]], ref)
        print(f"serve (d) {SERVE_HTTP_REQUESTS} requests over HTTP through "
              f"the proxy at 8 callers: {describe_leg(http)}; "
              f"{describe_readings(hr)}; card {card}", flush=True)
        check_serve(hr, "over HTTP")
        responses.append(http["responses"])
    r = serve_readings(responses, ref)
    print(f"serve (b), (c) {describe_readings(r)}; card {card}", flush=True)
    check_serve(r, "through the handle")
    (stats,) = replica_stats(rt, "gpt2")
    print(f"serve (c) the replica's launches since its warm-up "
          f"{stats['counts']} for {len(r['launches'])} batches; card {card}",
          flush=True)
    check_replica(stats, "0", len(r["launches"]), "the replica")
    launches = stats["counts"]["flash_fwd"]
    serve.delete("gpt2")

    # (e) Two replicas at num_gpus=0.5 on the one card.
    app = serve.deployment(GPT2Server).options(
        name="gpt2half", num_replicas=2,
        ray_actor_options={"num_gpus": 0.5}).bind(weights_ref)
    t0 = time.perf_counter()
    handle = serve.run(app, name="gpt2half")
    first = handle.remote(reqs[0]).result(timeout_s=300)
    half_start_s = time.perf_counter() - t0
    half = drive(handle_call(handle), reqs[:SERVE_HALF_REQUESTS], 32)
    # The rate beside (d)'s single replica, on the same SERVE_REQUESTS.
    half_rate = drive(handle_call(handle), reqs, 32)
    hr = serve_readings([[first], half["responses"],
                         half_rate["responses"]], ref)
    served = {}
    for o in half["responses"]:
        served[o["batch"]["pid"]] = served.get(o["batch"]["pid"], 0) + 1
    stats = replica_stats(rt, "gpt2half")
    print(f"serve (e) two replicas at num_gpus=0.5 on the one card (started "
          f"in {half_start_s:.2f} s; CUDA_VISIBLE_DEVICES "
          f"{[s['cuda_visible'] for s in stats]}): requests per replica "
          f"{sorted(served.values())} of {SERVE_HALF_REQUESTS} at 32 "
          f"callers; {len(reqs)} requests at 32 callers "
          f"{describe_leg(half_rate)} (one replica, (d): "
          f"{legs[32]['rps']:.2f} requests/s); {describe_readings(hr)}; card "
          f"{card}", flush=True)
    check(len(served) == 2 and min(served.values()) >= 1,
          "both half-card replicas served requests")
    check_serve(hr, "the half-card replicas")
    for st in stats:
        check_replica(st, "0", batches_of(hr, st["pid"]),
                      "a half-card replica")
    return {"start_s": start_s, "legs": legs, "http": http,
            "floor_ms": floor_ms, "alone": alone, "half": half_rate,
            "kernel": dict(kernel_row["flash_fwd"], launches=launches)}


def serve_cards_phase(n: int, card: str) -> None:
    """Phase 16's serve leg on ``n`` cards (module docstring)."""
    import ray_tpu_torch as rt
    cfg = GPT2Config.small()
    model = GPT2(cfg, seed=0)
    weights = numpy_weights(model)
    reqs = serve_requests(SERVE_CARDS_REQUESTS, cfg.vocab_size)
    ref = Reference(model, reqs)
    rt.init()
    try:
        app = serve.deployment(GPT2Server).options(
            name="gpt2cards", num_replicas=n,
            ray_actor_options={"num_gpus": 1}).bind(rt.put(weights))
        t0 = time.perf_counter()
        handle = serve.run(app, name="gpt2cards")
        first = handle.remote(reqs[0]).result(timeout_s=300)
        start_s = time.perf_counter() - t0
        leg = drive(handle_call(handle), reqs, 32)
        r = serve_readings([[first], leg["responses"]], ref)
        stats = replica_stats(rt, "gpt2cards")
        served = {s["pid"]: batches_of(r, s["pid"]) for s in stats}
        requests = {}
        for o in leg["responses"]:
            requests[o["batch"]["card"]] = requests.get(
                o["batch"]["card"], 0) + 1
        print(f"multicard serve: {n} replicas at num_gpus=1 (started in "
              f"{start_s:.2f} s) on cards {[s['card'] for s in stats]} "
              f"(CUDA_VISIBLE_DEVICES {[s['cuda_visible'] for s in stats]}); "
              f"requests per card {sorted(requests.values())}, batches per "
              f"replica {sorted(served.values())}; {len(reqs)} requests at "
              f"32 callers {describe_leg(leg)}; against card 0's in-process "
              f"recompute: {describe_readings(r)}; card {card}", flush=True)
        check(len({s["card"] for s in stats}) == n
              and sorted(s["cuda_visible"] for s in stats)
              == [str(i) for i in range(n)],
              f"{n} replicas on {n} distinct cards")
        check(len(requests) == n, "every replica served requests")
        check_serve(r, "the replicas on four cards, against card 0")
        for st in stats:
            check_replica(st, st["cuda_visible"], served[st["pid"]],
                          "a replica on its own card")
    finally:
        serve.shutdown()
        rt.shutdown()


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


def serve_fault_main(name: str, dev, card: str) -> int:
    """``--plant-fault serve_left_pad``: the build, then phase 17's (a) and
    (b) with the deployment padding its batches on the left, (b) read
    without raising. Exits 1 when (b) catches the fault (every response
    unequal to its batch recomputed, and off its request alone by more
    than SERVE_FAULT_MARGIN limits), 2 when it does not, and 2 when the run
    failed before (b)."""
    print(f"planted fault {name}: {SERVE_FAULTS[name]}", flush=True)
    try:
        t0 = time.perf_counter()
        build.ensure_built()
        print(f"build: nvcc {time.perf_counter() - t0:.1f} s", flush=True)
        r = serve_phase(card, dev, fault=name)
    except Exception:  # noqa: BLE001 — the harness failed, not (b)
        traceback.print_exc()
        print(json.dumps({"fault": name, "caught": False,
                          "failed_before_b": True}), flush=True)
        return 2
    caught = (r["unequal"] == r["n"]
              and r["worst_alone"] > SERVE_FAULT_MARGIN * SERVE_ALONE_TOL)
    print(json.dumps({"fault": name, "responses": r["n"],
                      "unequal_to_their_batch": r["unequal"],
                      "worst_alone_over_rms": r["worst_alone"],
                      "limit": SERVE_ALONE_TOL,
                      "caught_above": SERVE_FAULT_MARGIN * SERVE_ALONE_TOL,
                      "caught": caught}), flush=True)
    return 1 if caught else 2


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


# -- phase 16: the mesh routes across cards -----------------------------------


def cards_lines() -> tuple[list[str], str]:
    """Every visible card's name and power limit, and ``nvidia-smi topo
    -m`` (the links between them)."""
    names = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    nvlink = subprocess.run(["nvidia-smi", "nvlink", "-s", "-i", "0"],
                            capture_output=True, text=True, timeout=60)
    return names, "\n".join(
        f"$ nvidia-smi {' '.join(r.args[1:])} (exit {r.returncode}):\n"
        f"{(r.stdout + r.stderr).rstrip()}" for r in (topo, nvlink))


def multicard_phase(n: int, fault: str | None = None) -> bool:
    """Phase 16 on ``n`` cards (see the module docstring). Returns whether
    every check held; with ``fault``, only (c) runs, with the fault
    planted in every rank."""
    names, topo = cards_lines()
    for i, line in enumerate(names):
        print(f"multicard card {i}: {line}", flush=True)
    print(f"multicard links:\n{topo}", flush=True)
    card = f"{names[0]} x {n}"
    t0 = time.perf_counter()
    results = multicard.run(n, "full", cases=("c",) if fault else
                            multicard.CASES, fault=fault, timeout=900)
    for line in multicard.report(results, n):
        print(f"multicard {line}; card {card}", flush=True)
    readings = multicard.checks(results)
    for what, ok, reading in readings:
        print(f"multicard check {'held' if ok else 'FAILED'}: {what}: "
              f"{reading}", flush=True)
    held = all(ok for _, ok, _ in readings)
    print(f"multicard: {len(results)} ranks, cases "
          f"{[c for c in multicard.CASES if c in results[0]]} in "
          f"{time.perf_counter() - t0:.1f} s; every check held: {held}",
          flush=True)
    if fault:
        return held
    t0 = time.perf_counter()
    ranks = dryrun_multichip(n)
    print(f"multicard (i) dryrun_multichip({n}), no device named: {ranks} "
          f"in {time.perf_counter() - t0:.1f} s; card {card}", flush=True)
    held = held and (
        [r["device"] for r in ranks] == [f"cuda:{i}" for i in range(n)]
        and all(np.isfinite(r["loss"]) for r in ranks)
        and len({r["loss"] for r in ranks}) == 1)
    return held


def cards_main(n: int, fault: str | None, card: str) -> int:
    """``--cards n``: the build and phase 16, then the card line and the
    result line; with ``fault``, exit 0 only if the checks fail it."""
    have = torch.cuda.device_count()
    if have < n:
        print(f"chip_smoke: --cards {n} needs {n} GPUs, {have} visible",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    build.ensure_built()
    print(f"build: nvcc {time.perf_counter() - t0:.1f} s", flush=True)
    held = multicard_phase(n, fault)
    if fault:
        print(json.dumps({"fault": fault, "caught": not held}), flush=True)
        return 0 if not held else 1
    check(held, "phase 16: every multi-card check held")
    t16 = time.perf_counter()
    serve_cards_phase(n, card)
    print(f"multicard serve: {time.perf_counter() - t16:.1f} s; chip_smoke "
          f"--cards {n}: {time.perf_counter() - t0:.1f} s after the build "
          "began", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--plant-fault",
                        choices=sorted(FAULTS) + sorted(multicard.FAULTS)
                        + list(SERVE_FAULTS))
    parser.add_argument("--eager", action="store_true",
                        help="run every train step eagerly "
                        "(disable_capture), for the captured-vs-eager A/B")
    parser.add_argument("--cards", type=int, default=0,
                        help="run phase 16 (the mesh routes across this "
                        "many cards) instead of phases 1-15")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if args.plant_fault and (args.plant_fault in multicard.FAULTS) != bool(
            args.cards):
        parser.error("--cards takes no --plant-fault but those of "
                     "parallel.multicard.FAULTS, which need --cards")
    dev = default_device()
    card = card_line()
    print(f"card: {card}", flush=True)
    if args.cards:
        return cards_main(args.cards, args.plant_fault, card)
    if args.plant_fault in SERVE_FAULTS:
        return serve_fault_main(args.plant_fault, dev, card)
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
    mesh, plain = mesh_phase(main_run, card)
    torch.cuda.empty_cache()
    tp_phase(mesh, plain, card)
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    runtime = runtime_phase(card)
    print(f"runtime: phase 14 {time.perf_counter() - t14:.1f} s; card "
          f"{card}", flush=True)
    t15 = time.perf_counter()
    data_phase(card, main_run, runtime)
    print(f"data: phase 15 {time.perf_counter() - t15:.1f} s; card "
          f"{card}", flush=True)
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    served = serve_phase(card, dev)
    print(f"serve: phase 17 {time.perf_counter() - t17:.1f} s; card "
          f"{card}", flush=True)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s after the build "
          "began", flush=True)
    print("phase 16 (the mesh routes across cards) needs --cards 4 and four "
          f"cards; {torch.cuda.device_count()} visible here", flush=True)

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
    # The forward kernel on the serving path: timed at a full batch
    # (SERVE_BATCH x 1024), launched by the replica of phase 17 (d).
    kernels.append({"name": "flash_fwd", "route": "cuda",
                    "source": SOURCES["flash_fwd"],
                    "replaces": REPLACES["flash_fwd"], "path": "serve",
                    **served["kernel"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
