#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --plant-fault flash_fwd|flash_bwd_dq|flash_bwd_dkv

Phases, each printed as it ends; any failed check raises and the script
exits non-zero without its result line:

1. Card: name and power limit from nvidia-smi.
2. Build: every CUDA kernel of ``ray_tpu_torch/ops/cuda/csrc`` with
   nvcc (one process per source, in parallel), with ptxas' register and
   spill counts.
3. Kernels: each flash-attention kernel at GPT-2 small widths (H=12,
   D=64, bf16, causal), at T=1024 (the training shape, batch 32) and at
   T=2048 (batch 8), held against its plain PyTorch version on the same
   inputs by ``flash_attention.agreement`` (per element and overall,
   limits in ``AGREEMENT_TOL``), and timed with CUDA events beside its
   bound, the plain version and ``F.scaled_dot_product_attention`` on
   the same inputs (a yardstick only: the port never calls it).
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

Then it prints the ``kernels`` JSON line, the card line again, and as
its last line ``{"ok": true, "device": {...}}``. Exits non-zero when no
GPU is visible, and when the package is not beside it.

``--plant-fault NAME`` shows what the checks of phases 3 and 4 read on
a wrong kernel: it builds a copy of kernel NAME's source (under the
gitignored build directory, never in the source tree) in which one
64-row tile is skipped for the last query tile (``flash_fwd``,
``flash_bwd_dq``) or the last query tile is skipped for every key tile
but the diagonal ones (``flash_bwd_dkv``), binds the wrapper to it,
prints what each check reads, and exits 0 only if the kernel check
fails it at both shapes and the per-layer check on some layer.
"""

from __future__ import annotations

import argparse
import ctypes
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
import torch.nn.functional as F

from ray_tpu_torch.core.accelerator import default_device
from ray_tpu_torch.models import GPT2, GPT2Config
from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
from ray_tpu_torch.ops.cuda import build
from ray_tpu_torch.ops.cuda import flash_attention as fa
from ray_tpu_torch.train import (
    adamw,
    init_train_state,
    make_multi_train_step,
    prefetch_to_device,
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

H, D = 12, 64
SHAPES = ((32, 1024), (8, 2048))   # (batch, seq)
TRAIN_BATCH, TRAIN_SEQ = 32, 1024
K_STEPS = 2                        # optimizer steps per dispatch
TIMED_DISPATCHES = 3

SOURCES = {
    "flash_fwd": "ray_tpu_torch/ops/cuda/csrc/flash_fwd.cu",
    "flash_bwd_dq": "ray_tpu_torch/ops/cuda/csrc/flash_bwd_dq.cu",
    "flash_bwd_dkv": "ray_tpu_torch/ops/cuda/csrc/flash_bwd_dkv.cu",
}
# The TPU kernel each replaces on the training path (T=1024 runs the
# single-block Pallas kernels; T=2048 the streaming ones, :77/:218/:255).
REPLACES = {
    "flash_fwd": "ray_tpu/ops/pallas/flash_attention.py:122",
    "flash_bwd_dq": "ray_tpu/ops/pallas/flash_attention.py:296",
    "flash_bwd_dkv": "ray_tpu/ops/pallas/flash_attention.py:296",
}
# --plant-fault: (text of the source, the same text with the fault).
_KT_LOOP = "for (int j = 0; j < n_kt; ++j) {\n"
_QT_LOOP = "for (int iq = first; iq < n_qt; ++iq) {\n"
FAULTS = {
    "flash_fwd": (_KT_LOOP, _KT_LOOP
                  + "    if (j == 3 && q0 + kTile >= seq) continue;\n"),
    "flash_bwd_dq": (_KT_LOOP, _KT_LOOP
                     + "    if (j == 3 && q0 + kTile >= seq) continue;\n"),
    "flash_bwd_dkv": (_QT_LOOP, _QT_LOOP
                      + "    if (iq == n_qt - 1 && iq != first) continue;\n"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ptxas_usage(log: str) -> str:
    """'bf16 D=64: 96 registers, 0 B spilled; ...' from ptxas -v output."""
    out = []
    for fn, body in re.findall(r"Compiling entry function '(\S+)'(.*?)"
                               r"(?=Compiling entry function|\Z)", log, re.S):
        dtype = "fp16" if "__half" in fn else "bf16"
        d = re.search(r"Li(\d+)E", fn).group(1)
        regs = re.search(r"Used (\d+) registers", body).group(1)
        spill = re.search(r"(\d+) bytes spill stores", body).group(1)
        out.append(f"{dtype} D={d}: {regs} registers, {spill} B spilled")
    return "; ".join(sorted(out))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bounds(b: int, t: int) -> dict[str, tuple[float, str]]:
    """Least time (ms) each kernel could take on this input, and what
    bounds it: the larger of its tensor-core FLOPs over the bf16 peak
    and its bytes (each input read once, each output written once) over
    the memory rate. Causal work counts the T(T+1)/2 pairs this input
    needs. ``flash_bwd`` is the backward as one function (what the TPU's
    fused kernel computes): 5 products, where the dq and dkv kernels
    together do 7."""
    n = b * H
    mm = 2.0 * n * (t * (t + 1) / 2) * D          # one causal product
    seq_bytes = n * t * D * 2                      # one bf16 [BH, T, D]
    row_bytes = n * t * 4                          # one f32 [BH, T]
    work = {
        "flash_fwd": (2 * mm, 4 * seq_bytes + row_bytes),
        "flash_bwd_dq": (3 * mm, 5 * seq_bytes + 2 * row_bytes),
        "flash_bwd_dkv": (4 * mm, 6 * seq_bytes + 2 * row_bytes),
        "flash_bwd": (5 * mm, 7 * seq_bytes + 2 * row_bytes),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = ((t_ops, "operations") if t_ops >= t_bytes
                     else (t_bytes, "bytes"))
    return out


def kernel_inputs(b: int, t: int, dev):
    gen = torch.Generator(device=dev).manual_seed(t)
    q, k, v, do = (torch.randn(b * H, t, D, device=dev, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    return q, k, v, do


def kernel_readings(q, k, v, do) -> dict[str, dict]:
    """Each kernel's outputs on ``[BH, T, D]`` inputs held against its
    plain version's on the same inputs: {kernel: {output:
    fa.agreement(...)}}, lse beside."""
    scale = D ** -0.5
    o, lse = fa.flash_fwd(q, k, v, scale, True)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, scale, True)
    # The backward kernels take the plain lse and delta, so each is held
    # against its own plain version alone.
    delta = (o_ref.float() * do.float()).sum(-1)
    bwd = (q, k, v, do, lse_ref, delta, scale, True)
    dq = fa.flash_bwd_dq(*bwd)
    dq_ref = fa.flash_bwd_dq_reference(*bwd)
    dk, dv = fa.flash_bwd_dkv(*bwd)
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(*bwd)
    torch.cuda.synchronize()
    out = {"flash_fwd": {"o": fa.agreement(o, o_ref)},
           "flash_bwd_dq": {"dq": fa.agreement(dq, dq_ref)},
           "flash_bwd_dkv": {"dk": fa.agreement(dk, dk_ref),
                             "dv": fa.agreement(dv, dv_ref)}}
    lse_err = float((lse - lse_ref).abs().max())
    out["flash_fwd"]["lse"] = {"max_abs_err": lse_err,
                               "ok": lse_err < LSE_TOL}
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
    scale = D ** -0.5
    o, lse = fa.flash_fwd(q, k, v, scale, True)
    delta = (o.float() * do.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, scale, True)

    # The yardstick: one library call computing the same function.
    q4, k4, v4, do4 = (x.view(b, H, t, D) for x in (q, k, v, do))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), 20)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), do4, retain_graph=True), 20)

    times = {
        "flash_fwd": (
            cuda_ms(lambda: fa.flash_fwd(q, k, v, scale, True), 20),
            cuda_ms(lambda: fa.flash_fwd_reference(q, k, v, scale, True),
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
    bnd = bounds(b, t)
    rows = {}
    for name, (ms, p_ms, l_ms) in times.items():
        err = max(r["max_abs_err"] for o_name, r in readings[name].items()
                  if o_name != "lse")
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": p_ms,
                      "bound_ms": bnd[name][0], "bound_by": bnd[name][1],
                      "library_ms": l_ms}
        print(f"kernel {name} B={b} T={t} H={H} D={D} bf16 causal: "
              f"max abs err {err:.3g}, {ms:.4f} ms, "
              f"bound {bnd[name][0]:.4f} ms ({bnd[name][1]}), "
              f"plain {p_ms:.4f} ms, library {l_ms:.4f} ms", flush=True)
    pair_ms = times["flash_bwd_dq"][0] + times["flash_bwd_dkv"][0]
    pair_plain = cuda_ms(lambda: fa.flash_bwd_reference(
        q, k, v, o, lse, do, scale, True), 3, 1)
    print(f"kernel pair flash_bwd_dq+flash_bwd_dkv B={b} T={t}: {pair_ms:.4f}"
          f" ms, bound of the backward as one function (5 products) "
          f"{bnd['flash_bwd'][0]:.4f} ms ({bnd['flash_bwd'][1]}), "
          f"{pair_ms / bnd['flash_bwd'][0]:.2f}x it; the split's 7 "
          f"products bound it at "
          f"{bnd['flash_bwd_dq'][0] + bnd['flash_bwd_dkv'][0]:.4f} ms; "
          f"plain whole backward {pair_plain:.4f} ms, library {lib_bwd:.4f} "
          f"ms", flush=True)
    return rows


class PlainAttention(torch.autograd.Function):
    """Causal attention on [BH, T, D] through the plain versions, forward
    and backward, saving only what the kernels' Function saves."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = fa.flash_fwd_reference(q, k, v, scale, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*fa.flash_bwd_reference(q, k, v, o, lse, do.contiguous(),
                                        ctx.scale, True), None)


def plain_attention(q, k, v):
    """Causal attention through the plain versions, on [B, T, H, D]."""
    b, t, h, d = q.shape

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, t, d).contiguous()

    o = PlainAttention.apply(fold(q), fold(k), fold(v), d ** -0.5)
    return o.view(b, h, t, d).transpose(1, 2)


def layer_readings(model, batch) -> list[dict[str, dict]]:
    """Each layer's attention at step 0, on the q, k, v and output
    gradient the model gives it on ``batch``: :func:`kernel_readings`
    for each layer, in order."""
    seen = []
    kernel_attn = model.attn_fn

    def capture(q, k, v):
        out = kernel_attn(q, k, v)
        seen.append([q.detach(), k.detach(), v.detach(), None])
        out.register_hook(lambda g, entry=seen[-1]: entry.__setitem__(3, g))
        return out

    model.attn_fn = capture
    try:
        torch.autograd.grad(gpt2_loss_fn(ce_chunk=2048)(model, batch),
                            model.wte.weight)
    finally:
        model.attn_fn = kernel_attn

    def fold(x):
        b, t, h, d = x.shape
        return x.transpose(1, 2).reshape(b * h, t, d).contiguous()

    out = []
    for i, entry in enumerate(seen):
        out.append(kernel_readings(*(fold(x) for x in entry)))
        print(f"agreement layer {i}: {describe(out[-1])}", flush=True)
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
    worst = {}
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
            if rel > worst.get(w, (-1.0, 0))[0]:
                worst[w] = (rel, i)
    print("attention grads vs plain (largest relative norm error over the "
          "layers, layer): " + ", ".join(
              f"{w} {r:.4g} (layer {i})" for w, (r, i) in worst.items())
          + f"; limit {GRAD_TOL}", flush=True)
    return worst


def step0_losses(model, batch) -> tuple[float, float]:
    """Step-0 loss through the kernels and the chunked CE, and through
    the plain attention and full float32 logits, same weights and batch."""
    kernel_attn = model.attn_fn
    with torch.no_grad():
        loss_kernel = float(gpt2_loss_fn()(model, batch))
        model.attn_fn = plain_attention
        loss_plain = float(gpt2_loss_fn(fused_ce=False)(model, batch))
    model.attn_fn = kernel_attn
    print(f"train step-0 loss: kernels {loss_kernel:.6f}, plain "
          f"{loss_plain:.6f}, |diff| {abs(loss_kernel - loss_plain):.3g} "
          f"(limit {STEP0_LOSS_TOL})", flush=True)
    return loss_kernel, loss_plain


def train_batch(cfg: GPT2Config):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size,
                        (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    return toks, np.roll(toks, -1, 1)


def profile_dispatch(step, state, batch, card: str):
    """Run one dispatch under torch.profiler and print where the device
    time goes: the busy share of the wall time and the kernels with the
    most device time. Informational: a profiler that records no device
    time prints "not measured" and fails nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and getattr(e, "self_device_time_total", 0.0) > 0]
    busy_ms = sum(r[2] for r in rows) / 1e3
    if busy_ms == 0:
        print("profile: no device time recorded (not measured)", flush=True)
        return state
    groups = {"flash kernels": 0.0, "matmul": 0.0, "other": 0.0}
    for key, _, us in rows:
        low = key.lower()
        if "rtt::flash" in low:
            groups["flash kernels"] += us
        elif any(m in low for m in ("gemm", "cutlass", "xmma", "nvjet",
                                    "cublas")):
            groups["matmul"] += us
        else:
            groups["other"] += us
    print(f"profile: one dispatch of {K_STEPS} steps, wall {wall_ms:.2f} "
          f"ms, device busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}); "
          + ", ".join(f"{g} {us / 1e3:.2f} ms" for g, us in groups.items())
          + f"; card {card}", flush=True)
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:12]:
        print(f"profile kernel {us / 1e3:9.3f} ms x{count:<5d} {key[:110]}",
              flush=True)
    return state


def train_phase(card: str) -> dict[str, int]:
    cfg = GPT2Config.small()
    model = GPT2(cfg, seed=0)                     # on the card by default
    dev = next(model.parameters()).device
    toks, tgts = train_batch(cfg)
    batch0 = {"tokens": torch.from_numpy(toks).to(dev),
              "targets": torch.from_numpy(tgts).to(dev)}
    for i, readings in enumerate(layer_readings(model, batch0)):
        check_readings(readings, f"on layer {i}'s inputs")
    worst = attention_grad_readings(model, batch0)
    for w, (rel, layer) in worst.items():
        check(rel < GRAD_TOL, f"{w} gradient of layer {layer} within "
              f"{GRAD_TOL} of the plain path's (got {rel:.4g})")
    loss_kernel, loss_plain = step0_losses(model, batch0)
    check(np.isfinite(loss_kernel), "step-0 loss finite")
    check(abs(loss_kernel - loss_plain) < STEP0_LOSS_TOL,
          "step-0 loss matches the plain path")
    del batch0

    opt = adamw(3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16)
    state = init_train_state(model, opt)
    step = make_multi_train_step(gpt2_loss_fn(ce_chunk=2048), opt,
                                 grad_norm=False)
    stack = {"tokens": np.stack([toks] * K_STEPS),
             "targets": np.stack([tgts] * K_STEPS)}
    n_dispatch = 1 + TIMED_DISPATCHES
    torch.cuda.reset_peak_memory_stats()
    # The last dispatch is profiled, after the counts are read.
    with prefetch_to_device((stack for _ in range(n_dispatch + 1)),
                            dev) as pf:
        fa.reset_launch_counts()
        state, metrics = step(state, next(pf))     # warm-up dispatch
        loss_warm = float(metrics["loss"])
        stall0 = pf.stall_s
        t0 = time.perf_counter()
        for _ in range(TIMED_DISPATCHES):
            state, metrics = step(state, next(pf))
        loss_final = float(metrics["loss"])        # waits for the device
        dt = time.perf_counter() - t0
        stall = pf.stall_s - stall0
        counts = fa.launch_counts()
        state = profile_dispatch(step, state, next(pf), card)
    n_steps = n_dispatch * K_STEPS
    step_ms = dt / (TIMED_DISPATCHES * K_STEPS) * 1e3
    tok_s = TRAIN_BATCH * TRAIN_SEQ * TIMED_DISPATCHES * K_STEPS / dt
    peak = torch.cuda.max_memory_allocated()
    print(f"train GPT-2 124M B={TRAIN_BATCH} T={TRAIN_SEQ} bf16, "
          f"{n_steps} steps: loss {loss_kernel:.4f} -> {loss_warm:.4f} "
          f"(step {K_STEPS}) -> {loss_final:.4f} (step {n_steps}); "
          f"step {step_ms:.2f} ms, {tok_s:.1f} tokens/s, peak memory "
          f"{peak} B, input stall {stall * 1e3:.3f} ms; launches {counts}; "
          f"card {card}", flush=True)
    check(np.isfinite(loss_final), "loss finite")
    check(loss_final < loss_warm < loss_kernel,
          "loss falls on a repeated batch")
    check(state.step == n_steps + K_STEPS, "every step ran")
    for name, n in counts.items():
        check(n == cfg.n_layer * n_steps,
              f"{name} launched {cfg.n_layer} times per step "
              f"({n} for {n_steps} steps)")
    return counts


def plant_fault(name: str) -> str:
    """Build kernel ``name`` from a copy of its source carrying the fault
    of FAULTS, under the build directory, and bind its wrapper to it.
    Returns the temporary directory, for the caller to remove."""
    old, new = FAULTS[name]
    with open(build.sources()[name]) as f:
        src = f.read()
    check(src.count(old) == 1, f"the fault's anchor is in {name}.cu once")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="fault-", dir=build.BUILD_DIR)
    cu, lib = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, "lib.so")
    with open(cu, "w") as f:
        f.write(src.replace(old, new))
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.SRC_DIR,
                    "-o", lib, cu], check=True, capture_output=True,
                   timeout=600)
    kernel = fa._KERNELS[name]
    fn = getattr(ctypes.CDLL(lib), kernel.symbol)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    kernel._fn = fn
    return tmp


def fault_main(name: str, dev) -> int:
    build.ensure_built()
    tmp = plant_fault(name)
    try:
        print(f"planted fault in {name}: "
              f"{FAULTS[name][1].splitlines()[-1].strip()}", flush=True)
        def fails(readings):
            return not all(r["ok"] for r in readings[name].values())

        kernel_caught = []
        for b, t in SHAPES:
            readings = kernel_readings(*kernel_inputs(b, t, dev))
            print(f"agreement B={b} T={t}: {describe(readings)}", flush=True)
            kernel_caught.append(fails(readings))
        cfg = GPT2Config.small()
        model = GPT2(cfg, seed=0)
        toks, tgts = train_batch(cfg)
        batch0 = {"tokens": torch.from_numpy(toks).to(dev),
                  "targets": torch.from_numpy(tgts).to(dev)}
        layer_caught = [fails(r) for r in layer_readings(model, batch0)]
        worst = attention_grad_readings(model, batch0)
        grad_caught = any(rel >= GRAD_TOL for rel, _ in worst.values())
        loss_kernel, loss_plain = step0_losses(model, batch0)
        loss_caught = abs(loss_kernel - loss_plain) >= STEP0_LOSS_TOL
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result = {"fault": name, "kernel_check_fails_it": all(kernel_caught),
              "layer_check_fails_it_on_layers":
                  [i for i, caught in enumerate(layer_caught) if caught],
              "grad_check_fails_it": grad_caught,
              "loss_check_fails_it": loss_caught}
    print(json.dumps(result), flush=True)
    return 0 if all(kernel_caught) and any(layer_caught) else 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--plant-fault", choices=sorted(FAULTS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = default_device()
    card = card_line()
    print(f"card: {card}", flush=True)
    if args.plant_fault:
        return fault_main(args.plant_fault, dev)

    t0 = time.perf_counter()
    build.ensure_built()
    print(f"build: nvcc {time.perf_counter() - t0:.1f} s", flush=True)
    for name in SOURCES:
        with open(build.log_path(name)) as f:
            print(f"build {name}: {ptxas_usage(f.read())}", flush=True)

    rows = {}
    for b, t in SHAPES:
        rows[(b, t)] = kernel_phase(b, t, dev)

    counts = train_phase(card)

    main_rows = rows[(TRAIN_BATCH, TRAIN_SEQ)]
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": counts[name],
                **main_rows[name]} for name in SOURCES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
