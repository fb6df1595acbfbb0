"""Multi-rank dry run and the spawn helper: the counterpart of
``__graft_entry__.py``'s ``dryrun_multichip``.

:func:`spawn` starts ``n`` ranks as processes of their own, each joined to
one process group (NCCL with one GPU a rank by default; gloo on the CPU
only when the caller passes ``device="cpu"``), runs a function in every
rank and returns each rank's result. The process group and the join both have a timeout,
so a rank that fails or hangs fails the call instead of hanging it. The
port's multi-rank tests use it.

:func:`dryrun_multichip` runs, over ``n`` ranks, what the JAX version
runs on its virtual devices: one GPT-2 tiny train step on a ``dp × sp ×
tp`` mesh (``n`` factored as ``__graft_entry__.py`` factors it: tp 2 and
sp 2 where they divide, ring attention when ``sp > 1``), the pipeline leg
(``spmd_pipeline`` on ``dp × pp``, pp 4 or 2, ``tanh(x @ w)`` stages, 4
microbatches) and the expert-parallel ``moe_ffn`` leg, and checks that
what comes out is finite. The JAX version's cross-slice (DCN) leg needs
actors and ``DcnTcpCommunicator``, which come with the runtime (ROADMAP
§1 item 5): it waits.
"""

from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.core.accelerator import detect_gpus, resolve_device
from ray_tpu_torch.parallel.mesh import initialize


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_host(tree: Any) -> Any:
    """Tensors as numpy arrays, so that a result pickles by value."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _rank_main(fn, args, rank, n, port, device, timeout_s, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        initialize(device, timeout=datetime.timedelta(seconds=timeout_s))
        out.put((rank, True, _to_host(fn(*args))))
    except BaseException:  # noqa: BLE001 — reported to the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n: int, args: tuple = (), device=None,
          timeout: float = 300.0) -> list:
    """``[fn(*args) on rank r for r in range(n)]``, each rank a process of
    its own in one process group; tensors in a result come back as numpy
    arrays. ``fn`` must be importable by name (a module-level function).

    ``device`` is the ranks' device type: the card by default
    (``core.accelerator.resolve_device``, which raises without one; NCCL,
    rank r on ``cuda:r``, so ``n`` may not exceed the GPUs visible), or
    ``"cpu"`` (gloo). Each rank runs torch on one thread (the ranks share
    the host's cores). Raises RuntimeError with
    every failing rank's traceback when a rank raises or dies, and
    TimeoutError when the ranks have not all answered within ``timeout``
    seconds (the process group waits as long); either way every process
    is gone when it returns."""
    kind = resolve_device(device).type
    if kind == "cuda" and n > detect_gpus():
        raise ValueError(f"{n} NCCL ranks need {n} GPUs, {detect_gpus()} "
                         "visible: NCCL takes one GPU a rank")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, args, r, n, port, kind, timeout, out))
             for r in range(n)]
    for p in procs:
        p.start()
    results: dict[int, tuple[bool, Any]] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n - len(results)} of {n} ranks did "
                                   f"not answer within {timeout} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited (codes "
                                       f"{[procs[r].exitcode for r in dead]})"
                                       " without a result") from None
                continue
            results[rank] = (ok, value)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    failed = {r: v for r, (ok, v) in sorted(results.items()) if not ok}
    if failed:
        raise RuntimeError("".join(f"\n--- rank {r} ---\n{tb}"
                                   for r, tb in failed.items()))
    return [results[r][1] for r in range(n)]


def _dryrun_rank(n: int, device: str) -> dict:
    from ray_tpu_torch.models import GPT2, GPT2Config
    from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.train import (adamw, init_train_state,
                                     make_train_step, shard_batch)

    # n as dp x sp x tp, the innermost axes taking the factors of 2 first
    # (__graft_entry__.py:67-75).
    factors = {"dp": 1, "sp": 1, "tp": 1}
    rem = n
    for axis in ("tp", "sp"):
        if rem % 2 == 0:
            factors[axis] = 2
            rem //= 2
    factors["dp"] = rem
    mesh = make_mesh(factors, device=device)
    # Head dim 64, which the flash kernels take on the card.
    cfg = GPT2Config.tiny(n_embd=128, n_head=2,
                          attn_impl="ring" if factors["sp"] > 1 else "dense")
    model = GPT2(cfg, seed=0, mesh=mesh)
    opt = adamw(1e-3)
    state = init_train_state(model, opt, mesh=mesh)
    step = make_train_step(gpt2_loss_fn(), opt)
    rng = np.random.default_rng(0)
    bsz = max(4, 2 * factors["dp"])
    tokens = rng.integers(0, cfg.vocab_size, (bsz, cfg.seq_len))
    batch = shard_batch({"tokens": tokens, "targets": np.roll(tokens, -1, 1)},
                        mesh, seq_sharded=factors["sp"] > 1)
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss: {loss}")
    return {"loss": loss, "factors": factors, "device": str(mesh.device),
            "pipeline": _dryrun_pipeline(n, device),
            "moe": _dryrun_moe(n, device)}


def _dryrun_pipeline(n: int, device: str) -> dict | None:
    """The pipeline leg: ``spmd_pipeline`` over ``pp`` (4 where n allows,
    else 2) beside ``dp``, stages ``tanh(x @ w)`` of width 16, 4
    microbatches a data shard, on ones."""
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.pipeline import shard_stages, spmd_pipeline

    pp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    if pp == 1:
        return None
    dp = n // pp
    mesh = make_mesh({"dp": dp, "pp": pp}, device=device)
    d = 16
    gen = torch.Generator().manual_seed(0)
    ws = shard_stages(torch.randn(pp, d, d, generator=gen) * 0.2, mesh)
    pipe = spmd_pipeline(lambda w, x: torch.tanh(x @ w), 4, mesh=mesh)
    y = pipe(ws, torch.ones(4, d, device=mesh.device))
    if not torch.isfinite(y).all():
        raise AssertionError("spmd_pipeline: non-finite output")
    return {"pp": pp, "dp": dp, "sum": float(y.sum())}


def _dryrun_moe(n: int, device: str) -> dict | None:
    """The expert-parallel leg: ``moe_ffn`` over ``ep`` ranks (4 where n
    allows, else 2), two experts a rank."""
    from ray_tpu_torch.ops.moe import moe_ffn
    from ray_tpu_torch.parallel.mesh import make_mesh

    ep = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    if ep == 1:
        return None
    mesh = make_mesh({"dp": n // ep, "ep": ep}, device=device)
    t, d, h, e = 32, 8, 16, 2 * ep
    gen = torch.Generator().manual_seed(0)
    x, router, w_up, w_down = (
        (torch.randn(shape, generator=gen) * std).to(mesh.device)
        for shape, std in (((t, d), 1.0), ((d, e), 0.5), ((e, d, h), 0.3),
                           ((e, h, d), 0.3)))
    r = mesh.axis_index("ep")
    local = slice(r * 2, (r + 1) * 2)
    y, aux = moe_ffn(x, router, w_up[local], w_down[local],
                     group=mesh.group("ep"))
    if not (torch.isfinite(y).all() and torch.isfinite(aux)):
        raise AssertionError("moe_ffn: non-finite output")
    return {"ep": ep, "aux": float(aux)}


def dryrun_multichip(n_devices: int, device=None,
                     timeout: float = 300.0) -> list[dict]:
    """One sharded GPT-2 tiny train step, the pipeline leg and the
    expert-parallel leg on ``n_devices`` ranks: NCCL ranks, one GPU each,
    by default, gloo ranks on the CPU for ``device="cpu"`` (:func:`spawn`).
    Returns each rank's ``{"loss", "factors", "device", "pipeline",
    "moe"}`` (None for a leg ``n`` cannot factor); raises when a rank
    fails."""
    kind = resolve_device(device).type
    return spawn(_dryrun_rank, n_devices, (n_devices, kind), device=kind,
                 timeout=timeout)
