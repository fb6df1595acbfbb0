"""Card-only tests of the captured train step (``ray_tpu_torch.train``).

On the card, ``make_train_step`` and ``make_multi_train_step`` capture
the step as one CUDA graph and replay it. These tests hold the captured
step against the same step run eagerly (``disable_capture``) from the
same weights, and check ``compile_count``, ``buffers_donated``, the
flash kernels' launch counters under replay and the optimizer's
device-side count. They need neither flax nor optax. Marked ``cuda``:
run on an H100 with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_step.py

They skip, from inside the test, where no GPU is visible.

Tolerances: the captured step runs the same kernels on the same inputs
as the eager one, so losses agree within 1e-6 relative (a library
product may pick another algorithm inside a capture) and the float32
regression's parameters within 1e-6.

The mesh tests run on a one-rank NCCL group (``parallel.initialize``)
and a mesh whose axes are all of size 1: the step on ``dp = 1`` keeps
its gradient all-reduce inside the captured graph and matches the
mesh-less step within 1e-6; FSDP2 (``fsdp = 1``) runs eagerly by rule,
``compile_count`` None, with the same step-0 loss; ring attention's hops
at ``sp = 4``, run in this process, agree with the plain whole attention
by ``flash_attention.agreement`` and launch 1 + r hops on rank r;
Ulysses at world 1 is ``causal_attention`` bit for bit, and ``moe_ffn``
over an ``ep`` group of one rank matches the one-hot einsum form within
one bf16 unit. ``dryrun_multichip(1)`` with no device named spawns one
NCCL rank on ``cuda:0``. The tp route forced on the one-rank ``tp`` axis
(``copy_to``/``reduce_from``, the vocab-parallel lookup and CE, each
collective over one rank) is captured once and matches the mesh-less
step within 1e-6; the switch-MoE transformer on ``dp × ep`` (global
routing, the ep route forced) matches the mesh-less MoE step within
1e-6, captured once. A ``num_gpus=1`` actor of the port's runtime trains
from this process's weights (numpy through the object store) with the
same losses within 1e-6, captured once.
"""

from __future__ import annotations

import contextlib
import gc
import weakref

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import GPT2, GPT2Config, MoEConfig, MoETransformer
from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
from ray_tpu_torch.models.moe import moe_loss_fn
from ray_tpu_torch.ops import attention as attn
from ray_tpu_torch.ops.cuda import flash_attention as fa
from ray_tpu_torch.ops.moe import dense_switch_ffn_reference, moe_ffn
from ray_tpu_torch.parallel import initialize, make_mesh
from ray_tpu_torch.parallel.dryrun import dryrun_multichip
from ray_tpu_torch.parallel.sharding import _place_forced
from ray_tpu_torch.train import (
    adamw,
    buffers_donated,
    compile_count,
    disable_capture,
    init_train_state,
    make_multi_train_step,
    make_train_step,
    prefetch_to_device,
    shard_batch,
)

pytestmark = pytest.mark.cuda

LOSS_RTOL = 1e-6
N_STEPS = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with -m cuda on the card")
    return torch.device("cuda", 0)


def _gpt2(cuda):
    cfg = GPT2Config.tiny(n_embd=256, n_head=4, seq_len=256)
    return GPT2(cfg, device=cuda, seed=0)


def _batches(cuda, n, b=4, t=256, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = torch.from_numpy(rng.integers(0, vocab, (b, t))).to(cuda)
        out.append({"tokens": toks, "targets": torch.roll(toks, -1, 1)})
    return out


def _run(cuda, capture: bool, batches):
    model = _gpt2(cuda)
    opt = adamw(1e-3, weight_decay=0.1, mu_dtype=torch.bfloat16)
    state = init_train_state(model, opt)
    step = make_train_step(gpt2_loss_fn(ce_chunk=512), opt)
    losses = []
    with contextlib.nullcontext() if capture else disable_capture():
        for batch in batches:
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    return state, step, losses


def test_captured_step_equals_eager_over_four_steps(cuda):
    batches = _batches(cuda, N_STEPS)
    state_c, step_c, captured = _run(cuda, True, batches)
    state_e, step_e, eager = _run(cuda, False, batches)
    print(f"losses captured {captured}, eager {eager}, bit-equal "
          f"{captured == eager}")
    np.testing.assert_allclose(captured, eager, rtol=LOSS_RTOL)
    assert len(set(captured)) == N_STEPS          # the weights really moved
    assert compile_count(step_c) == 1 and compile_count(step_e) is None
    assert state_c.step == state_e.step == N_STEPS
    assert float(state_c.opt_state.count) == N_STEPS


def test_multi_step_replays_the_single_step_graph(cuda):
    """Two dispatches of a K = 2 stack: four updates, one capture, the same
    losses as four eager single steps."""
    batches = _batches(cuda, N_STEPS, seed=1)
    _, _, eager = _run(cuda, False, batches)
    model = _gpt2(cuda)
    opt = adamw(1e-3, weight_decay=0.1, mu_dtype=torch.bfloat16)
    state = init_train_state(model, opt)
    multi = make_multi_train_step(gpt2_loss_fn(ce_chunk=512), opt)
    last = []
    for i in (0, 2):
        stack = {k: torch.stack([batches[i][k], batches[i + 1][k]])
                 for k in batches[0]}
        state, m = multi(state, stack)
        last.append(float(m["loss"]))
    assert state.step == N_STEPS and compile_count(multi) == 1
    np.testing.assert_allclose(last, [eager[1], eager[3]], rtol=LOSS_RTOL)


def test_compile_count_stable_and_buffers_donated(cuda):
    """``tests/test_train_fused_step.py:94``'s contract: one capture after
    warm-up, stable over ten more dispatches; the state updated in place;
    a new batch shape captures again, as jit retraces."""
    model = _gpt2(cuda)
    opt = adamw(1e-3, weight_decay=0.1, mu_dtype=torch.bfloat16)
    state = init_train_state(model, opt)
    step = make_train_step(gpt2_loss_fn(ce_chunk=512), opt, grad_norm=False)
    batches = _batches(cuda, 12, seed=2)
    state, first = step(state, batches[0])
    assert compile_count(step) == 1
    state, second = step(state, batches[1])
    assert compile_count(step) == 1 and buffers_donated(step, state)
    loss1 = float(first["loss"])
    for batch in batches[2:]:
        state, m = step(state, batch)
    assert compile_count(step) == 1 and buffers_donated(step, state)
    # The metrics are copies: later replays left the first ones alone.
    assert float(first["loss"]) == loss1
    assert first["loss"].data_ptr() != m["loss"].data_ptr()
    state, _ = step(state, _batches(cuda, 1, b=2, seed=3)[0])
    assert compile_count(step) == 2 and state.step == 13


class _Owner:
    """A learner's shape: it holds its step, whose body holds it back (a
    reference cycle, freed only by the cyclic collector)."""

    def __init__(self, cuda, seen: list):
        self.seen = seen
        self.model = _gpt2(cuda)
        self.opt = adamw(1e-3, weight_decay=0.1, mu_dtype=torch.bfloat16)
        self.state = init_train_state(self.model, self.opt)
        self.step = make_train_step(self._loss, self.opt, grad_norm=False)

    def _loss(self, model, batch):
        if torch.cuda.is_current_stream_capturing():
            self.seen.append(gc.isenabled())
        return gpt2_loss_fn(ce_chunk=512)(model, batch)


def test_a_capture_holds_the_collector_off(cuda):
    """A dropped step is cyclic garbage; the collector freeing its graph
    during another step's capture resets a CUDAGraph there and invalidates
    that capture (chip_smoke's phase 19 (g) met it). A capture collects
    first and runs with the collector off, then turns it back on."""
    seen: list = []
    batches = _batches(cuda, 2, seed=4)
    a = _Owner(cuda, seen)
    a.state, _ = a.step(a.state, batches[0])
    dropped = weakref.ref(a)
    del a
    b = _Owner(cuda, seen)
    old = gc.get_threshold()
    gc.set_threshold(1)
    try:
        for batch in batches:
            b.state, m = b.step(b.state, batch)
    finally:
        gc.set_threshold(*old)
    assert dropped() is None
    assert seen == [False, False] and gc.isenabled()
    assert compile_count(b.step) == 1 and np.isfinite(float(m["loss"]))


def test_bias_correction_advances_across_replays(cuda):
    """A float32 regression trained by AdamW, captured against eager: the
    parameters agree step for step. A bias correction frozen at its
    capture-time count would move the captured run away from step 2 on."""
    torch.manual_seed(0)
    x = torch.randn(256, 32, device=cuda)
    y = x @ torch.randn(32, 1, device=cuda)

    def loss_fn(model, batch):
        return ((model(batch["x"]) - batch["y"]) ** 2).mean()

    runs = {}
    for capture in (True, False):
        model = torch.nn.Linear(32, 1, device=cuda)
        with torch.no_grad():
            model.weight.fill_(0.1)
            model.bias.zero_()
        opt = adamw(1e-2, b1=0.5, b2=0.6, weight_decay=0.0)
        state = init_train_state(model, opt)
        step = make_train_step(loss_fn, opt)
        trail = []
        with contextlib.nullcontext() if capture else disable_capture():
            for _ in range(6):
                state, _ = step(state, {"x": x, "y": y})
                trail.append(model.weight.detach().clone())
        runs[capture] = trail
    for i, (a, b) in enumerate(zip(runs[True], runs[False])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6,
                                   msg=f"step {i + 1}")


def test_replays_count_their_kernel_launches(cuda):
    """Each replay adds the launches its graph holds: one of each square
    kernel per layer and step; a launch captured outside
    ``record_launches`` raises."""
    model = _gpt2(cuda)
    opt = adamw(1e-3)
    state = init_train_state(model, opt)
    step = make_train_step(gpt2_loss_fn(ce_chunk=512), opt)
    batches = _batches(cuda, 3, seed=4)
    state, _ = step(state, batches[0])           # warm-up and capture
    fa.reset_launch_counts()
    for batch in batches[1:]:
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    n = 2 * model.config.n_layer
    assert fa.launch_counts() == {
        "flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
        "flash_fwd_rect": 0, "flash_bwd_dq_rect": 0, "flash_bwd_dkv_rect": 0,
        "flash_fwd_nc_rect": 0, "flash_bwd_dq_nc_rect": 0,
        "flash_bwd_dkv_nc_rect": 0}
    q = torch.randn(8, 128, 64, device=cuda, dtype=torch.bfloat16)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="record_launches"):
        with torch.cuda.graph(graph):
            fa.flash_fwd(q, q, q, 0.125)


def test_captured_step_behind_the_prefetcher(cuda):
    """Batches from ``prefetch_to_device`` (copied on a side stream) reach
    the static buffers in order: the losses equal the eager run's."""
    rng = np.random.default_rng(5)
    host = []
    for _ in range(N_STEPS):
        toks = rng.integers(0, 256, (4, 256)).astype(np.int64)
        host.append({"tokens": toks, "targets": np.roll(toks, -1, 1)})
    _, _, eager = _run(cuda, False, [
        {k: torch.from_numpy(v).to(cuda) for k, v in b.items()}
        for b in host])
    model = _gpt2(cuda)
    opt = adamw(1e-3, weight_decay=0.1, mu_dtype=torch.bfloat16)
    state = init_train_state(model, opt)
    step = make_train_step(gpt2_loss_fn(ce_chunk=512), opt)
    got = []
    with prefetch_to_device(iter(host), cuda) as pf:
        for batch in pf:
            state, m = step(state, batch)
            got.append(float(m["loss"]))
    np.testing.assert_allclose(got, eager, rtol=LOSS_RTOL)


@pytest.fixture
def mesh(cuda):
    """A mesh of size-1 axes over a one-rank NCCL group (made once)."""
    global _MESH
    if _MESH is None:
        initialize()
        _MESH = make_mesh({"dp": 1})
    return _MESH


_MESH = None


def _mesh_losses(cuda, mesh, forced=(), moe=False):
    if moe:
        model = MoETransformer(MoEConfig.tiny(n_embd=256, n_head=4,
                                              seq_len=256),
                               device=cuda, seed=0, mesh=mesh)
    else:
        model = GPT2(GPT2Config.tiny(n_embd=256, n_head=4, seq_len=256),
                     device=cuda, seed=0, mesh=mesh)
    if forced:
        _place_forced(model, mesh, forced)
    opt = adamw(1e-3, weight_decay=0.1, mu_dtype=torch.bfloat16)
    state = init_train_state(model, opt, mesh=mesh)
    step = make_train_step((moe_loss_fn if moe else gpt2_loss_fn)(
        ce_chunk=512), opt)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, 256, (4, 256))
    host = {"tokens": toks, "targets": np.roll(toks, -1, 1)}
    batch = ({k: torch.from_numpy(v).to(cuda) for k, v in host.items()}
             if mesh is None else shard_batch(host, mesh))
    fa.reset_launch_counts()
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(N_STEPS)]
    return losses, step, state, fa.launch_counts()


def test_mesh_dp1_step_is_captured_and_equals_the_mesh_less_step(cuda, mesh):
    want, _, _, _ = _mesh_losses(cuda, None)
    got, step, state, counts = _mesh_losses(cuda, mesh)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert compile_count(step) == 1
    assert buffers_donated(step, state)
    assert all(counts[n] == 2 * N_STEPS for n in
               ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))


def test_mesh_fsdp1_runs_eagerly_by_rule(cuda, mesh):
    want, _, _, _ = _mesh_losses(cuda, mesh)
    got, step, _, _ = _mesh_losses(cuda, mesh, ("fsdp",))
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    assert compile_count(step) is None


def test_mesh_tp1_route_is_captured_and_equals_the_mesh_less_step(cuda,
                                                                  mesh):
    want, _, _, _ = _mesh_losses(cuda, None)
    got, step, state, counts = _mesh_losses(cuda, mesh, ("tp",))
    assert state.params.h[0].mlp.tp is not None
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert compile_count(step) == 1
    assert buffers_donated(step, state)
    assert all(counts[n] == 2 * N_STEPS for n in
               ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))


def test_mesh_dp1_ep1_moe_step_equals_the_mesh_less_step(cuda, mesh):
    want, _, _, _ = _mesh_losses(cuda, None, moe=True)
    got, step, state, _ = _mesh_losses(cuda, mesh, ("ep",), moe=True)
    assert state.params.h[1].moe.ep is not None
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert compile_count(step) == 1


def test_ring_hops_agree_with_the_whole_attention(cuda):
    sp, bh, t, d = 4, 8, 512, 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, do = (torch.randn(bh, t, d, device=cuda, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    s = t // sp
    qs, ks, vs, dos = ([x[:, r * s:(r + 1) * s].contiguous()
                        for r in range(sp)] for x in (q, k, v, do))
    outs, dqs = [], []
    dks = [torch.zeros(bh, s, d, device=cuda) for _ in range(sp)]
    dvs = [torch.zeros_like(x) for x in dks]
    for r in range(sp):
        fa.reset_launch_counts()
        state = None
        for src in range(r + 1):
            state = attn.ring_merge(state, attn.ring_hop_forward(
                qs[r], ks[src], vs[src], src, r, scale))
        assert attn.ring_hop_forward(qs[r], ks[0], vs[0], r + 1, r,
                                     scale) is None
        o, lse = attn.ring_finish(state, q.dtype)
        delta = (o.float() * dos[r].float()).sum(-1)
        dq = torch.zeros(bh, s, d, device=cuda)
        for src in range(r + 1):
            g = attn.ring_hop_backward(qs[r], ks[src], vs[src], dos[r], lse,
                                       delta, src, r, scale)
            dq += g[0].float()
            dks[src] += g[1].float()
            dvs[src] += g[2].float()
        counts = fa.launch_counts()
        assert all(counts[n] == r + 1 for n in
                   ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")), counts
        outs.append(o)
        dqs.append(dq.to(q.dtype))
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, scale, True)
    refs = fa.flash_bwd_reference(q, k, v, o_ref, lse_ref, do, scale, True)
    got = (torch.cat(outs, 1), torch.cat(dqs, 1),
           torch.cat(dks, 1).to(q.dtype), torch.cat(dvs, 1).to(q.dtype))
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, (o_ref, *refs)):
        assert fa.agreement(g, w)["ok"], (name, fa.agreement(g, w))


def test_ulysses_and_moe_ffn_at_world_1(cuda, mesh):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(2, 256, 4, 64, device=cuda, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    assert torch.equal(attn.ulysses_attention(q, k, v, mesh=mesh),
                       attn.causal_attention(q, k, v))
    x = torch.randn(512, 256, device=cuda, generator=gen).to(torch.bfloat16)
    router, w_up, w_down = (
        torch.empty(shape, device=cuda).normal_(0.0, 0.02, generator=gen)
        for shape in ((256, 4), (4, 256, 1024), (4, 1024, 256)))
    y, aux = moe_ffn(x, router, w_up, w_down, group=mesh.group("ep"),
                     dtype=torch.bfloat16)
    y_ref, aux_ref = dense_switch_ffn_reference(x, router, w_up, w_down,
                                                dtype=torch.bfloat16)
    y, y_ref = y.float(), y_ref.float()
    assert bool(((y - y_ref).abs() <= 2.0 ** -8 * y_ref.abs()
                 + 2.0 ** -133).all())
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)


def test_dryrun_multichip_runs_on_the_card_by_default(cuda):
    ranks = dryrun_multichip(1)
    assert len(ranks) == 1 and ranks[0]["device"] == "cuda:0"
    assert np.isfinite(ranks[0]["loss"])


def test_runtime_actor_trains_as_this_process_does(cuda):
    """chip_smoke phase 14 (c) at a small width: a ``num_gpus=1`` actor
    of the port's runtime, given this process's weights as numpy through
    the object store, runs the same captured steps: losses within
    LOSS_RTOL, captured once, each kernel's launches counted in the
    actor's own process, and the card as ``get_gpu_ids() == [0]``."""
    import ray_tpu_torch as rt

    batches = _batches(cuda, N_STEPS)
    _, _, want = _run(cuda, True, batches)
    weights = {n: p.detach().cpu().numpy()
               for n, p in _gpt2(cuda).named_parameters()}
    host = [{k: v.cpu().numpy() for k, v in b.items()} for b in batches]
    torch.cuda.empty_cache()

    class Trainer:
        def run(self, weights, host):
            dev = torch.device("cuda", 0)
            model = GPT2(GPT2Config.tiny(n_embd=256, n_head=4, seq_len=256),
                         device=dev, seed=1)
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(torch.from_numpy(
                        np.require(weights[n], requirements="W")))
            opt = adamw(1e-3, weight_decay=0.1, mu_dtype=torch.bfloat16)
            state = init_train_state(model, opt)
            step = make_train_step(gpt2_loss_fn(ce_chunk=512), opt)
            fa.reset_launch_counts()
            losses = [float(step(state, {k: torch.from_numpy(v).to(dev)
                                         for k, v in b.items()})[1]["loss"])
                      for b in host]
            return (losses, compile_count(step), fa.launch_counts(),
                    rt.get_gpu_ids())

    rt.init(num_cpus=2)
    try:
        actor = rt.remote(num_gpus=1)(Trainer).remote()
        losses, captures, counts, ids = rt.get(
            actor.run.remote(rt.put(weights), host), timeout=600)
    finally:
        rt.shutdown()
    print(f"actor losses {losses}, in-process {want}, bit-equal "
          f"{losses == want}; launches {counts}")
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    n_layer = GPT2Config.tiny().n_layer
    assert captures == 1 and ids == [0]
    assert all(counts[k] == N_STEPS * n_layer
               for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
