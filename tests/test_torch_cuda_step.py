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
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import GPT2, GPT2Config
from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
from ray_tpu_torch.ops.cuda import flash_attention as fa
from ray_tpu_torch.train import (
    adamw,
    buffers_donated,
    compile_count,
    disable_capture,
    init_train_state,
    make_multi_train_step,
    make_train_step,
    prefetch_to_device,
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
        "flash_fwd_rect": 0, "flash_bwd_dq_rect": 0, "flash_bwd_dkv_rect": 0}
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
