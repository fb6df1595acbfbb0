"""The port's train step, AdamW and SGD against the JAX step and optax,
the ``has_extra`` step, and the port's DevicePrefetcher.

Trajectory: ``GPT2Config.tiny(dtype=float32)`` on shared weights, five
numpy-seeded batches, ``make_multi_train_step`` (one step per dispatch,
so every step's metrics are seen) with AdamW(lr 1e-3, weight_decay 0.1,
first moment in bf16) on both sides: ``optax.adamw`` under
``ray_tpu.train``, the port's ``adamw`` under ``ray_tpu_torch.train``.

Tolerances: loss 2e-5 relative per step and the gradient norm 2e-3
relative; parameters after five steps within 2e-4. The gradients agree
to ~1e-7 relative at the same weights; Adam then divides each entry by
its own running RMS, which turns those differences into larger update
differences on entries whose gradient is small, and the weights drift
apart step by step. Five steps at lr 1e-3 move entries by up to 5e-3;
2e-4 is 4% of that. SGD against optax on fixed gradients: parameters
and traces within 1e-6 (float32 rounding of O(1) values). The
``has_extra`` step (a tiny ResNet's BatchNorm statistics) is held to
the formula ``0.9 * old + 0.1 * batch`` within 1e-6, once per step
however often the forward runs. The prefetcher tests mirror
``tests/test_train_fused_step.py``'s.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu.models import GPT2 as JaxGPT2  # noqa: E402
from ray_tpu.models import GPT2Config as JaxGPT2Config  # noqa: E402
from ray_tpu.models.gpt2 import gpt2_loss_fn as jax_gpt2_loss_fn  # noqa: E402
from ray_tpu.train import (  # noqa: E402
    init_train_state as jax_init_train_state,
    make_multi_train_step as jax_make_multi_train_step,
)
from ray_tpu_torch.models import GPT2, GPT2Config  # noqa: E402
from ray_tpu_torch.models.gpt2 import gpt2_loss_fn  # noqa: E402
from ray_tpu_torch.models import ResNet, ResNet50Config  # noqa: E402
from ray_tpu_torch.models.resnet import resnet_loss_fn  # noqa: E402
from ray_tpu_torch.train import (  # noqa: E402
    DevicePrefetcher,
    adamw,
    buffers_donated,
    compile_count,
    disable_capture,
    init_train_state,
    make_multi_train_step,
    make_train_step,
    prefetch_to_device,
    sgd,
)

N_STEPS = 5
LR, WD = 1e-3, 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module. Tier-1 runs six test processes on
    one host, so more threads would only starve timing-sensitive runtime
    tests in the others; and a second OpenMP thread's first ``exp`` in a
    process has come out at reduced precision on an AMX CPU with
    torch 2.13 (ROADMAP §3), so the plain versions run on the main thread
    only."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stacks(n=N_STEPS, k=1, bsz=2, seq=64, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (k, bsz, seq)).astype(np.int32)
        out.append({"tokens": toks, "targets": np.roll(toks, -1, 2)})
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_setup(jparams_np):
    model = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    model.load_jax_params(jparams_np)
    opt = adamw(LR, weight_decay=WD, mu_dtype=torch.bfloat16)
    return init_train_state(model, opt), opt


def test_multi_step_trajectory_matches_jax_optax():
    jmodel = JaxGPT2(JaxGPT2Config.tiny(dtype=jnp.float32))
    jparams = jmodel.init_params(jax.random.key(0))
    jparams_np = jax.tree_util.tree_map(np.array, jparams)
    jopt = optax.adamw(LR, weight_decay=WD, mu_dtype=jnp.bfloat16)
    jstate = jax_init_train_state(jparams, jopt)
    jstep = jax_make_multi_train_step(
        jax_gpt2_loss_fn(jmodel, ce_chunk=64), jopt)

    state, opt = _port_setup(jparams_np)
    step = make_multi_train_step(gpt2_loss_fn(ce_chunk=64), opt)

    losses = []
    for batch in _stacks():
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, _torch(batch))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=2e-5)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=2e-3)
        losses.append(m["loss"].item())
    assert state.step == N_STEPS
    assert len(set(losses)) == N_STEPS          # the weights really moved
    assert all(mu.dtype == torch.bfloat16 for mu in state.opt_state.mu)

    ref = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    ref.load_jax_params(jax.tree_util.tree_map(np.asarray, jstate.params))
    for (name, p), (_, want) in zip(state.params.named_parameters(),
                                    ref.named_parameters()):
        err = float((p.detach() - want.detach()).abs().max())
        assert err < 2e-4, f"{name} drifted {err:.3g} from the JAX step"


def test_one_k_step_dispatch_equals_k_single_steps():
    """The Python loop over a [K, ...] stack is the same math as K
    dispatches of one step (the counterpart of the lax.scan)."""
    jparams_np = jax.tree_util.tree_map(
        np.array,
        JaxGPT2(JaxGPT2Config.tiny()).init_params(jax.random.key(1)))
    stacks = _stacks(seed=1)
    one_each, opt_a = _port_setup(jparams_np)
    step_a = make_train_step(gpt2_loss_fn(ce_chunk=64), opt_a,
                             grad_norm=False)
    for batch in stacks:
        one_each, m_a = step_a(one_each, _torch(
            {k: v[0] for k, v in batch.items()}))
    all_in_one, opt_b = _port_setup(jparams_np)
    step_b = make_multi_train_step(gpt2_loss_fn(ce_chunk=64), opt_b,
                                   grad_norm=False)
    stacked = {k: np.concatenate([b[k] for b in stacks]) for k in stacks[0]}
    all_in_one, m_b = step_b(all_in_one, _torch(stacked))
    assert "grad_norm" not in m_b
    assert torch.equal(m_a["loss"], m_b["loss"])
    for pa, pb in zip(one_each.params.parameters(),
                      all_in_one.params.parameters()):
        assert torch.equal(pa, pb)


def test_step_updates_in_place():
    """The in-place update is the port's counterpart of donation: the
    parameter and moment buffers are the same storage after a step."""
    jparams_np = jax.tree_util.tree_map(
        np.array,
        JaxGPT2(JaxGPT2Config.tiny()).init_params(jax.random.key(2)))
    state, opt = _port_setup(jparams_np)
    before = [p.data_ptr() for p in state.params.parameters()]
    moments = [t.data_ptr() for t in state.opt_state.mu + state.opt_state.nu]
    w0 = state.params.wte.weight.detach().clone()
    step = make_train_step(gpt2_loss_fn(ce_chunk=64), opt)
    state, _ = step(state, _torch({k: v[0] for k, v in _stacks(1)[0].items()}))
    assert [p.data_ptr() for p in state.params.parameters()] == before
    assert [t.data_ptr() for t in
            state.opt_state.mu + state.opt_state.nu] == moments
    assert not torch.equal(state.params.wte.weight, w0)
    assert all(p.grad is None for p in state.params.parameters())


def test_adamw_matches_optax_on_fixed_gradients():
    """The optimizer alone, fed the same gradients as optax: the bf16
    first moments come out bit-equal (optax rounds b1 itself to bf16
    before ``b1 * mu``) and the parameters within 1e-6 (float32 rounding
    of the update; parameters are O(1), updates O(1e-3))."""
    rng = np.random.default_rng(7)
    shapes = [(64, 32), (32,), (3, 5, 7)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 10.0 ** rng.uniform(-6, 0, s))
              .astype(np.float32) for s in shapes] for _ in range(N_STEPS)]

    jopt = optax.adamw(LR, weight_decay=WD, mu_dtype=jnp.bfloat16)
    jparams = [jnp.asarray(x) for x in init]
    jstate = jopt.init(jparams)
    opt = adamw(LR, weight_decay=WD, mu_dtype=torch.bfloat16)
    params = [torch.tensor(x) for x in init]
    state = opt.init(params)
    for g in grads:
        updates, jstate = jopt.update([jnp.asarray(x) for x in g], jstate,
                                      jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.update([torch.tensor(x) for x in g], state, params)
    for p, want in zip(params, jparams):
        np.testing.assert_allclose(p.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    for mu, want in zip(state.mu, jstate[0].mu):
        np.testing.assert_array_equal(
            mu.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_adamw_count_and_bias_corrections_live_on_the_device():
    """The step count is a float32 tensor beside the parameters, and the
    bias corrections come from it at each update (a captured step replays
    them): five updates through the port's AdamW match optax's, the
    count included, at the fixed-gradient test's tolerance."""
    rng = np.random.default_rng(8)
    init = rng.standard_normal((16, 8)).astype(np.float32)
    grads = [rng.standard_normal((16, 8)).astype(np.float32)
             for _ in range(N_STEPS)]
    jopt = optax.adamw(LR, weight_decay=WD, mu_dtype=jnp.bfloat16)
    jparams = [jnp.asarray(init)]
    jstate = jopt.init(jparams)
    opt = adamw(LR, weight_decay=WD, mu_dtype=torch.bfloat16)
    params = [torch.tensor(init)]
    state = opt.init(params)
    assert state.count.dtype == torch.float32
    assert state.count.device == params[0].device and state.count.dim() == 0
    for g in grads:
        updates, jstate = jopt.update([jnp.asarray(g)], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.update([torch.tensor(g)], state, params)
    assert float(state.count) == float(jstate[0].count) == N_STEPS
    np.testing.assert_allclose(params[0].numpy(), np.asarray(jparams[0]),
                               rtol=0, atol=1e-6)


def test_adamw_update_rule_by_hand():
    """One parameter, two steps, against the formula written out."""
    p = torch.tensor([0.5, -1.0, 2.0])
    opt = adamw(0.1, b1=0.8, b2=0.9, eps=1e-3, weight_decay=0.5)
    st = opt.init([p])
    want = p.clone().double()
    mu = torch.zeros(3, dtype=torch.float64)
    nu = torch.zeros(3, dtype=torch.float64)
    for count, g in enumerate((torch.tensor([1.0, -2.0, 0.5]),
                               torch.tensor([-0.5, 1.0, 0.25])), start=1):
        opt.update([g], st, [p])
        mu = 0.2 * g.double() + 0.8 * mu
        nu = 0.1 * g.double() ** 2 + 0.9 * nu
        u = (mu / (1 - 0.8 ** count)) / ((nu / (1 - 0.9 ** count)).sqrt()
                                        + 1e-3)
        want = want - 0.1 * (u + 0.5 * want)
    assert st.count == 2
    np.testing.assert_allclose(p.numpy(), want.numpy(), rtol=1e-6)


@pytest.mark.parametrize("momentum,nesterov", [(0.9, True), (0.9, False),
                                                (None, False)])
def test_sgd_matches_optax_on_fixed_gradients(momentum, nesterov):
    """optax.sgd(0.1, momentum, nesterov) fed the same five gradients."""
    rng = np.random.default_rng(11)
    shapes = [(64, 32), (32,), (3, 5, 7)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(N_STEPS)]
    jopt = optax.sgd(0.1, momentum=momentum, nesterov=nesterov)
    jparams = [jnp.asarray(x) for x in init]
    jstate = jopt.init(jparams)
    opt = sgd(0.1, momentum=momentum, nesterov=nesterov)
    params = [torch.tensor(x) for x in init]
    state = opt.init(params)
    for g in grads:
        updates, jstate = jopt.update([jnp.asarray(x) for x in g], jstate,
                                      jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.update([torch.tensor(x) for x in g], state, params)
    for p, want in zip(params, jparams):
        np.testing.assert_allclose(p.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    if momentum is None:
        assert state.trace is None
        return
    for t, want in zip(state.trace, jstate[0].trace):
        np.testing.assert_allclose(t.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_sgd_update_rule_by_hand():
    """Nesterov: t = g + m t, p -= lr (g + m t); two steps in float64."""
    p = torch.tensor([0.5, -1.0, 2.0], dtype=torch.float64)
    opt = sgd(0.1, momentum=0.5, nesterov=True)
    st = opt.init([p])
    want = p.clone()
    t = torch.zeros(3, dtype=torch.float64)
    for g in (torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64),
              torch.tensor([-0.5, 1.0, 0.25], dtype=torch.float64)):
        opt.update([g], st, [p])
        t = g + 0.5 * t
        want = want - 0.1 * (g + 0.5 * t)
    assert torch.allclose(p, want, rtol=0, atol=1e-15)
    assert torch.allclose(st.trace[0], t, rtol=0, atol=1e-15)


def test_eager_step_has_no_compile_count():
    """On the CPU the step runs eagerly: no capture, so ``compile_count``
    is None, as the JAX version's is when it cannot tell."""
    jparams_np = jax.tree_util.tree_map(
        np.array,
        JaxGPT2(JaxGPT2Config.tiny()).init_params(jax.random.key(4)))
    state, opt = _port_setup(jparams_np)
    step = make_train_step(gpt2_loss_fn(ce_chunk=64), opt, grad_norm=False)
    multi = make_multi_train_step(gpt2_loss_fn(ce_chunk=64), opt)
    assert compile_count(step) is None and compile_count(multi) is None
    batch = _stacks(1, k=2, seed=4)[0]
    state, _ = step(state, _torch({k: v[0] for k, v in batch.items()}))
    with disable_capture():
        state, _ = multi(state, _torch(batch))
    assert compile_count(step) is None and compile_count(multi) is None
    assert state.step == 3
    assert compile_count(lambda state, batch: None) is None


@pytest.mark.parametrize("replace", ["none", "parameter", "moment",
                                     "count"])
def test_buffers_donated_holds_and_fails_a_replaced_tensor(replace):
    """Every parameter, moment and the count stay where they were across
    steps; a tensor that was replaced (as an out-of-place update would
    replace it) fails the check."""
    jparams_np = jax.tree_util.tree_map(
        np.array,
        JaxGPT2(JaxGPT2Config.tiny()).init_params(jax.random.key(5)))
    state, opt = _port_setup(jparams_np)
    step = make_train_step(gpt2_loss_fn(ce_chunk=64), opt)
    assert not buffers_donated(step, state)       # the step has not run
    batch = _torch({k: v[0] for k, v in _stacks(1, seed=5)[0].items()})
    w0 = state.params.wte.weight.detach().clone()
    for _ in range(2):
        state, _ = step(state, batch)
    assert not torch.equal(state.params.wte.weight, w0)
    with torch.no_grad():
        if replace == "parameter":
            state.params.wte.weight.data = state.params.wte.weight.clone()
        elif replace == "moment":
            state.opt_state.nu[3] = state.opt_state.nu[3].clone()
        elif replace == "count":
            state.opt_state.count = state.opt_state.count.clone()
    assert buffers_donated(step, state) == (replace == "none")


def test_buffers_donated_covers_extra_and_sgd_traces():
    state, opt = _tiny_resnet_state(4)
    step = make_train_step(resnet_loss_fn(), opt, has_extra=True)
    state, _ = step(state, _image_batch(4))
    assert buffers_donated(step, state)
    name = next(iter(state.extra))
    state.extra[name] = state.extra[name].clone()
    assert not buffers_donated(step, state)
    state, _ = _tiny_resnet_state(4)
    state, _ = step(state, _image_batch(4))        # another state's tensors
    assert not buffers_donated(step, state)


def _tiny_resnet_state(seed: int = 0):
    model = ResNet(ResNet50Config.tiny(dtype=torch.float32), device="cpu",
                   seed=seed)
    opt = sgd(0.1, momentum=0.9, nesterov=True)
    return init_train_state(model, opt, extra=model.batch_stats()), opt


def _image_batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(
                rng.standard_normal((2, 32, 32, 3)).astype(np.float32)),
            "label": torch.from_numpy(rng.integers(0, 10, 2))}


def _twice(module, extra, batch):
    """The forward run twice in one step: the step must still write the
    statistics once."""
    resnet_loss_fn()(module, extra, batch)
    return resnet_loss_fn()(module, extra, batch)


def _recomputed(module, extra, batch):
    """The forward under activation checkpointing, rerun in the
    backward."""
    return torch.utils.checkpoint.checkpoint(
        resnet_loss_fn(), module, extra, batch, use_reentrant=False)


@pytest.mark.parametrize("loss_fn", [resnet_loss_fn(), _twice, _recomputed],
                         ids=["once", "twice", "recomputed"])
def test_has_extra_step_writes_the_statistics_once(loss_fn):
    state, opt = _tiny_resnet_state()
    batch = _image_batch()
    start = {k: v.clone() for k, v in state.extra.items()}
    # The batch statistics of each BatchNorm at the step's weights.
    with torch.no_grad():
        _, once = state.params(batch["image"], train=True,
                               batch_stats=start)
    buffers = dict(state.params.named_buffers())
    step = make_train_step(loss_fn, opt, has_extra=True, grad_norm=False)
    state, m = step(state, batch)
    assert state.step == 1 and np.isfinite(m["loss"].item())
    for name, value in state.extra.items():
        assert value is buffers[name]            # written in place
        np.testing.assert_allclose(value.numpy(), once[name].numpy(),
                                   rtol=0, atol=1e-6)
        assert not torch.equal(value, start[name]), name


def test_has_extra_multi_step_runs_each_step_on_the_new_statistics():
    """Two steps in one dispatch equal two single steps, statistics
    included."""
    stack = [_image_batch(1), _image_batch(2)]
    a, opt_a = _tiny_resnet_state(3)
    step_a = make_train_step(resnet_loss_fn(), opt_a, has_extra=True)
    for batch in stack:
        a, _ = step_a(a, batch)
    b, opt_b = _tiny_resnet_state(3)
    step_b = make_multi_train_step(resnet_loss_fn(), opt_b, has_extra=True)
    b, m = step_b(b, {k: torch.stack([x[k] for x in stack])
                      for k in stack[0]})
    assert b.step == 2 and "grad_norm" in m
    for name in a.extra:
        assert torch.equal(a.extra[name], b.extra[name]), name
    for pa, pb in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(pa, pb)


# ---------------------------------------------------------------------------
# DevicePrefetcher


def test_prefetcher_preserves_order_and_counts():
    src = list(range(20))
    pf = DevicePrefetcher(iter(src), place=lambda x: x * 10, depth=3)
    assert list(pf) == [x * 10 for x in src]
    assert pf.batches == len(src)
    pf.close()


def test_prefetcher_overlaps_slow_source():
    """Wall time approaches max(produce, consume), not their sum."""
    n, delay = 6, 0.05

    def slow_src():
        for i in range(n):
            time.sleep(delay)
            yield i

    t0 = time.perf_counter()
    pf = DevicePrefetcher(slow_src(), depth=2)
    got = []
    for item in pf:
        time.sleep(delay)          # consumer "compute"
        got.append(item)
    wall = time.perf_counter() - t0
    pf.close()
    assert got == list(range(n))
    serial = 2 * n * delay
    assert wall < serial * 0.9 + 3 * delay, (
        f"no overlap: wall {wall:.3f}s vs serial {serial:.3f}s")


def test_prefetcher_propagates_source_error():
    def bad():
        yield 1
        raise RuntimeError("boom in producer")

    pf = DevicePrefetcher(bad())
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="boom in producer"):
        for _ in range(5):
            next(pf)
    pf.close()


def test_prefetcher_close_unblocks_full_queue():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    pf = DevicePrefetcher(endless(), depth=1)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_rejects_bad_depth():
    with pytest.raises(ValueError):
        DevicePrefetcher(iter([]), depth=0)


def test_prefetch_to_device_places_on_device():
    batches = [{"x": np.arange(4, dtype=np.float32) + i} for i in range(3)]
    with prefetch_to_device(iter(batches), "cpu") as pf:
        out = list(pf)
    assert len(out) == 3
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor)
        np.testing.assert_allclose(b["x"].numpy(), np.arange(4) + i)


def test_prefetcher_feeds_train_step():
    jparams_np = jax.tree_util.tree_map(
        np.array,
        JaxGPT2(JaxGPT2Config.tiny()).init_params(jax.random.key(3)))
    state, opt = _port_setup(jparams_np)
    step = make_multi_train_step(gpt2_loss_fn(ce_chunk=64), opt,
                                 grad_norm=False)
    with prefetch_to_device(iter(_stacks(3, k=2, seed=3)), "cpu") as pf:
        for b in pf:
            state, m = step(state, b)
    assert pf.batches == 3
    assert state.step == 6
    assert np.isfinite(m["loss"].item())


def test_gradient_all_reduce_packs_flat_buckets(monkeypatch):
    """A mesh step all-reduces replicated gradients in flat runs of one
    dtype, each of at most ``BUCKET_ELEMS`` elements (one tensor alone may
    exceed it), the loss last in its dtype's run; each flat run is
    unpacked back into its own gradients. On a one-rank group the
    all-reduce is a copy, so every gradient and the loss come back bit
    for bit."""
    import torch.distributed as dist
    from ray_tpu_torch.parallel import make_mesh
    from ray_tpu_torch.train import step as step_mod

    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(step_mod, "BUCKET_ELEMS", 10)
    gen = torch.Generator().manual_seed(0)
    grads = [torch.randn(shape, generator=gen).to(dtype) for shape, dtype in
             (((2, 2), torch.float32), ((4,), torch.bfloat16),
              ((3,), torch.float32), ((20,), torch.float32),
              ((2,), torch.bfloat16), ((1,), torch.float32))]
    loss = torch.tensor(2.5)
    runs = step_mod._buckets(sorted(grads + [loss.reshape(1)],
                                    key=lambda t: str(t.dtype)))
    assert [[t.numel() for t in run] for run in runs] == [
        [4, 2], [4, 3], [20], [1, 1]]
    assert [run[0].dtype for run in runs] == [
        torch.bfloat16, torch.float32, torch.float32, torch.float32]
    want = [g.clone() for g in grads]
    mesh = make_mesh({"dp": 1}, device="cpu")
    try:
        got = step_mod._reduce(grads, loss, mesh)
    finally:
        dist.destroy_process_group()
    assert got.shape == () and float(got) == 2.5
    for g, w in zip(grads, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
