"""The port's switch MoE (``ray_tpu_torch.ops.moe``,
``ray_tpu_torch.models.moe``) against the JAX package's on the CPU.

Weights cross through ``load_jax_params``; inputs come from numpy seeds.
Tolerances:

- ``top1_dispatch``: dispatch exactly equal, combine within 1e-7
  (softmax rounding in the last place), aux within 1e-6 relative.
- The index form (``moe_ffn``) against the one-hot einsum form
  (``dense_switch_ffn_reference``) on the same bf16 input: outputs equal
  bit for bit, since each slot holds one token and each einsum has one
  nonzero term; the router gradient within 1e-6 (summation order).
- ``moe_ffn`` against the JAX ``dense_switch_ffn_reference`` at
  ``tests/test_pipeline_moe.py``'s shapes: 1e-5, the JAX test's.
- ``SwitchFFN`` and the tiny ``MoETransformer`` in float32: outputs and
  gradients within 1e-5, the loss within 1e-6 relative, routing
  identical. In bf16 (the JAX model's compute type), logits within 2e-2
  and the loss within 1e-4 relative, as ``tests/test_torch_gpt2.py``
  holds GPT-2; a LayerNorm output one bf16 unit away can flip a token
  whose top two router logits nearly tie, and the test prints every
  flipped token with its top-2 margin.
- One AdamW step against optax: the loss within 2e-5 relative and
  every parameter within 2e-4, as ``tests/test_torch_train_step.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
flax = pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu.models.moe import MoEConfig as JaxMoEConfig  # noqa: E402
from ray_tpu.models.moe import MoETransformer as JaxMoETransformer  # noqa: E402
from ray_tpu.models.moe import SwitchFFN as JaxSwitchFFN  # noqa: E402
from ray_tpu.models.moe import moe_loss_fn as jax_moe_loss_fn  # noqa: E402
from ray_tpu.ops.moe import (  # noqa: E402
    dense_switch_ffn_reference as jax_dense_reference,
    top1_dispatch as jax_top1_dispatch,
)
from ray_tpu.train import (  # noqa: E402
    init_train_state as jax_init_train_state,
    make_train_step as jax_make_train_step,
)
from ray_tpu_torch.models import (  # noqa: E402
    MoEBlock,
    MoEConfig,
    MoETransformer,
    SwitchFFN,
    moe_loss_fn,
)
from ray_tpu_torch.ops.moe import (  # noqa: E402
    dense_switch_ffn_reference,
    moe_ffn,
    top1_dispatch,
    top1_route,
)
from ray_tpu_torch.train import (  # noqa: E402
    adamw,
    init_train_state,
    make_train_step,
)

F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: tier-1 runs six test processes on one host, and
    a second OpenMP thread's first exp in a process has come out at
    reduced precision on an AMX CPU with torch 2.13 (ROADMAP §3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lm_batch(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, cfg.seq_len)).astype(np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, 1)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# routing


@pytest.mark.parametrize("t,e,capacity", [(64, 4, 10), (64, 4, 32),
                                          (37, 8, 3)])
def test_top1_dispatch_matches_jax(t, e, capacity):
    logits = np.random.default_rng(t + e).standard_normal(
        (t, e)).astype(np.float32)
    want = jax_top1_dispatch(jnp.asarray(logits), e, capacity)
    got = top1_dispatch(torch.from_numpy(logits), e, capacity)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)
    if capacity * e < t:
        assert float(got[0].sum()) < t            # some tokens were dropped


def test_top1_dispatch_capacity_overflow():
    """``tests/test_pipeline_moe.py:64``: three tokens want expert 0 but
    capacity is 2, so token 2 is dropped."""
    logits = torch.tensor([[9.0, 0.0], [9.0, 0.0], [9.0, 0.0], [0.0, 9.0]])
    dispatch, combine, aux = top1_dispatch(logits, 2, capacity=2)
    assert [float(dispatch[i].sum()) for i in range(4)] == [1, 1, 0, 1]
    assert np.isfinite(float(aux))
    want = jax_top1_dispatch(jnp.asarray(logits.numpy()), 2, capacity=2)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(want[0]))
    route = top1_route(logits, 2, capacity=2)
    assert route.slots(0, 2, 2).tolist() == [0, 1, 4, 2]  # e*C + c; 4 = dump
    assert route.kept.tolist() == [True, True, False, True]
    assert float(route.gate[2]) == 0.0


@pytest.mark.parametrize("t,e,capacity", [(64, 4, 10), (37, 8, 3)])
def test_route_is_the_index_form_of_dispatch(t, e, capacity):
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (t, e)).astype(np.float32))
    dispatch, combine, aux = top1_dispatch(logits, e, capacity)
    route = top1_route(logits, e, capacity)
    flat = dispatch.reshape(t, e * capacity)
    kept = flat.sum(-1) > 0
    slot = route.slots(0, e, capacity)
    assert torch.equal(kept, route.kept)
    assert torch.equal(kept, slot < e * capacity)
    assert torch.equal(flat[kept].argmax(-1), slot[kept])
    assert torch.equal(combine.reshape(t, -1).amax(-1), route.gate)
    assert torch.equal(aux, route.aux)


# ---------------------------------------------------------------------------
# the switch FFN


def _ffn_weights(t, d, h, e, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, d)).astype(dtype),
            (rng.standard_normal((d, e)) * 0.5).astype(dtype),
            (rng.standard_normal((e, d, h)) * 0.3).astype(dtype),
            (rng.standard_normal((e, h, d)) * 0.3).astype(dtype))


def test_moe_ffn_matches_jax_dense_reference():
    """``tests/test_pipeline_moe.py:76``'s shapes and capacity factor."""
    ws = _ffn_weights(32, 8, 16, 8)
    y_ref, aux_ref = jax_dense_reference(*map(jnp.asarray, ws),
                                         capacity_factor=8.0)
    y, aux = moe_ffn(*map(torch.from_numpy, ws), capacity_factor=8.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-5)
    y2, aux2 = dense_switch_ffn_reference(*map(torch.from_numpy, ws),
                                          capacity_factor=8.0)
    np.testing.assert_allclose(y2.numpy(), np.asarray(y_ref), atol=1e-5,
                               rtol=1e-5)


def test_moe_ffn_refuses_an_expert_parallel_group():
    """An expert-parallel group is no longer refused: ``moe_ffn`` spreads
    the experts over its ranks (held against JAX's on four gloo ranks in
    ``tests/test_torch_mesh_train.py``). Over a group of one rank it is
    the function without a group, bit for bit."""
    import torch.distributed as dist

    ws = [torch.from_numpy(a) for a in _ffn_weights(8, 8, 16, 4)]
    y_ref, aux_ref = moe_ffn(*ws)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        y, aux = moe_ffn(*ws, group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    assert torch.equal(y, y_ref) and torch.equal(aux, aux_ref)


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_index_form_equals_einsum_form_in_bf16(capacity_factor):
    """Same bf16 tokens and weights through both forms: equal outputs and
    aux, and the same router gradient within summation order; at
    capacity factor 0.5 a quarter of the tokens or more are dropped."""
    x, rw, wu, wd = (torch.from_numpy(a) for a in
                     _ffn_weights(96, 64, 256, 4, seed=3))
    x = x.to(torch.bfloat16)
    outs = []
    for fn in (moe_ffn, dense_switch_ffn_reference):
        r = rw.clone().requires_grad_()
        y, aux = fn(x, r, wu, wd, capacity_factor=capacity_factor,
                    dtype=torch.bfloat16)
        g = torch.autograd.grad((y.float() ** 2).sum() + aux, r)[0]
        outs.append((y, aux, g))
    (y, aux, g), (y_ref, aux_ref, g_ref) = outs
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, y_ref)
    assert torch.equal(aux, aux_ref)
    torch.testing.assert_close(g, g_ref, rtol=1e-6, atol=1e-6)
    if capacity_factor < 1:
        assert int((y.float().abs().sum(-1) == 0).sum()) >= 96 // 4


def _jax_switch(cfg, x):
    module = JaxSwitchFFN(cfg)
    params = module.init(jax.random.key(0), jnp.asarray(x))["params"]
    return module, params


def test_switch_ffn_forward_and_grads_match_jax():
    """float32 SwitchFFN: y, aux and the gradients of x, router, w_up and
    w_down against jax.grad, routing identical."""
    cfg = MoEConfig.tiny(dtype=torch.float32)
    jcfg = JaxMoEConfig.tiny(dtype=jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, cfg.n_embd)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    module, params = _jax_switch(jcfg, x)

    def jloss(params, x):
        y, state = module.apply({"params": params}, x,
                                mutable=["intermediates"])
        aux = state["intermediates"]["aux_loss"][0]
        return (y * g).sum() + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    ffn = SwitchFFN(cfg, "cpu", torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name in ("router", "w_up", "w_down"):
            getattr(ffn, name).copy_(torch.from_numpy(np.array(
                params[name])))
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = ffn(tx)
    grads = torch.autograd.grad((y * torch.from_numpy(g)).sum() + aux,
                                [tx, ffn.router, ffn.w_up, ffn.w_down])
    # Routing: the same expert for every token.
    logits = x.reshape(-1, cfg.n_embd) @ np.asarray(params["router"])
    route = top1_route(torch.from_numpy(logits), cfg.num_experts, 24)
    assert route.expert.tolist() == np.argmax(logits, -1).tolist()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    want = [jgx] + [jgp[name] for name in ("router", "w_up", "w_down")]
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=F32_TOL,
                                   rtol=0)


# ---------------------------------------------------------------------------
# the model


def _models(dtype, seed=0):
    jcfg = JaxMoEConfig.tiny(dtype=dtype)
    jmodel = JaxMoETransformer(jcfg)
    jparams = jmodel.init_params(jax.random.key(seed))
    cfg = MoEConfig.tiny(dtype=torch.float32 if dtype == jnp.float32
                         else torch.bfloat16)
    model = MoETransformer(cfg, device="cpu")
    model.load_jax_params(_np(jparams))
    return jmodel, jparams, model


def _routing(jmodel, jparams, model, tokens):
    """Each side's expert choice and router logits per MoE layer, from
    its own ``ln_2`` output."""
    _, inter = jmodel.apply({"params": jparams}, jnp.asarray(tokens),
                            capture_intermediates=True,
                            mutable=["intermediates"])
    seen = {}
    hooks = [block.ln_2.register_forward_hook(
        lambda m, a, out, i=i: seen.__setitem__(i, out.detach()))
        for i, block in enumerate(model.h) if isinstance(block, MoEBlock)]
    with torch.no_grad():
        model(torch.from_numpy(tokens))
    for hk in hooks:
        hk.remove()
    out = {}
    for i, x in seen.items():
        jx = np.asarray(inter["intermediates"][f"h_{i}"]["ln_2"]["__call__"]
                        [0], np.float32)
        router = np.asarray(jparams[f"h_{i}"]["moe"]["router"])
        jl = jx.reshape(-1, jx.shape[-1]) @ router
        tl = x.float().reshape(-1, x.shape[-1]).numpy() @ router
        out[i] = (np.argmax(jl, -1), np.argmax(tl, -1), jl)
    return out


def test_moe_blocks_sit_at_odd_layers():
    """``tests/test_models_extended.py:87``: expert params on every 2nd
    block only."""
    jmodel, jparams, model = _models(jnp.float32)
    assert "moe" in jparams["h_1"] and "mlp" in jparams["h_0"]
    assert [isinstance(b, MoEBlock) for b in model.h] == [False, True]
    big = MoETransformer(MoEConfig.tiny(n_layer=6), device="cpu")
    assert [i for i, b in enumerate(big.h) if isinstance(b, MoEBlock)] == [
        1, 3, 5]


def test_float32_logits_and_loss_match_jax():
    jmodel, jparams, model = _models(jnp.float32)
    batch = _lm_batch(model.config)
    for i, (want, got, _) in _routing(jmodel, jparams, model,
                                      batch["tokens"]).items():
        np.testing.assert_array_equal(got, want, err_msg=f"layer {i}")
    jlogits, _ = jmodel.apply({"params": jparams},
                              jnp.asarray(batch["tokens"]),
                              mutable=["intermediates"])
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(batch["tokens"]))
    assert aux.shape == (1,)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=F32_TOL, rtol=0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for fused in (True, False):
        want = float(jax_moe_loss_fn(jmodel, fused_ce=fused, ce_chunk=64)(
            jparams, jbatch))
        with torch.no_grad():
            got = float(moe_loss_fn(fused_ce=fused, ce_chunk=64)(
                model, _torch(batch)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_bf16_logits_and_loss_match_jax():
    jmodel, jparams, model = _models(jnp.bfloat16, seed=1)
    batch = _lm_batch(model.config, seed=1)
    flips = []
    for i, (want, got, jl) in _routing(jmodel, jparams, model,
                                       batch["tokens"]).items():
        top2 = np.sort(jl, -1)[:, -2:]
        for tok in np.flatnonzero(want != got):
            flips.append((i, int(tok), float(top2[tok, 1] - top2[tok, 0])))
    print(f"bf16 routing: {len(flips)} flipped tokens (layer, token, "
          f"top-2 router-logit margin): {flips}")
    jlogits, _ = jmodel.apply({"params": jparams},
                              jnp.asarray(batch["tokens"]),
                              mutable=["intermediates"])
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(batch["tokens"]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=2e-2, rtol=2e-2)
    want = float(jax_moe_loss_fn(jmodel, ce_chunk=64)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = float(moe_loss_fn(ce_chunk=64)(model, _torch(batch)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_one_adamw_step_matches_optax():
    jmodel, jparams, model = _models(jnp.float32, seed=2)
    batch = _lm_batch(model.config, seed=2)
    jopt = optax.adamw(1e-3, weight_decay=0.1, mu_dtype=jnp.bfloat16)
    jstate = jax_init_train_state(jparams, jopt)
    jstep = jax_make_train_step(jax_moe_loss_fn(jmodel, ce_chunk=64), jopt)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    opt = adamw(1e-3, weight_decay=0.1, mu_dtype=torch.bfloat16)
    state = init_train_state(model, opt)
    step = make_train_step(moe_loss_fn(ce_chunk=64), opt)
    state, m = step(state, _torch(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=2e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=2e-3)
    ref = MoETransformer(model.config, device="cpu")
    ref.load_jax_params(_np(jstate.params))
    for (name, p), want in zip(state.params.named_parameters(),
                               ref.parameters()):
        err = float((p.detach() - want.detach()).abs().max())
        assert err < 2e-4, f"{name} is {err:.3g} from the optax step"
