"""The port's Llama against the JAX package's, on shared weights.

The flax params of ``ray_tpu.models.Llama`` (``LlamaConfig.tiny``: 4
query heads on 2 key/value heads, GQA 2:1) are carried into
``ray_tpu_torch.models.Llama`` by ``load_jax_params``; both get the same
numpy-seeded tokens on the CPU. JAX attention on the CPU is XLA's dense
path, the port's is the flash kernels' plain version.

Tolerances. RoPE angles: exactly equal. ``apply_rope`` and RMSNorm in
float32: 1e-6 of the largest value (XLA fuses the multiply-adds and
takes cos/sin and rsqrt its own way: a unit or two in the last place);
in bfloat16 two units in the last place of the largest value.
The model in float32: logits 1e-5 absolute, loss 1e-6 relative, every
gradient within 1e-5 of its JAX counterpart's largest entry (only
summation order differs), as for GPT-2. In bfloat16 (the default
compute type): logits 2e-2 absolute, loss 1e-4 relative, each gradient
within 3e-2 in relative norm, a few units of bf16's 2^-8, since the two
frameworks round at different points. The 5-step AdamW trajectory
against optax: the loss 2e-5 relative per step, the gradient norm 2e-3,
the parameters after five steps 2e-4 (see tests/test_torch_train_step.py
for why Adam lets the weights drift that far). Remat: exactly the
no-remat loss and gradients.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu.models.llama import (  # noqa: E402
    Llama as JaxLlama,
    LlamaConfig as JaxLlamaConfig,
    RMSNorm as JaxRMSNorm,
    apply_rope as jax_apply_rope,
    llama_loss_fn as jax_llama_loss_fn,
    rope_freqs as jax_rope_freqs,
)
from ray_tpu.train import (  # noqa: E402
    init_train_state as jax_init_train_state,
    make_multi_train_step as jax_make_multi_train_step,
)
from ray_tpu_torch.models import Llama, LlamaConfig, llama_loss_fn  # noqa: E402
from ray_tpu_torch.models.llama import (  # noqa: E402
    RMSNorm,
    apply_rope,
    rope_freqs,
)
from ray_tpu_torch.train import (  # noqa: E402
    adamw,
    init_train_state,
    make_multi_train_step,
)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


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


def _np(x) -> np.ndarray:
    return np.array(jnp.asarray(x, jnp.float32))


def _pair(kind: str, **kw):
    jdt, tdt = DTYPES[kind]
    jmodel = JaxLlama(JaxLlamaConfig.tiny(dtype=jdt, **kw))
    jparams = jmodel.init_params(jax.random.key(0))
    model = Llama(LlamaConfig.tiny(dtype=tdt, **kw), device="cpu")
    model.load_jax_params(jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, model


def _batch(seed=0, b=2, t=64, vocab=256):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, t)).astype(np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, 1)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _compare_grads(model: Llama, jax_grads, tol: float, norm: bool) -> None:
    ref = Llama(dataclasses.replace(model.config, dtype=torch.float32),
                device="cpu")
    ref.load_jax_params(jax.tree_util.tree_map(np.asarray, jax_grads))
    ref = dict(ref.named_parameters())
    names = [n for n, _ in model.named_parameters()]
    assert names == list(ref)
    for name, p in model.named_parameters():
        got, want = p.grad.float(), ref[name].detach()
        if norm:
            err = float((got - want).norm() / want.norm())
        else:
            err = float((got - want).abs().max() / want.abs().max())
        assert err < tol, f"grad of {name}: {err:.3g} >= {tol}"


def test_config_presets_match():
    for name in ("tiny", "tinyllama_1b", "llama2_7b"):
        ours = dataclasses.asdict(getattr(LlamaConfig, name)())
        ref = dataclasses.asdict(getattr(JaxLlamaConfig, name)())
        for field in ("dtype", "param_dtype"):
            ours.pop(field)
            ref.pop(field)
        assert ours == ref, name
    assert LlamaConfig.tinyllama_1b().head_dim == 64


@pytest.mark.parametrize("kind", sorted(DTYPES))
def test_rope_matches_jax(kind):
    jdt, tdt = DTYPES[kind]
    for head_dim, seq in ((16, 64), (64, 2048)):
        assert np.array_equal(rope_freqs(head_dim, seq, 10000.0).numpy(),
                              np.asarray(jax_rope_freqs(head_dim, seq,
                                                        10000.0)))
    angles = jax_rope_freqs(16, 64, 10000.0)
    x = np.random.default_rng(0).standard_normal((2, 48, 4, 16)).astype(
        np.float32)
    want = _np(jax_apply_rope(jnp.asarray(x, jdt), angles[:48]))
    got = apply_rope(torch.from_numpy(x).to(tdt),
                     torch.from_numpy(_np(angles))[:48])
    assert got.dtype == tdt and got.shape == x.shape
    tol = (1e-6 if kind == "f32" else 2 * 2.0 ** -8) * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("kind", sorted(DTYPES))
def test_rmsnorm_matches_jax(kind):
    jdt, tdt = DTYPES[kind]
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal((2, 8, 64))).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = _np(JaxRMSNorm(dtype=jdt).apply({"params": {"scale": scale}},
                                           jnp.asarray(x, jdt)))
    norm = RMSNorm(64, 1e-5, tdt, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        got = norm(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    tol = (1e-6 if kind == "f32" else 2 * 2.0 ** -8) * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("tie", [True, False])
def test_logits_loss_and_every_gradient_match(tie):
    jmodel, jparams, model = _pair("f32", tie_embeddings=tie)
    batch = _batch()
    ref = np.asarray(jmodel.apply({"params": jparams}, batch["tokens"]))
    with torch.no_grad():
        out = model(torch.from_numpy(batch["tokens"]))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)

    loss_ref, grads_ref = jax.value_and_grad(jax_llama_loss_fn(
        jmodel, ce_chunk=48))(jparams, batch)
    loss = llama_loss_fn(ce_chunk=48)(model, _torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-6)
    _compare_grads(model, grads_ref, tol=1e-5, norm=False)


def test_full_logit_loss_matches():
    jmodel, jparams, model = _pair("f32")
    batch = _batch(seed=1)
    loss_ref = jax_llama_loss_fn(jmodel, fused_ce=False)(jparams, batch)
    with torch.no_grad():
        loss = llama_loss_fn(fused_ce=False)(model, _torch_batch(batch))
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-6)


def test_bf16_logits_loss_and_gradients():
    jmodel, jparams, model = _pair("bf16")
    batch = _batch(seed=2)
    ref = np.asarray(jmodel.apply({"params": jparams}, batch["tokens"]))
    with torch.no_grad():
        out = model(torch.from_numpy(batch["tokens"]))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2, rtol=0)

    loss_ref, grads_ref = jax.value_and_grad(
        jax_llama_loss_fn(jmodel, ce_chunk=48))(jparams, batch)
    loss = llama_loss_fn(ce_chunk=48)(model, _torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-4)
    _compare_grads(model, grads_ref, tol=3e-2, norm=True)


def test_gqa_repeats_each_kv_head_in_place():
    """The attention sees kv head j at query heads 2j and 2j+1
    (``jnp.repeat``), not tiled (``Tensor.repeat`` would give j at j and
    j+2). The two kv heads differ, so the tiled order would fail both the
    check here and the logits test above."""
    _, _, model = _pair("f32")
    seen = []

    def capture(q, k, v):
        seen.append((k, v))
        return model_attn(q, k, v)

    model_attn = model.attn_fn
    model.attn_fn = capture
    with torch.no_grad():
        model(torch.from_numpy(_batch(seed=3)["tokens"]))
    k, v = seen[0]
    assert k.shape[2] == 4
    for x in (k, v):
        assert torch.equal(x[:, :, 0], x[:, :, 1])
        assert torch.equal(x[:, :, 2], x[:, :, 3])
        assert not torch.allclose(x[:, :, 0], x[:, :, 2])


def test_remat_gives_the_no_remat_loss_and_gradients():
    _, _, model = _pair("f32")
    remat = Llama(LlamaConfig.tiny(dtype=torch.float32, remat=True),
                  device="cpu")
    remat.load_state_dict(model.state_dict())
    batch = _torch_batch(_batch(seed=4))
    results = []
    for m in (model, remat):
        loss = llama_loss_fn(ce_chunk=48)(m, batch)
        loss.backward()
        results.append((loss.detach(), [p.grad for p in m.parameters()]))
    (loss0, grads0), (loss1, grads1) = results
    assert torch.equal(loss0, loss1)
    for g0, g1 in zip(grads0, grads1):
        assert torch.equal(g0, g1)


def test_multi_step_trajectory_matches_jax_optax():
    lr, wd = 1e-3, 0.1
    jmodel, jparams, model = _pair("f32")
    jopt = optax.adamw(lr, weight_decay=wd, mu_dtype=jnp.bfloat16)
    jstate = jax_init_train_state(jparams, jopt)
    jstep = jax_make_multi_train_step(jax_llama_loss_fn(jmodel, ce_chunk=64),
                                      jopt)
    opt = adamw(lr, weight_decay=wd, mu_dtype=torch.bfloat16)
    state = init_train_state(model, opt)
    step = make_multi_train_step(llama_loss_fn(ce_chunk=64), opt)

    rng = np.random.default_rng(5)
    losses = []
    for _ in range(5):
        toks = rng.integers(0, 256, (1, 2, 64)).astype(np.int32)
        batch = {"tokens": toks, "targets": np.roll(toks, -1, 2)}
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, _torch_batch(batch))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=2e-5)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=2e-3)
        losses.append(m["loss"].item())
    assert len(set(losses)) == 5                # the weights really moved

    ref = Llama(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    ref.load_jax_params(jax.tree_util.tree_map(np.asarray, jstate.params))
    for (name, p), (_, want) in zip(state.params.named_parameters(),
                                    ref.named_parameters()):
        err = float((p.detach() - want.detach()).abs().max())
        assert err < 2e-4, f"{name} drifted {err:.3g} from the JAX step"


def test_seeded_init_and_param_count():
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    a = Llama(cfg, device="cpu", seed=5)
    b = Llama(cfg, device="cpu", seed=5)
    c = Llama(cfg, device="cpu", seed=6)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a.wte.weight, c.wte.weight)
    jparams = JaxLlama(JaxLlamaConfig.tiny()).init_params(jax.random.key(0))
    assert sum(p.numel() for p in a.parameters()) == sum(
        x.size for x in jax.tree_util.tree_leaves(jparams))
    h = a(torch.zeros(2, 10, dtype=torch.int64), return_hidden=True)
    assert h.shape == (2, 10, cfg.n_embd)


def test_bad_params_raise():
    _, jparams, model = _pair("f32")
    bad = jax.tree_util.tree_map(np.asarray, jparams)
    bad["h_0"]["attn"]["k"]["kernel"] = bad["h_0"]["attn"]["q"]["kernel"]
    with pytest.raises(ValueError, match="does not fit"):
        model.load_jax_params(bad)
