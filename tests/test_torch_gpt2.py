"""The port's GPT-2 against the JAX package's, on shared weights.

The flax params of ``ray_tpu.models.GPT2`` (``GPT2Config.tiny``) are
carried into ``ray_tpu_torch.models.GPT2`` by ``load_jax_params``; both
get the same numpy-seeded tokens on the CPU. JAX attention on the CPU is
XLA's dense path, the port's is the flash kernels' plain version.

Tolerances, float32 on both sides (``dtype=float32``): logits 1e-5
absolute (values of ~1); loss 1e-6 relative; every gradient within 1e-5
of the largest entry of its JAX counterpart — only summation order
differs. The chunked cross-entropy alone: 1e-6 / 1e-5. The one bfloat16
case (the models' default compute type): logits 2e-2 absolute and each
gradient within 3e-2 in relative norm, a few units of bf16's 2^-8 last
place, since the two frameworks round matmul outputs and elementwise
ops at different points; the loss, a mean over rows in float32, within
1e-4 relative.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import GPT2 as JaxGPT2  # noqa: E402
from ray_tpu.models import GPT2Config as JaxGPT2Config  # noqa: E402
from ray_tpu.models.gpt2 import (  # noqa: E402
    chunked_cross_entropy as jax_chunked_ce,
    gpt2_loss_fn as jax_gpt2_loss_fn,
)
from ray_tpu_torch.models import GPT2, GPT2Config  # noqa: E402
from ray_tpu_torch.models.gpt2 import (  # noqa: E402
    chunked_cross_entropy,
    gpt2_loss_fn,
)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes on one host: keep torch's CPU
    kernels to two threads here so timing-sensitive runtime tests in the
    other processes are not starved."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(kind: str):
    jdt, tdt = DTYPES[kind]
    jmodel = JaxGPT2(JaxGPT2Config.tiny(dtype=jdt))
    jparams = jmodel.init_params(jax.random.key(0))
    model = GPT2(GPT2Config.tiny(dtype=tdt), device="cpu")
    model.load_jax_params(jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, model


def _batch(seed=0, b=2, t=64, vocab=256):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, t)).astype(np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, 1)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads_as_module(grads) -> GPT2:
    """The JAX gradient tree laid out like the port's parameters."""
    g = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    g.load_jax_params(jax.tree_util.tree_map(np.asarray, grads))
    return g


def _compare_grads(model: GPT2, jax_grads, tol: float, norm: bool) -> None:
    ref = dict(_grads_as_module(jax_grads).named_parameters())
    names = [n for n, _ in model.named_parameters()]
    assert names == list(ref)
    for name, p in model.named_parameters():
        got, want = p.grad.float(), ref[name].detach()
        if norm:
            err = float((got - want).norm() / want.norm())
        else:
            err = float((got - want).abs().max() / want.abs().max())
        assert err < tol, f"grad of {name}: {err:.3g} >= {tol}"


def test_logits_match():
    jmodel, jparams, model = _pair("f32")
    batch = _batch()
    ref = np.asarray(jmodel.apply({"params": jparams}, batch["tokens"]))
    with torch.no_grad():
        out = model(torch.from_numpy(batch["tokens"]))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fused_ce", [True, False])
def test_loss_and_every_gradient_match(fused_ce):
    """ce_chunk=48 over 128 rows: the chunked path pads its last chunk."""
    jmodel, jparams, model = _pair("f32")
    batch = _batch(seed=1)
    loss_ref, grads_ref = jax.value_and_grad(jax_gpt2_loss_fn(
        jmodel, fused_ce=fused_ce, ce_chunk=48))(jparams, batch)
    loss = gpt2_loss_fn(fused_ce=fused_ce, ce_chunk=48)(
        model, _torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-6)
    _compare_grads(model, grads_ref, tol=1e-5, norm=False)


@pytest.mark.parametrize("chunk", [16, 100, 2048])
def test_chunked_cross_entropy_matches_jax(chunk):
    """100 rows: a chunk of 16 pads the last chunk, 100 divides exactly,
    2048 is one short chunk. Some targets are ignore_index (-1)."""
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((4, 25, 32)).astype(np.float32)
    emb = (0.1 * rng.standard_normal((80, 32))).astype(np.float32)
    targets = rng.integers(0, 80, (4, 25)).astype(np.int32)
    targets[0, :7] = -1

    def jloss(h, e):
        return jax_chunked_ce(h, e, targets, chunk_size=chunk)

    loss_ref, (dh_ref, de_ref) = jax.value_and_grad(
        jloss, argnums=(0, 1))(hidden, emb)
    h = torch.from_numpy(hidden).requires_grad_()
    e = torch.from_numpy(emb).requires_grad_()
    loss = chunked_cross_entropy(h, e, torch.from_numpy(targets),
                                 chunk_size=chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-6)
    for got, want in ((h.grad, dh_ref), (e.grad, de_ref)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_bf16_logits_loss_and_gradients():
    jmodel, jparams, model = _pair("bf16")
    batch = _batch(seed=3)
    ref = np.asarray(jmodel.apply({"params": jparams}, batch["tokens"]))
    with torch.no_grad():
        out = model(torch.from_numpy(batch["tokens"]))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2, rtol=0)

    loss_ref, grads_ref = jax.value_and_grad(
        jax_gpt2_loss_fn(jmodel, ce_chunk=48))(jparams, batch)
    loss = gpt2_loss_fn(ce_chunk=48)(model, _torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-4)
    _compare_grads(model, grads_ref, tol=3e-2, norm=True)


def test_config_presets_and_param_count():
    for name in ("small", "medium", "large", "tiny"):
        ours = getattr(GPT2Config, name)()
        ref = getattr(JaxGPT2Config, name)()
        assert (ours.n_layer, ours.n_head, ours.n_embd, ours.seq_len,
                ours.vocab_size) == (ref.n_layer, ref.n_head, ref.n_embd,
                                     ref.seq_len, ref.vocab_size)
        assert ours.num_params() == ref.num_params()
    model = GPT2(GPT2Config.tiny(), device="cpu")
    assert sum(p.numel() for p in model.parameters()) \
        == GPT2Config.tiny().num_params()


def test_return_hidden_and_seeded_init():
    cfg = GPT2Config.tiny(dtype=torch.float32)
    a = GPT2(cfg, device="cpu", seed=5)
    b = GPT2(cfg, device="cpu", seed=5)
    c = GPT2(cfg, device="cpu", seed=6)
    for (_, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a.wte.weight, c.wte.weight)
    h = a(torch.zeros(2, 10, dtype=torch.int64), return_hidden=True)
    assert h.shape == (2, 10, cfg.n_embd)


def test_dropout_and_bad_params_raise():
    with pytest.raises(NotImplementedError):
        GPT2(GPT2Config.tiny(dropout=0.1), device="cpu")
    _, jparams, model = _pair("f32")
    bad = jax.tree_util.tree_map(np.asarray, jparams)
    bad["wte"]["embedding"] = bad["wte"]["embedding"][:10]
    with pytest.raises(ValueError, match="does not fit"):
        model.load_jax_params(bad)
