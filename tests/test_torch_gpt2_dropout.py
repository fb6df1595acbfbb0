"""GPT-2 with ``dropout > 0`` in the port against the JAX package.

The JAX model applies ``nn.Dropout`` at the embedding sum, the attention
projection's output and the MLP's output, only under
``deterministic=False`` with a ``dropout`` rng; its loss (``gpt2_loss_fn``)
never asks for that, so the JAX package trains a config with dropout as
one without. The port does the same: its loss and train step run the
model deterministically, and ``forward(tokens, deterministic=False,
generator=g)`` draws the masks from ``g``.

Checks, on GPT-2 tiny (``GPT2Config.tiny``) with weights carried from the
JAX model, float32 on the CPU:

- the loss and every gradient at ``dropout=0.1`` against the JAX
  ``gpt2_loss_fn`` at ``dropout=0.1``, within the GPT-2 tiny limits of
  tests/test_torch_gpt2.py (loss 1e-6 relative, gradients 1e-5 of the
  largest entry), and bit-equal to the port at ``dropout=0``; the train
  step's losses bit-equal too;
- under ``deterministic=False``: the share of kept activations at every
  dropout site within 4σ of 0.9 (σ of a binomial share), each kept value
  its input times 1/0.9 exactly as the op computes it, the same
  generator seed giving the same output and two draws differing; remat
  recomputes a block with the same masks (gradients bit-equal to the
  block without remat);
- flax's ``deterministic=False`` output with ``rngs={"dropout": key}``
  keeps the same share within 4σ: a statistic only, since flax's random
  bits and torch's differ.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import GPT2 as JaxGPT2  # noqa: E402
from ray_tpu.models import GPT2Config as JaxGPT2Config  # noqa: E402
from ray_tpu.models.gpt2 import gpt2_loss_fn as jax_gpt2_loss_fn  # noqa: E402
from ray_tpu_torch.models import GPT2, GPT2Config  # noqa: E402
from ray_tpu_torch.models import gpt2 as port_gpt2  # noqa: E402
from ray_tpu_torch.models.gpt2 import gpt2_loss_fn  # noqa: E402
from ray_tpu_torch.train import (  # noqa: E402
    adamw,
    init_train_state,
    make_train_step,
)

RATE = 0.1
KEEP = 1.0 - RATE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module, as every test_torch_* file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(rate: float = RATE):
    jmodel = JaxGPT2(JaxGPT2Config.tiny(dtype=jnp.float32, dropout=rate))
    return jmodel, jmodel.init_params(jax.random.key(0))


def _port(params, rate: float = RATE, **kw) -> GPT2:
    model = GPT2(GPT2Config.tiny(dtype=torch.float32, dropout=rate, **kw),
                 device="cpu")
    model.load_jax_params(jax.tree_util.tree_map(np.asarray, params))
    return model


def _batch(seed=0, b=2, t=64, vocab=256):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, t)).astype(np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, 1)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("fused_ce", [True, False])
def test_loss_at_dropout_matches_jax_and_the_port_without(fused_ce):
    jmodel, jparams = _jax_params()
    batch = _batch(seed=1)
    loss_ref, grads_ref = jax.value_and_grad(jax_gpt2_loss_fn(
        jmodel, fused_ce=fused_ce, ce_chunk=48))(jparams, batch)
    losses, grads = [], []
    for rate in (RATE, 0.0):
        model = _port(jparams, rate)
        loss = gpt2_loss_fn(fused_ce=fused_ce, ce_chunk=48)(
            model, _torch_batch(batch))
        loss.backward()
        losses.append(loss.detach())
        grads.append({n: p.grad for n, p in model.named_parameters()})
    np.testing.assert_allclose(losses[0].item(), float(loss_ref), rtol=1e-6)
    ref = _port(grads_ref, 0.0)
    for name, want in ref.named_parameters():
        got = grads[0][name]
        want = want.detach()
        err = float((got - want).abs().max() / want.abs().max())
        assert err < 1e-5, f"grad of {name}: {err:.3g}"
    assert torch.equal(losses[0], losses[1])
    assert all(torch.equal(grads[0][n], grads[1][n]) for n in grads[0])


def test_train_step_with_dropout_is_the_step_without():
    _, jparams = _jax_params()
    batch = _torch_batch(_batch(seed=2))
    runs = []
    for rate in (RATE, 0.0):
        model = _port(jparams, rate)
        opt = adamw(1e-3, weight_decay=0.1)
        state = init_train_state(model, opt)
        step = make_train_step(gpt2_loss_fn(ce_chunk=64), opt)
        runs.append([step(state, batch)[1]["loss"].item()
                     for _ in range(3)])
    assert runs[0] == runs[1]


def test_deterministic_forward_is_the_forward_without_dropout():
    _, jparams = _jax_params()
    tokens = torch.from_numpy(_batch()["tokens"])
    with torch.no_grad():
        assert torch.equal(_port(jparams)(tokens),
                           _port(jparams, 0.0)(tokens))


def _recorded(monkeypatch) -> list:
    """Every (input, mask, output) of the port's dropout sites."""
    seen = []
    inner = port_gpt2.dropout

    def recording(x, keep, rate):
        out = inner(x, keep, rate)
        seen.append((x.detach(), keep, out.detach()))
        return out

    monkeypatch.setattr(port_gpt2, "dropout", recording)
    return seen


def _within_4_sigma(share: float, n: int) -> bool:
    return abs(share - KEEP) <= 4 * math.sqrt(KEEP * RATE / n)


def test_keep_share_and_scale(monkeypatch):
    _, jparams = _jax_params()
    model = _port(jparams)
    seen = _recorded(monkeypatch)
    tokens = torch.from_numpy(_batch(b=4)["tokens"])
    with torch.no_grad():
        model(tokens, deterministic=False,
              generator=torch.Generator().manual_seed(0))
    assert len(seen) == 1 + 2 * model.config.n_layer
    for x, keep, out in seen:
        assert keep is not None and keep.shape == x.shape
        assert _within_4_sigma(float(keep.float().mean()), keep.numel())
        assert torch.equal(out[keep], (x / KEEP)[keep])
        assert not out[~keep].any()


def test_same_seed_same_output_and_draws_differ():
    _, jparams = _jax_params()
    model = _port(jparams)
    tokens = torch.from_numpy(_batch()["tokens"])
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        a = model(tokens, deterministic=False, generator=g)
        b = model(tokens, deterministic=False, generator=g)
        c = model(tokens, deterministic=False,
                  generator=torch.Generator().manual_seed(7))
    assert torch.equal(a, c)
    assert not torch.equal(a, b)


def test_deterministic_false_needs_a_generator():
    _, jparams = _jax_params()
    with pytest.raises(ValueError, match="generator="):
        _port(jparams)(torch.zeros(1, 8, dtype=torch.long),
                       deterministic=False)


def test_remat_recomputes_a_block_with_its_masks():
    _, jparams = _jax_params()
    tokens = torch.from_numpy(_batch()["tokens"])
    grads = []
    for remat in (False, True):
        model = _port(jparams, remat=remat)
        out = model(tokens, deterministic=False,
                    generator=torch.Generator().manual_seed(3))
        out.square().mean().backward()
        grads.append([p.grad for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_flax_keeps_the_same_share():
    """Flax's own dropout at the three sites keeps 0.9 of the
    activations within 4σ, as the port's does (a statistic: their random
    bits differ)."""
    jmodel, jparams = _jax_params()
    tokens = _batch(b=4)["tokens"]
    _, state = jmodel.apply({"params": jparams}, tokens, deterministic=False,
                            rngs={"dropout": jax.random.key(1)},
                            capture_intermediates=True)
    outs = []

    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k == "__call__" and path and "Dropout" in path[-1]:
                outs.extend(np.asarray(o) for o in v)

    walk(state["intermediates"])
    assert len(outs) == 1 + 2 * JaxGPT2Config.tiny().n_layer
    kept = np.concatenate([(o != 0).ravel() for o in outs])
    assert _within_4_sigma(float(kept.mean()), kept.size)
