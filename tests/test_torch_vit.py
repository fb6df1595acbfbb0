"""The port's ViT against the JAX package's, on shared weights.

The flax params of ``ray_tpu.models.ViT`` are carried into
``ray_tpu_torch.models.ViT`` by ``load_jax_params``; both get the same
numpy-seeded images on the CPU. Two sizes: ``ViTConfig.tiny()`` (head_dim
16) and a tiny variant with head_dim 64, the width the flash kernels take
on the card (``n_embd`` 128, 2 heads). T = 17 (16 patches and the CLS
token). JAX attention is ``jax.nn.dot_product_attention`` (XLA's dense
path on the CPU), the port's the flash kernels' plain version with
``causal=False``.

Tolerances. In float32 only summation order differs: logits 1e-5
absolute (they are O(1)), the loss 1e-6 relative, every gradient within
1e-5 of its JAX counterpart's largest entry, as for GPT-2. The key
biases are the exception: the softmax ignores a score shift shared by
all keys, so their gradient is zero in exact arithmetic and both sides
hold rounding noise (~3e-8, where the query biases' gradients are
~0.2); they are held to 1e-6 absolute. Flax's ``nn.gelu`` is the tanh
approximation; the exact (erf) GELU moves the logits by about 1e-3,
which the mutation test below holds against the logit limit. The 3-step
``adamw(3e-3)`` trajectory (optax's defaults, as
``tests/test_models_extended.py`` trains the JAX ViT): the loss 2e-5
relative per step, and each parameter's distance from the JAX step's
within 2e-3 of how far the JAX step moved it (3e-4 seen: Adam divides
each entry by its own running RMS, which grows ~1e-7 gradient
differences on entries with small gradients). Adam turns the key
biases' noise into full steps of either sign, so they are held only to
Adam's step bound, lr per step. Remat: exactly the no-remat loss and
gradients. In bfloat16 (the default compute type): logits within 5e-2
in relative norm.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu.models.vit import (  # noqa: E402
    ViT as JaxViT,
    ViTConfig as JaxViTConfig,
    vit_loss_fn as jax_vit_loss_fn,
)
from ray_tpu.train import (  # noqa: E402
    init_train_state as jax_init_train_state,
    make_multi_train_step as jax_make_multi_train_step,
)
from ray_tpu_torch.models import ViT, ViTConfig, vit_loss_fn  # noqa: E402
from ray_tpu_torch.models import vit as vit_mod  # noqa: E402
from ray_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from ray_tpu_torch.train import (  # noqa: E402
    adamw,
    init_train_state,
    make_multi_train_step,
)

WIDTHS = {"tiny": {}, "head_dim_64": {"n_embd": 128, "n_head": 2}}
LOGIT_TOL = 1e-5


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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(width: str, dtype=jnp.float32, tdtype=torch.float32, seed=0,
          **kw):
    kw = {**WIDTHS[width], **kw}
    jmodel = JaxViT(JaxViTConfig.tiny(dtype=dtype, **kw))
    jparams = jmodel.init_params(jax.random.key(seed))
    model = ViT(ViTConfig.tiny(dtype=tdtype, **kw), device="cpu")
    model.load_jax_params(_np_tree(jparams))
    return jmodel, jparams, model


def _batch(b: int = 2, seed: int = 0, k: int | None = None):
    rng = np.random.default_rng(seed)
    lead = (b,) if k is None else (k, b)
    return {"images": rng.standard_normal(lead + (32, 32, 3))
            .astype(np.float32),
            "labels": rng.integers(0, 10, lead).astype(np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_config_presets_match():
    for name in ("base", "tiny"):
        ours = dataclasses.asdict(getattr(ViTConfig, name)())
        ref = dataclasses.asdict(getattr(JaxViTConfig, name)())
        for field in ("dtype", "param_dtype"):
            ours.pop(field)
            ref.pop(field)
        assert ours == ref, name
    base = ViTConfig.base()
    assert (base.head_dim, base.num_patches + 1) == (64, 197)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_logits_loss_and_every_gradient_match(width):
    jmodel, jparams, model = _pair(width)
    batch = _batch()
    want = np.asarray(jmodel.apply({"params": jparams}, batch["images"]))
    with torch.no_grad():
        got = model(torch.from_numpy(batch["images"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL, rtol=0)

    loss_ref, grads_ref = jax.value_and_grad(jax_vit_loss_fn(jmodel))(
        jparams, batch)
    loss = vit_loss_fn()(model, _torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-6)
    ref = ViT(model.config, device="cpu")
    ref.load_jax_params(_np_tree(grads_ref))
    ref = dict(ref.named_parameters())
    names = [n for n, _ in model.named_parameters()]
    assert names == list(ref)
    for name, p in model.named_parameters():
        want_g = ref[name].detach()
        if name.endswith(".k.bias"):
            assert float(p.grad.abs().max()) < 1e-6
            assert float(want_g.abs().max()) < 1e-6
            continue
        err = float((p.grad - want_g).abs().max() / want_g.abs().max())
        assert err < 1e-5, f"grad of {name}: {err:.3g}"


def test_attention_is_the_kernels_non_causal_route(monkeypatch):
    """Each block's attention goes through the flash forward with
    ``causal=False`` (on the CPU, its plain version), once per layer."""
    calls = []
    plain = fa.flash_fwd_reference

    def counting(q, k, v, scale, causal=True):
        calls.append((tuple(q.shape), causal, scale))
        return plain(q, k, v, scale, causal)

    monkeypatch.setattr(fa, "flash_fwd_reference", counting)
    _, _, model = _pair("head_dim_64")
    with torch.no_grad():
        model(torch.from_numpy(_batch()["images"]))
    assert calls == [((2 * 2, 17, 64), False, 64 ** -0.5)] * 2


def test_erf_gelu_fails_the_logit_tolerance(monkeypatch):
    jmodel, jparams, model = _pair("tiny")
    images = _batch(seed=1)["images"]
    want = np.asarray(jmodel.apply({"params": jparams}, images))
    gelu = F.gelu
    monkeypatch.setattr(vit_mod.F, "gelu",
                        lambda x, approximate="none": gelu(x))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert float(np.abs(got.numpy() - want).max()) > 10 * LOGIT_TOL


def test_adamw_trajectory_matches_jax_optax():
    jmodel, jparams, model = _pair("head_dim_64", seed=1)
    initial = {n: p.detach().clone() for n, p in model.named_parameters()}
    jopt = optax.adamw(3e-3)
    jstate = jax_init_train_state(jparams, jopt)
    jstep = jax_make_multi_train_step(jax_vit_loss_fn(jmodel), jopt)
    opt = adamw(3e-3)
    state = init_train_state(model, opt)
    step = make_multi_train_step(vit_loss_fn(), opt)
    losses = []
    for i in range(3):
        batch = _batch(seed=10 + i, k=1)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, _torch(batch))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=2e-5)
        losses.append(m["loss"].item())
    assert len(set(losses)) == 3                # the weights really moved
    ref = ViT(model.config, device="cpu")
    ref.load_jax_params(_np_tree(jstate.params))
    for (name, p), (_, want) in zip(state.params.named_parameters(),
                                    ref.named_parameters()):
        p, want, p0 = p.detach(), want.detach(), initial[name]
        if name.endswith(".k.bias"):
            for x in (p, want):
                assert float((x - p0).abs().max()) <= 3 * 3e-3 * 1.01
            continue
        err = float((p - want).norm() / (want - p0).norm())
        assert err < 2e-3, f"{name} drifted {err:.3g} of its step from JAX's"


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_remat_gives_the_no_remat_loss_and_gradients(width):
    _, _, model = _pair(width)
    remat = ViT(dataclasses.replace(model.config, remat=True), device="cpu")
    remat.load_state_dict(model.state_dict())
    batch = _torch(_batch(seed=2))
    results = []
    for m in (model, remat):
        loss = vit_loss_fn()(m, batch)
        loss.backward()
        results.append((loss.detach(), [p.grad for p in m.parameters()]))
    (loss0, grads0), (loss1, grads1) = results
    assert torch.equal(loss0, loss1)
    for g0, g1 in zip(grads0, grads1):
        assert torch.equal(g0, g1)


def test_bf16_logits_match():
    jmodel, jparams, model = _pair("head_dim_64", dtype=jnp.bfloat16,
                                   tdtype=torch.bfloat16, seed=3)
    images = _batch(b=4, seed=4)["images"]
    want = np.asarray(jmodel.apply({"params": jparams}, images))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    rel = float(np.linalg.norm(got.numpy() - want) / np.linalg.norm(want))
    assert rel < 5e-2, rel


def test_seeded_init_and_param_count():
    cfg = ViTConfig.tiny(dtype=torch.float32)
    a = ViT(cfg, device="cpu", seed=5)
    b = ViT(cfg, device="cpu", seed=5)
    c = ViT(cfg, device="cpu", seed=6)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a.pos_embed, c.pos_embed)
    assert torch.equal(a.cls, torch.zeros_like(a.cls))
    jparams = JaxViT(JaxViTConfig.tiny()).init_params(jax.random.key(0))
    assert sum(p.numel() for p in a.parameters()) == sum(
        x.size for x in jax.tree_util.tree_leaves(jparams))
    # xavier_uniform on the block denses: |w| <= sqrt(6 / (fan_in + fan_out)).
    w = a.h[0].fc.weight.detach()
    assert float(w.abs().max()) <= (6 / sum(w.shape)) ** 0.5


def test_bad_params_raise():
    _, jparams, model = _pair("tiny")
    bad = _np_tree(jparams)
    bad["h_0"]["fc"]["kernel"] = bad["h_0"]["q"]["kernel"]
    with pytest.raises(ValueError, match="does not fit"):
        model.load_jax_params(bad)
