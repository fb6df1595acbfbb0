"""The port's models and train step on a mesh against the JAX package's,
on four gloo ranks on the CPU, and the multi-rank dry run.

One world of 4 ranks (``ray_tpu_torch.parallel.dryrun.spawn``) runs every
case of ``torch_mesh_ranks.train_cases`` from weights and batches made
here (numpy seeds and the JAX models' own initialisation):

- GPT-2 tiny on ``dp 2 × sp 2`` with ring attention: the logits against
  the JAX model's on the whole batch within 2e-2, as
  ``tests/test_models.py`` holds the JAX ring model to the dense one
  (bf16 compute);
- Llama tiny (float32 compute) on ``sp 4`` with ring and with Ulysses:
  the logits within LLAMA_TOL. At initial weights attention is near
  uniform, so the logits hardly see it: in bf16 even RoPE at the wrong
  positions (each rank's rows rotated as rows 0..t) stays inside 2e-2,
  while in float32 it moves them by 5.3e-3 (3.6e-7 without the fault);
- GPT-2 tiny (float32 compute) with ring attention on ``dp 2 × sp 2``,
  three AdamW steps against the JAX step on the same mesh, as below;
- GPT-2 tiny (float32 compute) on ``fsdp 4`` (FSDP2), three AdamW steps
  against the JAX step on an ``fsdp = 4`` mesh, with targets masked
  (``ignore_index``) unevenly over the ranks' rows: each step's loss within
  2e-5 and gradient norm within 2e-3 relative, the parameters within
  2e-4 (the AdamW drift of ``tests/test_torch_train_step.py``);
- ResNet tiny (float32) on ``dp 4``, one SGD-Nesterov step: the loss,
  gradient norm, parameters and running statistics against the JAX step
  on a ``dp = 4`` mesh, whose BatchNorm statistics are those of the
  global batch (``tests/test_torch_resnet.py``'s tolerances). The same
  step with each rank's own statistics must fail the statistics
  tolerance tenfold;
- ViT tiny (float32) on ``dp 4``, one SGD step, likewise (parameters
  within 1e-5: SGD passes gradient differences on at lr 0.1, where
  Adam's first step would turn the near-zero gradients of the key biases
  into full-size updates of either sign);
- ``moe_ffn`` on ``ep 4``, each rank routing its own tokens to experts
  spread over the ranks: output and aux against JAX's ``moe_ffn`` under
  ``shard_map``, and the gradients of ``sum(y²) + 0.01·aux`` summed over
  the ranks against ``jax.grad`` of the dense reference on each rank's
  tokens, within 1e-5;
- ``MoETransformer`` on a mesh of more than one rank raises
  NotImplementedError.

``dryrun_multichip(8)`` spawns its own 8 ranks.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_mesh_ranks  # noqa: E402
from ray_tpu.models import GPT2 as JaxGPT2  # noqa: E402
from ray_tpu.models import GPT2Config as JaxGPT2Config  # noqa: E402
from ray_tpu.models.gpt2 import gpt2_loss_fn as jax_gpt2_loss_fn  # noqa: E402
from ray_tpu.models.llama import Llama as JaxLlama  # noqa: E402
from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from ray_tpu.models.resnet import ResNet as JaxResNet  # noqa: E402
from ray_tpu.models.resnet import (  # noqa: E402
    ResNet50Config as JaxResNet50Config,
    resnet_loss_fn as jax_resnet_loss_fn,
)
from ray_tpu.models.vit import ViT as JaxViT  # noqa: E402
from ray_tpu.models.vit import ViTConfig as JaxViTConfig  # noqa: E402
from ray_tpu.models.vit import vit_loss_fn as jax_vit_loss_fn  # noqa: E402
from ray_tpu.ops.moe import dense_switch_ffn_reference, moe_ffn  # noqa: E402
from ray_tpu.parallel import make_mesh  # noqa: E402
from ray_tpu.train import (  # noqa: E402
    init_train_state as jax_init_train_state,
    make_train_step as jax_make_train_step,
    shard_batch as jax_shard_batch,
)
from ray_tpu_torch.models import GPT2, GPT2Config, ResNet, ResNet50Config  # noqa: E402
from ray_tpu_torch.models import ViT, ViTConfig  # noqa: E402
from ray_tpu_torch.parallel.dryrun import dryrun_multichip, spawn  # noqa: E402

LOGIT_TOL = 2e-2
LLAMA_TOL = 1e-4
LOSS_RTOL, GNORM_RTOL, ADAMW_DRIFT = 2e-5, 2e-3, 2e-4
STATS_TOL = 2e-5
MOE_TOL = 1e-5
FSDP_STEPS = 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree) -> dict[str, np.ndarray]:
    return {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tokens(b, t, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)) \
        .astype(np.int32)


def _perturb_norms(params, seed: int):
    """BatchNorm scales 1 + 0.2 N(0, 1) and biases 0.1 N(0, 1), so that
    no block's gradients are zero at init (``bn3``'s scale is 0)."""
    rng = np.random.default_rng(seed)

    def fix(path, leaf):
        if not path[-2].key.startswith("bn"):
            return leaf
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        return jnp.asarray(1 + 0.2 * noise if path[-1].key == "scale"
                           else 0.1 * noise)

    return jax.tree_util.tree_map_with_path(fix, params)


@pytest.fixture(scope="module")
def setup():
    """The JAX side's models and every input the ranks need."""
    s = {"gpt2": JaxGPT2(JaxGPT2Config.tiny()),
         "gpt2_f32": JaxGPT2(JaxGPT2Config.tiny(dtype=jnp.float32)),
         "llama": JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32)),
         "resnet": JaxResNet(JaxResNet50Config.tiny(dtype=jnp.float32)),
         "vit": JaxViT(JaxViTConfig.tiny(dtype=jnp.float32))}
    s["gpt2_params"] = s["gpt2"].init_params(jax.random.key(0))
    s["gpt2_f32_params"] = s["gpt2_f32"].init_params(jax.random.key(1))
    s["llama_params"] = s["llama"].init_params(jax.random.key(2))
    variables = dict(s["resnet"].init_variables(jax.random.key(3), 32))
    variables["params"] = _perturb_norms(variables["params"], 3)
    s["resnet_variables"] = variables
    s["vit_params"] = s["vit"].init_params(jax.random.key(4))
    rng = np.random.default_rng(5)
    fsdp_batches = []
    for i in range(FSDP_STEPS):
        toks = _tokens(8, 64, 10 + i)
        tgts = np.roll(toks, -1, 1)
        # Masked targets, unevenly over the ranks' rows: the loss is the
        # mean over every unmasked token, not the mean of the ranks' means.
        tgts[:2, 5 * i:40] = -1
        tgts[5, :9] = -1
        fsdp_batches.append({"tokens": toks, "targets": tgts})
    s["inputs"] = {
        "gpt2_params": _np_tree(s["gpt2_params"]),
        "gpt2_tokens": _tokens(4, 64, 6),
        "llama_params": _np_tree(s["llama_params"]),
        "llama_tokens": _tokens(2, 64, 7),
        "gpt2_f32_params": _np_tree(s["gpt2_f32_params"]),
        "gpt2_fsdp_batches": fsdp_batches,
        "resnet_variables": (_np_tree(variables["params"]),
                             _np_tree(variables["batch_stats"])),
        "resnet_batch": {
            "image": rng.standard_normal((16, 32, 32, 3)).astype(np.float32),
            "label": rng.integers(0, 10, (16,)).astype(np.int32)},
        "vit_params": _np_tree(s["vit_params"]),
        "vit_batch": {
            "images": rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, (8,)).astype(np.int32)},
        "moe": (rng.standard_normal((64, 8)).astype(np.float32),
                (rng.standard_normal((8, 8)) * 0.5).astype(np.float32),
                (rng.standard_normal((8, 8, 16)) * 0.3).astype(np.float32),
                (rng.standard_normal((8, 16, 8)) * 0.3).astype(np.float32)),
    }
    return s


@pytest.fixture(scope="module")
def world(setup):
    return spawn(torch_mesh_ranks.train_cases, 4, (setup["inputs"],),
                 device="cpu", timeout=300)


def _case(world, name):
    results = [r[name] for r in world]
    for r in results:
        if isinstance(r, dict):
            assert "error" not in r, r.get("error")
    return results


def _assemble(results, key, dp, sp):
    rows = []
    for i in range(dp):
        blocks = sorted((r for r in results if r["dp"] == i),
                        key=lambda r: r["sp"])
        rows.append(np.concatenate([r[key] for r in blocks], axis=1))
    return np.concatenate(rows, axis=0)


def test_gpt2_ring_dp2_sp2_logits_match_jax(world, setup):
    want = np.asarray(setup["gpt2"].apply(
        {"params": setup["gpt2_params"]}, setup["inputs"]["gpt2_tokens"]))
    got = _assemble(_case(world, "gpt2_ring"), "logits", 2, 2)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_llama_sp4_logits_match_jax(world, setup, impl):
    want = np.asarray(setup["llama"].apply(
        {"params": setup["llama_params"]}, setup["inputs"]["llama_tokens"]))
    got = _assemble(_case(world, f"llama_{impl}"), "logits", 1, 4)
    print(f"llama {impl}: largest |diff| {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=LLAMA_TOL, rtol=LLAMA_TOL)


def _jax_steps(model, loss_fn, params, opt, mesh, batches, extra=None,
               has_extra=False):
    state = jax_init_train_state(params, opt, mesh, extra=extra)
    step = jax_make_train_step(loss_fn, opt, has_extra=has_extra)
    metrics = []
    for batch in batches:
        state, m = step(state, jax_shard_batch(batch, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _port_layout(model_cls, config, params) -> dict:
    """JAX parameters in the port's names and layouts, through the port
    model's own ``load_jax_params``."""
    model = model_cls(config, device="cpu")
    model.load_jax_params(_np_tree(params))
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


def test_gpt2_fsdp4_adamw_steps_match_jax(world, setup):
    opt = optax.adamw(1e-3, weight_decay=0.1, mu_dtype=jnp.bfloat16)
    mesh = make_mesh({"fsdp": 4})
    model = JaxGPT2(JaxGPT2Config.tiny(dtype=jnp.float32), mesh=mesh)
    jstate, jmetrics = _jax_steps(
        model, jax_gpt2_loss_fn(model, ce_chunk=64),
        setup["gpt2_f32_params"], opt, mesh,
        setup["inputs"]["gpt2_fsdp_batches"])
    want = _port_layout(GPT2, GPT2Config.tiny(dtype=torch.float32),
                        jstate.params)
    for r in _case(world, "gpt2_fsdp"):
        assert r["wte"] == ["Shard(dim=1)"]       # split on embed
        for got_m, want_m in zip(r["metrics"], jmetrics):
            np.testing.assert_allclose(got_m["loss"], want_m["loss"],
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(got_m["grad_norm"],
                                       want_m["grad_norm"], rtol=GNORM_RTOL)
        for name, w in want.items():
            err = float(np.abs(r["params"][name] - w).max())
            assert err < ADAMW_DRIFT, f"{name} drifted {err:.3g}"


def test_gpt2_ring_dp2_sp2_adamw_steps_match_jax(world, setup):
    """The sequence ranks saw other tokens of the same weights: their
    gradients must be averaged with the data ranks', or the weights
    drift from the JAX step's at once."""
    opt = optax.adamw(1e-3, weight_decay=0.1, mu_dtype=jnp.bfloat16)
    mesh = make_mesh({"dp": 2, "sp": 2})
    model = JaxGPT2(JaxGPT2Config.tiny(dtype=jnp.float32, attn_impl="ring"),
                    mesh=mesh)
    state = jax_init_train_state(setup["gpt2_f32_params"], opt, mesh)
    step = jax_make_train_step(jax_gpt2_loss_fn(model, ce_chunk=64), opt)
    jmetrics = []
    for batch in setup["inputs"]["gpt2_fsdp_batches"]:
        state, m = step(state, jax_shard_batch(batch, mesh,
                                               seq_sharded=True))
        jmetrics.append({k: float(v) for k, v in m.items()})
    want = _port_layout(GPT2, GPT2Config.tiny(dtype=torch.float32),
                        state.params)
    for r in _case(world, "gpt2_ring_train"):
        for got_m, want_m in zip(r["metrics"], jmetrics):
            np.testing.assert_allclose(got_m["loss"], want_m["loss"],
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(got_m["grad_norm"],
                                       want_m["grad_norm"], rtol=GNORM_RTOL)
        for name, w in want.items():
            err = float(np.abs(r["params"][name] - w).max())
            assert err < ADAMW_DRIFT, f"{name} drifted {err:.3g}"


def _stats_err(got: dict, want: dict) -> float:
    assert sorted(got) == sorted(want)
    return max(float(np.abs(np.asarray(got[k]) - want[k]).max()
                     / np.abs(want[k]).max()) for k in want)


@pytest.fixture(scope="module")
def resnet_jax(setup):
    mesh = make_mesh({"dp": 4})
    model = setup["resnet"]
    variables = setup["resnet_variables"]
    return _jax_steps(
        model, jax_resnet_loss_fn(model), variables["params"],
        optax.sgd(0.1, momentum=0.9, nesterov=True), mesh,
        [setup["inputs"]["resnet_batch"]],
        extra=variables["batch_stats"], has_extra=True)


def test_resnet_dp4_global_batch_norm_matches_jax(world, resnet_jax):
    jstate, jmetrics = resnet_jax
    want_stats = _flat(jstate.extra)
    want_params = _port_layout(ResNet,
                               ResNet50Config.tiny(dtype=torch.float32),
                               jstate.params)
    for r in _case(world, "resnet"):
        np.testing.assert_allclose(r["loss"], jmetrics[0]["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], jmetrics[0]["grad_norm"],
                                   rtol=1e-4)
        assert _stats_err(r["stats"], want_stats) < STATS_TOL
        for name, w in want_params.items():
            err = float(np.abs(r["params"][name] - w).max()
                        / np.abs(w).max())
            assert err < 1e-5, f"{name} drifted {err:.3g}"


def test_resnet_local_statistics_fail_the_tolerance(world, resnet_jax):
    """Each rank's own BatchNorm statistics, not the global batch's: the
    port before this mesh support. The statistics tolerance must fail it
    tenfold on every rank."""
    want_stats = _flat(resnet_jax[0].extra)
    for r in _case(world, "resnet_local_stats"):
        assert _stats_err(r["stats"], want_stats) > 10 * STATS_TOL


def test_vit_dp4_step_matches_jax(world, setup):
    mesh = make_mesh({"dp": 4})
    model = setup["vit"]
    jstate, jmetrics = _jax_steps(
        model, jax_vit_loss_fn(model), setup["vit_params"],
        optax.sgd(0.1), mesh, [setup["inputs"]["vit_batch"]])
    want = _port_layout(ViT, ViTConfig.tiny(dtype=torch.float32),
                        jstate.params)
    for r in _case(world, "vit"):
        np.testing.assert_allclose(r["loss"], jmetrics[0]["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], jmetrics[0]["grad_norm"],
                                   rtol=1e-4)
        for name, w in want.items():
            err = float(np.abs(r["params"][name] - w).max())
            assert err < 1e-5, f"{name} drifted {err:.3g}"


def test_moe_ffn_ep4_matches_jax(world, setup):
    x, router, w_up, w_down = setup["inputs"]["moe"]
    mesh = make_mesh({"ep": 4})
    def inner(x, rw, wu, wd):
        y, aux = moe_ffn(x, rw, wu, wd, axis="ep")
        return y, aux.reshape(1)

    f = jax.jit(jax.shard_map(
        inner, mesh=mesh, in_specs=(P("ep"), P(), P("ep"), P("ep")),
        out_specs=(P("ep"), P("ep")), check_vma=False))
    y, aux = f(x, router, w_up, w_down)
    y = np.asarray(y).reshape(4, -1, x.shape[1])
    aux = np.asarray(aux).reshape(-1)

    def loss(rw, wu, wd, xs):
        yd, a = dense_switch_ffn_reference(xs, rw, wu, wd)
        return jnp.sum(yd ** 2) + 0.01 * a

    grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
    grads = [grad(router, w_up, w_down, xs) for xs in x.reshape(4, -1, 8)]
    want = [np.sum([np.asarray(g[i]) for g in grads], axis=0)
            for i in range(3)]
    e_local = w_up.shape[0] // 4
    for r in _case(world, "moe"):
        i = r["ep"]
        np.testing.assert_allclose(r["y"], y[i], atol=MOE_TOL, rtol=MOE_TOL)
        np.testing.assert_allclose(float(r["aux"]), aux[i], rtol=MOE_TOL)
        # The router is replicated: its gradient sums over the ranks once
        # the step averages it; each rank holds its own tokens' share.
        mine = slice(i * e_local, (i + 1) * e_local)
        np.testing.assert_allclose(r["w_up"], want[1][mine], atol=MOE_TOL,
                                   rtol=MOE_TOL)
        np.testing.assert_allclose(r["w_down"], want[2][mine], atol=MOE_TOL,
                                   rtol=MOE_TOL)
        np.testing.assert_allclose(
            r["router"], np.asarray(grads[i][0]), atol=MOE_TOL, rtol=MOE_TOL)


def test_moe_transformer_on_a_mesh_raises(world):
    for r in _case(world, "moe_model_raises"):
        assert "ROADMAP §1" in r


def test_dryrun_multichip_8():
    results = dryrun_multichip(8, device="cpu")
    assert len(results) == 8
    assert all(r["device"] == "cpu" for r in results)
    assert all(r["factors"] == {"dp": 4, "sp": 2} for r in results)
    losses = {r["loss"] for r in results}
    assert len(losses) == 1 and np.isfinite(losses.pop())
    assert all(r["moe"]["ep"] == 4 and np.isfinite(r["moe"]["aux"])
               for r in results)
