"""The port's tensor parallelism against the JAX package's, on four gloo
ranks on the CPU.

One world of 4 ranks (``ray_tpu_torch.parallel.dryrun.spawn``) runs every
case of ``torch_mesh_ranks.tensor_parallel_cases`` from the JAX models'
own initialisation and numpy-seeded batches; the test process holds each
rank's results against the JAX package on a mesh of the same shape on the
virtual CPU devices, where XLA's sharding propagation splits the same
weights (``ray_tpu.parallel.sharding``'s table):

- GPT-2 tiny on ``dp 2 × tp 2``, ``tp 4`` and ``sp 2 × tp 2`` (ring and
  Ulysses on each rank's heads): the logits, each rank's gathered over
  its vocabulary block, within 2e-2 (bf16 compute, as
  ``tests/test_torch_mesh_train.py`` holds the ring model);
- GPT-2 tiny (float32 compute) on ``dp 2 × tp 2``, ``tp 4``, ``sp 2 ×
  tp 2`` (ring) and ``fsdp 2 × tp 2`` (FSDP2 on each rank's tp blocks),
  three AdamW steps against the JAX step, with targets
  masked unevenly over the rows: each step's loss within 2e-5 and
  gradient norm within 2e-3 relative, each rank's block of every
  parameter within 2e-4 (the AdamW drift of
  ``tests/test_torch_train_step.py``);
- Llama tiny (float32) on ``tp 4``, where each kv head is split over two
  ranks, and on ``dp 2 × tp 2``: the logits within 1e-4, and one AdamW
  step of the untied-head model as above.
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

import torch_mesh_ranks  # noqa: E402
from ray_tpu.models import GPT2 as JaxGPT2  # noqa: E402
from ray_tpu.models import GPT2Config as JaxGPT2Config  # noqa: E402
from ray_tpu.models.gpt2 import gpt2_loss_fn as jax_gpt2_loss_fn  # noqa: E402
from ray_tpu.models.llama import Llama as JaxLlama  # noqa: E402
from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from ray_tpu.models.llama import llama_loss_fn as jax_llama_loss_fn  # noqa: E402
from ray_tpu.parallel import make_mesh  # noqa: E402
from ray_tpu.parallel.sharding import place_params  # noqa: E402
from ray_tpu.train import (  # noqa: E402
    init_train_state as jax_init_train_state,
    make_train_step as jax_make_train_step,
    shard_batch as jax_shard_batch,
)
from ray_tpu_torch.models import GPT2, GPT2Config, Llama, LlamaConfig  # noqa: E402
from ray_tpu_torch.parallel.dryrun import spawn  # noqa: E402

LOGIT_TOL = 2e-2
LLAMA_TOL = 1e-4
LOSS_RTOL, GNORM_RTOL, ADAMW_DRIFT = 2e-5, 2e-3, 2e-4
STEPS = 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(b, t, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def setup():
    s = {"gpt2": JaxGPT2Config.tiny(),
         "gpt2_f32": JaxGPT2Config.tiny(dtype=jnp.float32),
         "llama": JaxLlamaConfig.tiny(dtype=jnp.float32),
         "llama_untied": JaxLlamaConfig.tiny(dtype=jnp.float32,
                                             tie_embeddings=False)}
    s["gpt2_params"] = JaxGPT2(s["gpt2"]).init_params(jax.random.key(0))
    s["gpt2_f32_params"] = JaxGPT2(s["gpt2_f32"]).init_params(
        jax.random.key(1))
    s["llama_params"] = JaxLlama(s["llama"]).init_params(jax.random.key(2))
    s["llama_untied_params"] = JaxLlama(s["llama_untied"]).init_params(
        jax.random.key(3))
    batches = []
    for i in range(STEPS):
        toks = _tokens(8, 64, 20 + i)
        tgts = np.roll(toks, -1, 1)
        tgts[:2, 5 * i:40] = -1                  # masked unevenly
        tgts[5, :9] = -1
        batches.append({"tokens": toks, "targets": tgts})
    s["inputs"] = {
        "gpt2_params": _np_tree(s["gpt2_params"]),
        "gpt2_f32_params": _np_tree(s["gpt2_f32_params"]),
        "gpt2_tokens": _tokens(4, 64, 6),
        "llama_params": _np_tree(s["llama_params"]),
        "llama_untied_params": _np_tree(s["llama_untied_params"]),
        "llama_tokens": _tokens(2, 64, 7),
        "gpt2_batches": batches,
    }
    return s


@pytest.fixture(scope="module")
def world(setup):
    return spawn(torch_mesh_ranks.tensor_parallel_cases, 4,
                 (setup["inputs"],), device="cpu", timeout=300)


def _case(world, name):
    results = [r[name] for r in world]
    for r in results:
        assert "error" not in r, r.get("error")
    return results


def _assemble(results, dp, sp):
    """The whole batch's logits from the tp-rank-0 blocks; every tp rank
    of a block must hold the same (gathered) logits."""
    rows = []
    for i in range(dp):
        blocks = []
        for j in range(sp):
            mine = [r["logits"] for r in results
                    if r["dp"] == i and r["sp"] == j]
            for other in mine[1:]:
                np.testing.assert_array_equal(other, mine[0])
            blocks.append(mine[0])
        rows.append(np.concatenate(blocks, axis=1))
    return np.concatenate(rows, axis=0)


def _jax_logits(model_cls, config, params, tokens, axes):
    mesh = make_mesh(axes)
    model = model_cls(config, mesh=mesh)
    tokens = jax_shard_batch({"t": tokens}, mesh, seq_sharded=True)["t"]
    fn = jax.jit(lambda p, t: model.apply({"params": p}, t))
    return np.asarray(fn(place_params(params, mesh), tokens))


LOGIT_CASES = {
    "gpt2_dp2_tp2": ("gpt2", {"dp": 2, "tp": 2}, {}),
    "gpt2_tp4": ("gpt2", {"tp": 4}, {}),
    "gpt2_sp2_tp2_ring": ("gpt2", {"sp": 2, "tp": 2}, {"attn_impl": "ring"}),
    "gpt2_sp2_tp2_ulysses": ("gpt2", {"sp": 2, "tp": 2},
                             {"attn_impl": "ulysses"}),
    "llama_tp4": ("llama", {"tp": 4}, {}),
    "llama_dp2_tp2": ("llama", {"dp": 2, "tp": 2}, {}),
}


@pytest.mark.parametrize("name", sorted(LOGIT_CASES))
def test_logits_match_jax_on_the_same_mesh(world, setup, name):
    model, axes, kw = LOGIT_CASES[name]
    if model == "gpt2":
        cls, cfg, tol = JaxGPT2, JaxGPT2Config.tiny(**kw), LOGIT_TOL
    else:
        cls, cfg, tol = JaxLlama, setup["llama"], LLAMA_TOL
    want = _jax_logits(cls, cfg, setup[f"{model}_params"],
                       setup["inputs"][f"{model}_tokens"], axes)
    got = _assemble(_case(world, name), axes.get("dp", 1), axes.get("sp", 1))
    print(f"{name}: largest |diff| {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _jax_steps(model, loss_fn, params, mesh, batches, seq_sharded):
    opt = optax.adamw(1e-3, weight_decay=0.1, mu_dtype=jnp.bfloat16)
    state = jax_init_train_state(params, opt, mesh)
    step = jax_make_train_step(loss_fn, opt)
    metrics = []
    for batch in batches:
        state, m = step(state, jax_shard_batch(batch, mesh,
                                               seq_sharded=seq_sharded))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _port_layout(model_cls, config, params) -> dict:
    """JAX parameters in the port's names and layouts, through the port
    model's own ``load_jax_params``."""
    model = model_cls(config, device="cpu")
    model.load_jax_params(_np_tree(params))
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


def _block(whole: np.ndarray, split) -> np.ndarray:
    for dim, _, index, size in split:
        n = whole.shape[dim] // size
        whole = np.take(whole, range(index * n, (index + 1) * n), axis=dim)
    return whole


def _check_steps(results, jmetrics, want: dict, split_axes: set) -> None:
    for r in results:
        for got_m, want_m in zip(r["metrics"], jmetrics, strict=True):
            np.testing.assert_allclose(got_m["loss"], want_m["loss"],
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(got_m["grad_norm"],
                                       want_m["grad_norm"], rtol=GNORM_RTOL)
        cut = set()
        for name, w in want.items():
            block, split = r["params"][name]
            cut |= {axis for _, axis, _, _ in split}
            err = float(np.abs(block - _block(w, split)).max())
            assert err < ADAMW_DRIFT, f"{name} drifted {err:.3g}"
        assert cut == split_axes


TRAIN_CASES = {
    "gpt2_dp2_tp2_train": ({"dp": 2, "tp": 2}, "auto"),
    "gpt2_tp4_train": ({"tp": 4}, "auto"),
    "gpt2_sp2_tp2_ring_train": ({"sp": 2, "tp": 2}, "ring"),
    "gpt2_fsdp2_tp2_train": ({"fsdp": 2, "tp": 2}, "auto"),
}


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_gpt2_adamw_steps_match_jax(world, setup, name):
    axes, impl = TRAIN_CASES[name]
    mesh = make_mesh(axes)
    model = JaxGPT2(JaxGPT2Config.tiny(dtype=jnp.float32, attn_impl=impl),
                    mesh=mesh)
    state, jmetrics = _jax_steps(
        model, jax_gpt2_loss_fn(model, ce_chunk=64),
        setup["gpt2_f32_params"], mesh, setup["inputs"]["gpt2_batches"],
        seq_sharded=True)
    want = _port_layout(GPT2, GPT2Config.tiny(dtype=torch.float32),
                        state.params)
    _check_steps(_case(world, name), jmetrics, want, {"tp"})


@pytest.mark.parametrize("axes", [{"tp": 4}, {"dp": 2, "tp": 2}],
                         ids=["tp4", "dp2_tp2"])
def test_llama_untied_adamw_step_matches_jax(world, setup, axes):
    mesh = make_mesh(axes)
    model = JaxLlama(setup["llama_untied"], mesh=mesh)
    state, jmetrics = _jax_steps(
        model, jax_llama_loss_fn(model, ce_chunk=64),
        setup["llama_untied_params"], mesh,
        setup["inputs"]["gpt2_batches"][:1], seq_sharded=False)
    want = _port_layout(Llama, LlamaConfig.tiny(dtype=torch.float32,
                                                tie_embeddings=False),
                        state.params)
    name = "llama_" + "_".join(f"{a}{n}" for a, n in axes.items()) + "_train"
    _check_steps(_case(world, name), jmetrics, want, {"tp"})
