"""GPT-2 as a two-stage compiled DAG of the port on the CPU, against the
JAX GPT-2 and against the port's whole model in process.

``chip_smoke.GPT2Stage`` (phase 21 (a)'s stage actor, user code) at
``GPT2Config.tiny`` width (2 blocks, width 64, vocabulary 256): stage 0
holds the embeddings and block 0, stage 1 block 1, ``ln_f`` and the
head, each an actor of the port's runtime given the same numpy weights
(the JAX GPT-2's flax params through ``GPT2.load_jax_params``). Every
output, each sequence's summed next-token log-probability and the last
position's logits (``chip_smoke.head_reduction``), is held:

- in float32, against the JAX GPT-2's forward on the same weights and
  tokens at the port's float32 forward tolerance (tests/test_torch_gpt2.py):
  logits within 1e-5 absolute, so each log-probability within 2e-5 (a
  log-softmax moves by at most twice its largest logit's change) and each
  sum over T - 1 positions within 2e-5 (T - 1);
- in bfloat16 (the card's compute type), against the port's whole model
  in this process, bit for bit: the stages run the same arithmetic on the
  same bits, and the edge carries the residual stream's bits;
- with the planted ``dag_stage_skips_block`` (stage 1 starts one block
  late), unequal to the whole model, as phase 21 (a)'s check reads it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from ray_tpu.models import GPT2 as JaxGPT2  # noqa: E402
from ray_tpu.models import GPT2Config as JaxGPT2Config  # noqa: E402
from ray_tpu_torch.models import GPT2, GPT2Config  # noqa: E402

B, T = 2, 64
LOGIT_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module, as every test_torch_* file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rt():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    import torch_runtime_programs
    assert torch_runtime_programs.workers_left() == []


def _weights(dtype):
    """The JAX GPT-2's params in the port's model, as ``numpy_weights``
    gives them; the JAX model; its params."""
    jmodel = JaxGPT2(JaxGPT2Config.tiny(dtype=jnp.float32))
    jparams = jmodel.init_params(jax.random.key(0))
    model = GPT2(GPT2Config.tiny(dtype=dtype), device="cpu")
    model.load_jax_params(jax.tree_util.tree_map(np.asarray, jparams))
    return chip_smoke.numpy_weights(model), model, jmodel, jparams


def _batches(n: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(0).integers(
        0, vocab, (n, B, T)).astype(np.int32)


def _run(rt, weights, cfg, bounds, batches) -> list[dict]:
    cdag = chip_smoke.gpt2_dag(rt, rt.put(weights), cfg, bounds,
                               [{"num_cpus": 1}] * len(bounds), device="cpu")
    try:
        assert cdag._mode == "channels"
        outs, _ = chip_smoke.run_dag(cdag, batches, in_flight=2)
    finally:
        cdag.teardown()
    return outs


def test_float32_stages_match_the_jax_gpt2(rt):
    cfg = GPT2Config.tiny(dtype=torch.float32)
    weights, _, jmodel, jparams = _weights(torch.float32)
    batches = _batches(3, cfg.vocab_size)
    outs = _run(rt, weights, cfg, chip_smoke.dag_bounds(cfg.n_layer, 2),
                batches)
    for out, tokens in zip(outs, batches, strict=True):
        logits = jmodel.apply({"params": jparams}, tokens)
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        lp = np.asarray(jnp.take_along_axis(
            logp, tokens[:, 1:, None], axis=-1)[..., 0].sum(-1))
        np.testing.assert_allclose(out["last"], np.asarray(logits[:, -1]),
                                   atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_allclose(out["lp"], lp, rtol=0,
                                   atol=2 * LOGIT_ATOL * (T - 1))


def test_bf16_stages_equal_the_whole_model_bit_for_bit(rt):
    cfg = GPT2Config.tiny()
    assert cfg.dtype == torch.bfloat16
    weights, model, _, _ = _weights(cfg.dtype)
    batches = _batches(4, cfg.vocab_size)
    outs = _run(rt, weights, cfg, chip_smoke.dag_bounds(cfg.n_layer, 2),
                batches)
    for out, tokens in zip(outs, batches, strict=True):
        ref = chip_smoke.gpt2_reduction(model, tokens)
        assert np.array_equal(out["lp"], ref["lp"])
        assert np.array_equal(out["last"], ref["last"])
        assert chip_smoke.reduction_rel(out, ref) == 0.0
    s0, s1 = outs[0]["stages"]
    assert [s0["blocks"], s1["blocks"]] == [[0, 1], [1, 2]]
    assert s1["got"] == ["Tensor", "cpu", "torch.bfloat16"]
    assert s1["got_sha"] == s0["sent_sha"] is not None
    assert s0["pid"] != s1["pid"]


def test_planted_stage_fault_fails_the_comparison(rt):
    cfg = GPT2Config.tiny()
    weights, model, _, _ = _weights(cfg.dtype)
    bounds = chip_smoke.dag_bounds(cfg.n_layer, 2, "dag_stage_skips_block")
    assert bounds == [(0, 1), (2, 2)]
    batches = _batches(2, cfg.vocab_size)
    outs = _run(rt, weights, cfg, bounds, batches)
    rel = [chip_smoke.reduction_rel(o, chip_smoke.gpt2_reduction(model, b))
           for o, b in zip(outs, batches, strict=True)]
    assert min(rel) > 1e3 * chip_smoke.DAG_RTOL, rel
