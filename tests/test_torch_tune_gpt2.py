"""GPT-2 under the port's Tune on the CPU: chip_smoke.py phase 18's own
trial, legs and checks (``gpt2_trial``, ``tune_sweep``, ``tune_pbt``,
``tune_trainer`` and their ``*_readings``), at GPT-2 tiny width
(``GPT2Config.tiny``, float32) from weights carried across from the JAX
model, with the trials on the CPU (``resources_per_trial={"CPU": 1}``).

- (a) ASHA over three lrs, two trials at a time: no errors; each trial's
  losses against the same steps in this process (1e-6 relative; CPU
  float32, bit-equal expected); ASHA's stops reproduced by a fresh
  scheduler fed the recorded results. Whether two trials overlapped is a
  card check (on the CPU their starts are not held together).
- (b) PBT over two lrs: an exploit, from the upper quantile; each
  restart's first loss bit-equal to its donor's from the same
  checkpoint, and the checkpoint restored here gives that loss and,
  one step later at the new lr, the trial's weights.
- The planted fault ``pbt_own_restore`` (an exploited trial restores its
  own latest checkpoint) fails (b)'s restore check.
- (c) ``Tuner(TorchTrainer(...))``: one gloo worker's losses against the
  same steps here.
- Step 0 against the JAX ``gpt2_loss_fn`` on the same weights and batch
  (1e-6 relative, the float32 limit of tests/test_torch_gpt2.py).
"""

from __future__ import annotations

import tempfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
import torch_runtime_programs  # noqa: E402
from ray_tpu.models import GPT2 as JaxGPT2  # noqa: E402
from ray_tpu.models import GPT2Config as JaxGPT2Config  # noqa: E402
from ray_tpu.models.gpt2 import gpt2_loss_fn as jax_gpt2_loss_fn  # noqa: E402

SWEEP_LRS = (1e-3, 3e-3, 1e-2)
PBT_LRS = (1e-5, 1e-2)
STEPS = 4
CPU = {"CPU": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module, as every test_torch_* file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jmodel = JaxGPT2(JaxGPT2Config.tiny(dtype=jnp.float32))
    jparams = jmodel.init_params(jax.random.key(0))
    cfg = cs.GPT2Config.tiny(dtype=torch.float32)
    model = cs.GPT2(cfg, device="cpu")
    model.load_jax_params(jax.tree_util.tree_map(np.asarray, jparams))
    batches = cs.tune_batches(cfg.vocab_size, n=cs.TUNE_BATCHES, b=4, t=32)
    return {"jmodel": jmodel, "jparams": jparams, "cfg": cfg,
            "weights": cs.numpy_weights(model), "batches": batches}


@pytest.fixture(scope="module")
def rt():
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    assert torch_runtime_programs.workers_left() == []


def _spec(setup, **kw):
    return cs.tune_spec(setup["cfg"], device="cpu", **kw)


def _held(checks, skip: str = "") -> None:
    failed = [(what, reading) for what, ok, reading in checks
              if not ok and not (skip and skip in what)]
    assert not failed, failed


@pytest.fixture(scope="module")
def sweep(rt, setup):
    spec = _spec(setup, steps=STEPS, ckpt_last=True)
    with tempfile.TemporaryDirectory() as storage:
        run = cs.tune_sweep(setup["weights"], setup["batches"], spec,
                            SWEEP_LRS, CPU, 2, storage)
        return run, spec


def _pbt(rt, setup, fault=None):
    with tempfile.TemporaryDirectory() as storage, \
            tempfile.TemporaryDirectory() as gate:
        spec = _spec(setup, ckpt_every=cs.TUNE_PBT_INTERVAL,
                     population=len(PBT_LRS), gate=gate, fault=fault)
        run = cs.tune_pbt(setup["weights"], setup["batches"], spec, PBT_LRS,
                          CPU, storage)
        return cs.pbt_readings(run, setup["weights"], setup["batches"], spec)


def test_asha_sweep_against_the_steps_here(sweep, setup):
    run, spec = sweep
    readings, checks = cs.sweep_readings(run, setup["weights"],
                                         setup["batches"], spec)
    _held(checks, skip="overlapped")
    assert len(readings["trials"]) == len(SWEEP_LRS)
    assert all(readings["bit_equal"].values()), readings["rel"]


def test_step0_against_the_jax_loss(sweep, setup):
    run, _ = sweep
    tokens, targets = setup["batches"][0]
    want = float(jax_gpt2_loss_fn(setup["jmodel"])(
        setup["jparams"], {"tokens": tokens, "targets": targets}))
    firsts = [r.metrics_history[0]["loss"] for r in run["grid"]]
    assert len(set(firsts)) == 1            # every lr starts from step 0
    np.testing.assert_allclose(firsts[0], want, rtol=1e-6)


def test_pbt_restart_restores_its_donor(rt, setup):
    readings, checks = _pbt(rt, setup)
    _held(checks)
    assert readings["exploits"] >= 1
    assert any(r["stepped"] for r in readings["restarts"])


def test_planted_own_restore_fails_the_restore_check(rt, setup):
    readings, checks = _pbt(rt, setup, fault="pbt_own_restore")
    verdict = {what: ok for what, ok, _ in checks}
    restore = [ok for what, ok in verdict.items() if "first loss" in what]
    exploit = [ok for what, ok in verdict.items() if "exploit" in what]
    assert exploit == [True], readings
    assert restore == [False], readings["restarts"]
    assert any(r["stepped"] and not r["from_donor"]
               for r in readings["restarts"]), readings["restarts"]


def test_tuner_over_a_trainer(rt, setup):
    spec = _spec(setup, steps=STEPS)
    with tempfile.TemporaryDirectory() as storage:
        run = cs.tune_trainer(rt.put(setup["weights"]), setup["batches"],
                              spec, storage)
    ref = cs.reference_losses(setup["weights"], setup["batches"], spec,
                              cs.TUNE_TRAINER_LR, STEPS)
    readings, checks = cs.trainer_readings(run, ref, spec)
    _held(checks)
    assert readings["bit_equal"], (readings["losses"], ref)
