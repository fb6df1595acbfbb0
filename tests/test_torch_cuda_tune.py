"""Card-only tests of Tune on the port: chip_smoke.py phase 18's own (a)
and (b) at a smaller size, read and held by chip_smoke's own
``sweep_readings`` and ``pbt_readings``. GPT-2 124M at full width
(``GPT2Config.small()``, random weights from seed 0, handed to every trial
by ``tune.with_parameters``), each trial at ``GPU: 0.5`` on the one card,
4 steps of the captured step on 32 x 1024 batches:

- (a) ASHA over two lrs, both trials at once: no errors, the two
  overlapped on the card, losses against the same steps in this process
  (CAPTURE_LOSS_RTOL), ASHA's stops reproduced, 12 launches of each
  kernel a step in every trial;
- (b) PBT over TUNE_PBT_LRS: an exploit from the upper quantile, each
  restart's first loss bit-equal to its donor's from the same checkpoint,
  the checkpoint restored here giving that loss and the next weights.

Marked ``cuda``: run on a host with a card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_tune.py

They skip, from inside the fixture, where no GPU is visible.
"""

from __future__ import annotations

import tempfile

import pytest
import torch

import chip_smoke as cs

pytestmark = pytest.mark.cuda

LRS = (1e-4, 1e-3)
STEPS = 4
SHARE = {"CPU": 1, "GPU": cs.TUNE_SHARE}


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with -m cuda on a host with a "
                    "card")
    from ray_tpu_torch.ops.cuda import build
    build.ensure_built()
    cfg = cs.GPT2Config.small()
    weights = cs.numpy_weights(cs.GPT2(cfg, seed=0))
    torch.cuda.empty_cache()
    return {"cfg": cfg, "weights": weights,
            "batches": cs.tune_batches(cfg.vocab_size)}


@pytest.fixture(scope="module")
def runtime(setup):
    import ray_tpu_torch
    ray_tpu_torch.init()
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _held(checks) -> None:
    failed = [(what, reading) for what, ok, reading in checks if not ok]
    assert not failed, failed


def test_asha_sweep_on_half_cards(setup, runtime):
    spec = cs.tune_spec(setup["cfg"], steps=STEPS)
    with tempfile.TemporaryDirectory() as storage:
        run = cs.tune_sweep(setup["weights"], setup["batches"], spec, LRS,
                            SHARE, len(LRS), storage)
    readings, checks = cs.sweep_readings(run, setup["weights"],
                                         setup["batches"], spec)
    _held(checks)
    assert all(readings["bit_equal"].values()), readings["rel"]


def test_pbt_restarts_from_its_donor_on_the_card(setup, runtime):
    with tempfile.TemporaryDirectory() as storage, \
            tempfile.TemporaryDirectory() as gate:
        spec = cs.tune_spec(setup["cfg"], steps=2 * STEPS,
                            ckpt_every=cs.TUNE_PBT_INTERVAL,
                            population=len(cs.TUNE_PBT_LRS), gate=gate)
        run = cs.tune_pbt(setup["weights"], setup["batches"], spec,
                          cs.TUNE_PBT_LRS, SHARE, storage)
        readings, checks = cs.pbt_readings(run, setup["weights"],
                                           setup["batches"], spec)
    _held(checks)
    assert readings["exploits"] >= 1, cs.pbt_said(readings)
