"""The multi-card rank programs (``ray_tpu_torch.parallel.multicard``) on
four gloo ranks on the CPU, at the tiny configs, where the routes run on
the kernels' plain versions.

One world runs every case; each rank holds each mesh route against the
mesh-less step on its own process, as it does on the cards. Here the
checks of the language models, the pipeline and the checkpoint must hold
(the step-0 loss and gradient norm within the gloo tests' limits; the
restored parameters bit-equal). The vision case (ViT and ResNet on dp x
tp 2, ViT on sp 4) must run; its limits assume 128 images, and the
float32 parity of those routes is ``tests/test_torch_vision_tp.py``'s and
``tests/test_torch_vit_sp.py``'s. A second world runs case (c) with
the planted ring fault (dk, dv one rotation short of home), which the
layer-gradient and step-0 checks must fail.
"""

from __future__ import annotations

import pytest
import torch

from ray_tpu_torch.parallel import multicard


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def results():
    return multicard.run(4, "tiny", device="cpu", timeout=300)


def _checks(results, case):
    return [(what, ok, reading) for what, ok, reading
            in multicard.checks(results, captured=False)
            if what.startswith(f"({case})")]


@pytest.mark.parametrize("case", ["a", "b", "c", "d", "e", "f", "h"])
def test_case_holds_against_the_mesh_less_step(results, case):
    mine = _checks(results, case)
    assert mine, f"case {case} made no check"
    failed = [f"{what}: {reading}" for what, ok, reading in mine if not ok]
    assert not failed, "\n".join(failed)


def test_vision_case_runs_on_every_rank(results):
    runs = [run for r in results for run in r["g"].values()]
    assert len(runs) == 12 and all("losses" in run for run in runs)


def test_report_names_every_rank_and_case(results):
    lines = multicard.report(results, 4)
    assert sum(line.startswith("rank ") for line in lines) == 4
    assert any(line.startswith("(f) pipeline pp 4") for line in lines)


def test_planted_ring_fault_fails_the_checks():
    faulty = multicard.run(4, "tiny", cases=("c",), fault="ring_dkv_home",
                           device="cpu", timeout=300)
    failed = {what.split(":")[1].strip() for what, ok, _
              in _checks(faulty, "c") if not ok}
    assert "step-0 gradients of every layer within 0.035" in failed
