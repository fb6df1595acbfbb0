"""Card-only tests of the mesh routes across four NCCL ranks, one card
each: ``ray_tpu_torch.parallel.multicard`` at full width, each route held
against the one-card mesh-less captured step within the module's limits;
then the multi-rank dry run with no device named. CASES is the subset
whose collectives run inside a captured step or cross cards point to
point (the bucket all-reduce, the ring's P2P, MoE's all_to_all, the
pipeline's P2P, a checkpoint across meshes), ~2 minutes;
``chip_smoke.py --cards 4`` (phase 16) runs every case. Marked ``cuda``:
run on a host with four cards with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_multicard.py

They skip, from inside the test, where fewer than four cards are
visible.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

N = 4
CASES = ("a", "c", "e", "f", "h")


@pytest.fixture(scope="module")
def cards() -> int:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < N:
        pytest.skip(f"needs {N} NVIDIA GPUs ({n} visible): run with -m "
                    "cuda on a host with four cards")
    return n


@pytest.fixture(scope="module")
def results(cards):
    from ray_tpu_torch.parallel import multicard
    res = multicard.run(N, "full", cases=CASES, timeout=600)
    for line in multicard.report(res, N):
        print(line)
    return res


def test_each_rank_holds_a_card_of_its_own(results):
    cards = [r["card"] for r in results]
    assert [c["device"] for c in cards] == [f"cuda:{i}" for i in range(N)]
    assert len({c["uuid"] for c in cards}) == N


@pytest.mark.parametrize("case", CASES)
def test_mesh_route_matches_the_one_card_step(results, case):
    from ray_tpu_torch.parallel import multicard
    mine = [(what, ok, reading) for what, ok, reading
            in multicard.checks(results) if what.startswith(f"({case})")]
    assert mine, f"case {case} made no check"
    failed = [f"{what}: {reading}" for what, ok, reading in mine if not ok]
    assert not failed, "\n".join(failed)


def test_captured_routes_capture_once(results):
    """Every route but FSDP2 ran as one CUDA graph."""
    from ray_tpu_torch.parallel.multicard import _runs
    for case in ("a", "c", "e"):
        for _, name, run in _runs(results, case):
            assert run["compile_count"] == 1 and run["donated"], name


def test_dryrun_multichip_on_four_cards(cards):
    from ray_tpu_torch.parallel.dryrun import dryrun_multichip
    ranks = dryrun_multichip(N)
    assert [r["device"] for r in ranks] == [f"cuda:{i}" for i in range(N)]
    assert len({r["loss"] for r in ranks}) == 1
    assert np.isfinite(ranks[0]["loss"])
