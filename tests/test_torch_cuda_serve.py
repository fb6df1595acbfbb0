"""Card-only tests of Serve on the port: chip_smoke.py phase 17's
deployment and checks at a smaller load. ``chip_smoke.GPT2Server`` serves
GPT-2 124M at full width (``GPT2Config.small()``, bf16, random weights
from seed 0 passed by object ref) from ``num_gpus`` replicas that each
build it on their own card, through ``@serve.batch`` batches right-padded
to a multiple of 64. Phase 17's (b), (c) and (e), one test each, on 64
requests (numpy seed 0, lengths 64-1024) from 8 callers, read and held by
chip_smoke's own ``serve_readings``, ``check_serve`` and
``check_replica``. Marked ``cuda``: run on a host with a card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_serve.py

They skip, from inside the fixture, where no GPU is visible.
"""

from __future__ import annotations

import pytest
import torch

import chip_smoke as cs

pytestmark = pytest.mark.cuda

REQUESTS, CALLERS = 64, 8


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with -m cuda on a host with a "
                    "card")
    from ray_tpu_torch.ops.cuda import build
    build.ensure_built()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def setup(card):
    cfg = cs.GPT2Config.small()
    model = cs.GPT2(cfg, seed=0)
    reqs = cs.serve_requests(REQUESTS, cfg.vocab_size)
    return {"weights": cs.numpy_weights(model), "requests": reqs,
            "ref": cs.Reference(model, reqs)}


@pytest.fixture(scope="module")
def runtime(setup):
    import ray_tpu_torch
    ray_tpu_torch.init()
    yield ray_tpu_torch
    ray_tpu_torch.serve.shutdown()
    ray_tpu_torch.shutdown()


def _deploy(rt, setup, name: str, replicas: int, share: float) -> dict:
    """The requests through a deployment of ``replicas`` replicas at
    ``num_gpus=share``: their responses, (b)'s readings over them and
    every replica's stats after them."""
    serve = rt.serve
    app = serve.deployment(cs.GPT2Server).options(
        name=name, num_replicas=replicas,
        ray_actor_options={"num_gpus": share}).bind(rt.put(setup["weights"]))
    handle = serve.run(app, name=name)
    leg = cs.drive(cs.handle_call(handle), setup["requests"], CALLERS)
    readings = cs.serve_readings([leg["responses"]], setup["ref"])
    print(f"{name}: {cs.describe_readings(readings)}")
    stats = cs.replica_stats(rt, name)
    serve.delete(name)
    return {"responses": leg["responses"], "readings": readings,
            "stats": stats}


@pytest.fixture(scope="module")
def one(runtime, setup):
    return _deploy(runtime, setup, "gpt2", 1, 1)


@pytest.fixture(scope="module")
def half(runtime, setup, one):
    return _deploy(runtime, setup, "gpt2half", 2, 0.5)


def test_served_logits_equal_their_batch_recomputed(one):
    """(b) on one replica holding the card: every response bit-equal to
    its batch recomputed in process, within SERVE_ALONE_TOL of its request
    alone, 12 flash_fwd launches a batch."""
    assert [o["id"] for o in one["responses"]] == list(range(REQUESTS))
    assert max(len(o["batch"]["ids"]) for o in one["responses"]) > 1
    cs.check_serve(one["readings"], "one replica")


def test_replica_runs_the_flash_forward_once_a_layer(one):
    """(c): in the replica, on its own card, the flash op and no SDPA in
    the forward, 12 flash_fwd launches a batch served and no backward
    launch."""
    (stats,) = one["stats"]
    cs.check_replica(stats, "0", len(one["readings"]["launches"]),
                     "the replica")


def test_two_half_card_replicas_serve_and_agree(half):
    """(e): two replicas at num_gpus=0.5 share the card; both serve and
    both pass (b) and (c)."""
    r = half["readings"]
    served = {s["pid"]: cs.batches_of(r, s["pid"]) for s in half["stats"]}
    assert len(served) == 2 and min(served.values()) >= 1, served
    cs.check_serve(r, "the half-card replicas")
    for st in half["stats"]:
        cs.check_replica(st, "0", served[st["pid"]], "a half-card replica")
