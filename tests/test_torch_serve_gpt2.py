"""GPT-2 behind a deployment on both packages, and what the port's Serve
does with cards.

GPT-2 tiny in float32 (``GPT2Config.tiny``, as ``test_logits_match`` in
tests/test_torch_gpt2.py), the same weights in both, drawn with numpy
from seed 0 into the flax model's parameter tree: the JAX package's
flax GPT-2 behind ``ray_tpu.serve`` and the port's ``models.GPT2``
(``load_jax_params``, ``device="cpu"``) behind ``ray_tpu_torch.serve``,
each through ``@serve.batch`` batches that are right-padded to a
multiple of 64 (``torch_serve_programs.gpt2_server``, on chip_smoke.py's
``pad_batch`` and ``last_logits``).
The same requests (numpy seed 0, lengths 5-40) go through the handle on
both; each response's last valid position's logits must agree within
``LOGIT_TOL`` absolute, the tolerance of ``test_logits_match``: both are
float32 forwards of the same weights and tokens, whose differences are
float32 rounding of reductions in other orders (per row, so a request's
batch does not matter beyond that rounding).

Then the port alone: ``ray_actor_options={"num_gpus": ...}`` reaches the
replica as the ``GPU`` resource (its worker sees the card it holds),
two replicas share one card at 0.5 each, ``num_tpus`` raises, a GPT-2
replica without a card and without ``device="cpu"`` refuses to start
(no CPU fallback), and the node-drain paths raise NotImplementedError
naming ROADMAP item 7.
"""

from __future__ import annotations

import functools
import importlib
import time

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import torch_runtime_programs
import torch_serve_programs as programs

LOGIT_TOL = 1e-5
REQUESTS = 24
LENGTHS = (5, 40)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module, as every test_torch_* file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _no_worker_left():
    yield
    assert torch_runtime_programs.workers_left() == []


@functools.cache
def _weights() -> tuple[dict, dict]:
    """(GPT-2 tiny's flax params, drawn with numpy from seed 0: N(0, 0.02)
    and the norms' scales 1 + N(0, 0.02); the port's parameters loaded
    from them, as numpy)."""
    from ray_tpu.models import GPT2 as JaxGPT2
    from ray_tpu.models import GPT2Config as JaxGPT2Config
    from ray_tpu_torch.models import GPT2, GPT2Config

    shapes = jax.eval_shape(lambda: JaxGPT2(JaxGPT2Config.tiny(
        dtype=jax.numpy.float32)).init_params(jax.random.key(0)))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        x = rng.normal(0.0, 0.02, leaf.shape).astype(np.float32)
        return x + 1 if jax.tree_util.keystr(path).endswith("['scale']") \
            else x
    jparams = jax.tree_util.tree_map_with_path(draw, shapes)
    model = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    model.load_jax_params(jparams)
    return jparams, {n: p.detach().numpy().copy()
                     for n, p in model.named_parameters()}


def _serve_requests(name: str, weights: dict, reqs: list, **kw) -> list:
    """Every request through the handle of a GPT-2 deployment on package
    ``name`` (all in flight at once), in request order."""
    rt = importlib.import_module(name)
    rt.init(num_cpus=4)
    try:
        serve = importlib.import_module(name + ".serve")
        server = programs.gpt2_server(rt)
        handle = serve.run(serve.deployment(server).bind(
            rt.put(weights), **kw), name="gpt2")
        out = [r.result(timeout_s=120)
               for r in [handle.remote(q) for q in reqs]]
        serve.shutdown()
        return out
    finally:
        rt.shutdown()


@pytest.fixture(scope="module")
def served() -> dict:
    jparams, state = _weights()
    reqs = chip_smoke.serve_requests(REQUESTS, 256, lengths=LENGTHS)
    return {"requests": reqs,
            "ray_tpu": _serve_requests("ray_tpu", jparams, reqs),
            "ray_tpu_torch": _serve_requests("ray_tpu_torch", state, reqs,
                                             device="cpu")}


def test_gpt2_deployment_logits_match_across_packages(served):
    worst = 0.0
    for jax_out, port_out in zip(served["ray_tpu"], served["ray_tpu_torch"]):
        assert jax_out["id"] == port_out["id"]
        assert port_out["logits"].dtype == np.float32
        assert port_out["logits"].shape == (256,)
        worst = max(worst, float(np.abs(port_out["logits"]
                                        - jax_out["logits"]).max()))
    print(f"GPT-2 tiny deployment, worst |port - JAX| logit: {worst:.3g}")
    assert worst < LOGIT_TOL


@pytest.mark.parametrize("name", ["ray_tpu", "ray_tpu_torch"])
def test_gpt2_deployment_batches_and_pads_right(served, name):
    """Every request answered once in its own order, its batch padded to
    64, some batch of more than one request, each top-1 the argmax of
    its logits."""
    outs = served[name]
    assert [o["id"] for o in outs] == list(range(REQUESTS))
    for o in outs:
        assert o["id"] in o["batch"]["ids"] and o["batch"]["T"] == 64
        assert o["top1"] == int(np.argmax(o["logits"]))
    assert max(len(o["batch"]["ids"]) for o in outs) > 1


def test_gpt2_deployment_answers_as_its_batch_recomputed(served):
    """The port's every response equals its batch (the signature's
    requests, padded to its T) recomputed in this process, bit for bit,
    and the plain attention ran once a layer for each batch."""
    from ray_tpu_torch.models import GPT2, GPT2Config
    _, state = _weights()
    model = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict({n: torch.from_numpy(v) for n, v in state.items()})
    reqs = {q["id"]: q["tokens"] for q in served["requests"]}
    for o in served["ray_tpu_torch"]:
        tokens, last = chip_smoke.pad_batch([reqs[i]
                                             for i in o["batch"]["ids"]])
        assert tokens.shape[1] == o["batch"]["T"]
        with torch.inference_mode():
            want = chip_smoke.last_logits(model, torch.from_numpy(tokens),
                                          torch.from_numpy(last)).numpy()
        row = o["batch"]["ids"].index(o["id"])
        np.testing.assert_array_equal(o["logits"], want[row])


def test_left_padding_changes_the_answers(served):
    """The wrong padding the card run plants (``serve_left_pad``): left
    padding moves the positions and lets attention see the padding, so
    a short request in a batch with a long one comes out far off."""
    from ray_tpu_torch.models import GPT2, GPT2Config
    _, state = _weights()
    model = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict({n: torch.from_numpy(v) for n, v in state.items()})
    seqs = [q["tokens"] for q in served["requests"][:8]]
    with torch.inference_mode():
        right = chip_smoke.last_logits(model, *map(
            torch.from_numpy, chip_smoke.pad_batch(seqs)))
        left = chip_smoke.last_logits(model, *map(
            torch.from_numpy, chip_smoke.pad_batch(seqs, True)))
    assert float((right - left).abs().max()) > 1e3 * LOGIT_TOL


@pytest.fixture(scope="module")
def port():
    """The port's runtime with one card as a label (none is used)."""
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.mark.parametrize("share", [1, 0.5])
def test_num_gpus_reaches_the_replica_as_gpu(port, share):
    """``num_gpus`` is the replicas' ``GPU`` resource: 1 / share replicas
    hold the one card between them, and each replica's worker sees it."""
    serve = port.serve
    n = int(1 / share)
    handle = serve.run(serve.deployment(programs.CardView).options(
        name="cards", num_replicas=n,
        ray_actor_options={"num_gpus": share}).bind())
    try:
        assert port.available_resources().get("GPU", 0.0) == 0.0
        seen = [handle.remote(i).result(timeout_s=60) for i in range(8 * n)]
        assert {(s["cuda"], tuple(s["gpu_ids"])) for s in seen} == \
            {("0", (0,))}
        assert len({s["pid"] for s in seen}) == n
    finally:
        serve.shutdown()
    deadline = time.monotonic() + 30
    while port.available_resources().get("GPU", 0.0) != 1.0 \
            and time.monotonic() < deadline:
        time.sleep(0.1)
    assert port.available_resources().get("GPU", 0.0) == 1.0


def test_num_tpus_raises_naming_num_gpus(port):
    serve = port.serve
    with pytest.raises(ValueError, match="num_gpus"):
        serve.run(serve.deployment(programs.CardView).options(
            name="tpus", ray_actor_options={"num_tpus": 1}).bind())
    serve.shutdown()


def test_gpt2_replica_without_a_card_refuses_to_start(port):
    """No CPU fallback: a GPT-2 replica given no device runs on the card,
    and without one its constructor raises."""
    from ray_tpu_torch.serve.replica import Replica
    _, state = _weights()
    server = programs.gpt2_server(port)
    r = Replica.options(num_cpus=0).remote(server, (port.put(state),), {},
                                           "gpt2#nocard")
    with pytest.raises(Exception, match="no CUDA device"):
        port.get(r.handle_request.remote("__call__", ({"id": 0,
                                                       "tokens": [1]},), {}),
                 timeout=120)
    port.kill(r)


def test_node_drain_is_multi_node(port):
    """The JAX package's node-drain serve cases (a ``Cluster`` and
    ``drain_node``) raise on the port, naming ROADMAP item 7, as
    ``init(address=...)`` does."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.api import get_runtime
    with pytest.raises(NotImplementedError, match="item 7"):
        Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    with pytest.raises(NotImplementedError, match="item 7"):
        get_runtime().drain_node(get_runtime().head_node_id,
                                 reason="drain", deadline_s=30, remove=True)
    with pytest.raises(NotImplementedError, match="item 7"):
        port.init(address="auto")
