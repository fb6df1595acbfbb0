"""The port's host collective plane (``ray_tpu_torch.collective``: the
rendezvous store actor, the rank-to-rank TCP ``PeerMesh`` and its ring
algorithms) against the JAX package's (``ray_tpu.collective``).

Four member actors (tests/torch_rllib_programs.py ``Member``) join one
group in a runtime of each package and run every collective once on
numpy inputs and once on CPU torch tensors: ``allreduce`` (sum, max,
min, and the mean as the sum over the world size, as ``LearnerGroup``
takes it; ``op="mean"`` is refused alike), ``allgather``,
``reducescatter``, ``broadcast``, ``barrier``, ``send``/``recv``. The
results must be equal on both packages and equal to what the ops must
give. The JAX package's ``test_100mb_allreduce_on_daemon_ranks`` needs
node daemons (multi-node, ROADMAP.md §1 item 7), which the port does not
have, and is not mirrored.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

import torch_rllib_programs as programs
import torch_runtime_programs

PACKAGES = ("ray_tpu", "ray_tpu_torch")


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


@pytest.fixture(scope="module")
def outcomes() -> dict:
    """{package: outcome of programs.collective_ops}."""
    import importlib
    out = {}
    for name in PACKAGES:
        rt = importlib.import_module(name)
        rt.init(num_cpus=5)
        try:
            out[name] = programs.run(programs.collective_ops, rt)
        finally:
            rt.shutdown()
    return out


@pytest.mark.parametrize("inputs", ["numpy", "torch"])
def test_collectives_give_the_same_results_on_both_packages(outcomes,
                                                            inputs):
    i = ("numpy", "torch").index(inputs)
    jax_out, port_out = (outcomes[name] for name in PACKAGES)
    assert jax_out[0] == "ok", jax_out
    assert port_out[0] == "ok", port_out
    assert port_out[1][i] == jax_out[1][i]


@pytest.mark.parametrize("inputs", ["numpy", "torch"])
def test_collectives_give_the_expected_results(outcomes, inputs):
    i = ("numpy", "torch").index(inputs)
    assert outcomes["ray_tpu_torch"][1][i] == programs.expected_collective()[i]


def test_a_torch_tensor_is_read_to_the_host_once():
    """The port takes a tensor as it is (no ``np.asarray`` of it, which
    would fail on a card's tensor) through ``.detach().cpu()``, and
    returns numpy; a tensor that needs grad is taken too."""
    from ray_tpu_torch.collective.host import _host
    t = torch.arange(4.0, requires_grad=True)
    out = _host(t)
    assert isinstance(out, np.ndarray) and out.tolist() == [0, 1, 2, 3]
    assert _host([1.0, 2.0]).tolist() == [1.0, 2.0]


def test_store_actor_prefix_names_the_package():
    from ray_tpu.collective import host as jax_host
    from ray_tpu_torch.collective import host
    assert host._GROUP_PREFIX == "ray_tpu_torch_collective:"
    assert host._GROUP_PREFIX != jax_host._GROUP_PREFIX


def test_peer_mesh_close_protocol_clean():
    """close() is a handshake: _BYE to peers, socket shutdown, reader
    threads joined — no reader dies on an exception from a half-closed
    Connection (as tests/test_collective_ring.py holds the JAX mesh)."""
    from ray_tpu_torch.collective.mesh import PeerMesh

    errors = []
    old_hook = threading.excepthook
    threading.excepthook = lambda args: errors.append(args)
    try:
        m0 = PeerMesh(0, 2, b"tok-close")
        m1 = PeerMesh(1, 2, b"tok-close")
        addrs = {0: m0.addr, 1: m1.addr}
        m0.set_addresses(addrs)
        m1.set_addresses(addrs)
        m0.send(1, ("t", 0), np.arange(4.0))
        out = m1.recv(0, ("t", 0), timeout=10)
        assert (out == np.arange(4.0)).all()
        threads = list(m0._threads) + list(m1._threads)
        m0.close()
        m1.close()
        deadline = time.time() + 5.0
        for t in threads:
            t.join(timeout=max(deadline - time.time(), 0.1))
            assert not t.is_alive(), f"mesh thread leaked: {t.name}"
    finally:
        threading.excepthook = old_hook
    assert not errors, [str(a.exc_value) for a in errors]


def test_util_collective_resolves_to_the_port():
    import ray_tpu_torch.collective as coll
    import ray_tpu_torch.util as util
    assert util.collective is coll
    assert coll.device.__name__ == "ray_tpu_torch.collective.device"
    for name in ("queue", "multiprocessing", "chaos"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            getattr(util, name)


def test_communicator_keeps_the_jax_package_names():
    from ray_tpu_torch.collective.communicator import (
        DcnTcpCommunicator,
        TpuCommunicator,
    )
    comm = DcnTcpCommunicator("g", 0, 2)
    assert isinstance(comm, TpuCommunicator)
    assert (comm.rank, comm.world_size, comm.joined()) == (0, 2, False)
    import pickle
    again = pickle.loads(pickle.dumps(comm))
    assert (again.rank, again.world_size) == (0, 2)
