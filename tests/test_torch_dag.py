"""The port's DAGs, compiled DAGs and shared-memory channels against the
JAX package's.

The ``TABLE`` of tests/torch_dag_programs.py runs once on ``ray_tpu`` and
once on ``ray_tpu_torch``, one runtime of ``num_cpus=4`` per package; its
``ALONE`` program (a compiled DAG across two node daemons, whose edges
ride ``CommChannel``) starts a ``cluster_utils.Cluster`` of its own.
Outcomes must be equal to each other and to ``EXPECTED``, exactly. The
programs: function DAGs (a diamond sharing its upstream, a
``MultiOutputNode``, an ``InputAttributeNode``), actor nodes, compiled
DAGs in channel mode (reusing their actors, pipelining, a cross-actor
diamond, an actor that feeds and consumes, an error that propagates,
an oversized result, ``get`` timeouts and double ``get``, teardown), the
task-mode fallbacks, numpy and torch payloads compared by their bits,
and the raw channel in one process and across two.

Below the table, the port alone: both packages' native channel libraries
in one process, neither attaching the other's segments.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_cluster_programs
import torch_dag_programs as programs

PACKAGES = ("ray_tpu", "ray_tpu_torch")
PROGRAMS = list(programs.TABLE) + list(programs.ALONE)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module, as every test_torch_* file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _no_process_left():
    """Torn down after the module's runtimes and clusters: none leaves a
    worker, node daemon or head process behind."""
    yield
    assert torch_cluster_programs.processes_left() == []


@pytest.fixture(scope="module")
def table() -> dict:
    """{package: {program: outcome}}, the JAX package's run first."""
    return {name: {**programs.run_table(name, programs.TABLE),
                   **programs.run_alone(name, programs.ALONE)}
            for name in PACKAGES}


@pytest.mark.parametrize("program", PROGRAMS)
def test_program_gives_the_same_result_on_both_packages(table, program):
    jax_out, port_out = (table[name][program] for name in PACKAGES)
    assert jax_out[0] == "ok", jax_out
    assert port_out == jax_out


@pytest.mark.parametrize("program", PROGRAMS)
def test_program_outcome_is_the_expected_one(table, program):
    assert table["ray_tpu_torch"][program] == \
        ("ok", programs.EXPECTED[program])


def test_both_packages_channels_in_one_process():
    """Each library carries its own values; a port channel's name starts
    with ``/rttch-`` and the JAX package's with ``/rtch-``; neither
    library attaches the other's segment (its magic differs)."""
    import ray_tpu.native.channel as jax_chan
    import ray_tpu_torch.native.channel as port_chan
    made = [mod.Channel(1 << 16) for mod in (jax_chan, port_chan)]
    try:
        assert made[0].name.startswith("/rtch-")
        assert made[1].name.startswith("/rttch-")
        for i, ch in enumerate(made):
            ch.register_reader()
            ch.write(np.arange(4) + i)
        for i, ch in enumerate(made):
            np.testing.assert_array_equal(ch.read(timeout=5),
                                          np.arange(4) + i)
        with pytest.raises(OSError, match="could not open channel"):
            port_chan.Channel(0, made[0].name)
        with pytest.raises(OSError, match="could not open channel"):
            jax_chan.Channel(0, made[1].name)
        # Each library's own reattach still works.
        again = port_chan.Channel(0, made[1].name)
        assert again.reader_count() == 1
        again.detach()
    finally:
        for ch in made:
            ch.close()
            ch.detach()


def test_channel_tensor_read_is_a_copy_and_numpy_view_is_read_only():
    """``begin_read(copy=False)`` of a torch tensor rebuilds it from a
    copy of the slot's bits: the next write leaves the tensor as it was.
    A numpy array read the same way views the slot read-only."""
    from ray_tpu_torch.experimental.channel import Channel
    ch = Channel(1 << 16)
    try:
        ch.register_reader()
        sent = torch.arange(64, dtype=torch.float32).to(torch.bfloat16)
        ch.write(sent)
        got, is_err = ch.begin_read(timeout=5, copy=False)
        ch.end_read()
        ch.write(sent + 1)
        assert not is_err and got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), sent.view(torch.int16))
        # Its own memory: writing it leaves the next version as sent.
        got.add_(1)
        assert torch.equal(ch.read(timeout=5).view(torch.int16),
                           (sent + 1).view(torch.int16))
        ch.write(np.ones(8))
        view, _ = ch.begin_read(timeout=5, copy=False)
        with pytest.raises(ValueError, match="read-only"):
            view[0] = 2.0
        ch.end_read()
    finally:
        ch.close()
        ch.detach()


def test_communicator_carries_a_tensor_as_host_bits():
    """``CommChannel``'s transport, the host communicator between two
    processes, ships a torch tensor through the port's serializer: it
    arrives a CPU tensor of the same dtype, shape and bits. (Pickled by
    ``Connection.send``, torch's multiprocessing reducer would hand the
    peer a shared-memory handle it cannot open.)"""
    import ray_tpu_torch as rt

    class Peer:
        def __init__(self, rank: int, group: str):
            from ray_tpu_torch.collective.communicator import (
                DcnTcpCommunicator,
            )
            self.comm = DcnTcpCommunicator(group, rank, 2).ensure()

        def send(self, seed: int):
            import torch
            t = torch.randn(64, 48, generator=torch.Generator()
                            .manual_seed(seed)).to(torch.bfloat16)
            self.comm.send({"t": t}, 1, "edge")
            return True

        def recv(self):
            import torch
            got = self.comm.recv(0, "edge", timeout=60)["t"]
            return [type(got).__name__, got.device.type, str(got.dtype),
                    list(got.shape), got.view(torch.int16).numpy().tobytes()]

        def stop(self):
            self.comm.close()
            return True

    rt.init(num_cpus=4)
    try:
        peer = rt.remote(num_cpus=1)(Peer)
        a, b = peer.remote(0, "tensor_edge"), peer.remote(1, "tensor_edge")
        got = b.recv.remote()
        assert rt.get(a.send.remote(3), timeout=60)
        kind, dev, dtype, shape, bits = rt.get(got, timeout=60)
        sent = torch.randn(64, 48, generator=torch.Generator()
                           .manual_seed(3)).to(torch.bfloat16)
        assert [kind, dev, dtype, shape] == \
            ["Tensor", "cpu", "torch.bfloat16", [64, 48]]
        assert bits == sent.view(torch.int16).numpy().tobytes()
        rt.get([a.stop.remote(), b.stop.remote()], timeout=30)
    finally:
        rt.shutdown()
