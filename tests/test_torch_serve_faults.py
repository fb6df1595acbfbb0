"""The port's Serve against the JAX package's, under faults: exception
classification and the HTTP and gRPC answers for each, the serve knobs,
multiplex eviction against pinned models, the replica's response
ledger and admission gates, readiness gating and health ejection, HTTP
503 and 504 answers and the proxy's in-flight cap, and zero lost
requests through replica kills (the public ``kill``), a rolling
redeploy and an autoscale-down.

The ``FAULTS`` table of tests/torch_serve_programs.py runs once on
``ray_tpu`` and once on ``ray_tpu_torch``, as in
tests/test_torch_serve_parity.py. Results must be equal, and equal to
``EXPECTED``. The node-drain cases of the JAX package are multi-node:
tests/test_torch_serve_gpt2.py holds that the port refuses them.
"""

from __future__ import annotations

import pytest
import torch

import torch_runtime_programs
import torch_serve_programs as programs

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
    """Torn down after the module's runtimes: none leaves a worker
    process behind for the tests that follow."""
    yield
    assert torch_runtime_programs.workers_left() == []


@pytest.fixture(scope="module")
def table() -> dict:
    """{package: {program: outcome}}, the JAX package's run first."""
    return {name: programs.run_table(name, programs.FAULTS)
            for name in PACKAGES}


@pytest.mark.parametrize("program", list(programs.FAULTS))
def test_program_gives_the_same_result_on_both_packages(table, program):
    jax_out, port_out = (table[name][program] for name in PACKAGES)
    assert jax_out[0] == "ok", jax_out
    assert port_out == jax_out


@pytest.mark.parametrize("program", list(programs.FAULTS))
def test_program_outcome_is_the_expected_one(table, program):
    assert table["ray_tpu_torch"][program] == \
        ("ok", programs.EXPECTED[program])
