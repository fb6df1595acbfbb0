"""The port's Serve (``ray_tpu_torch.serve``) against the JAX package's
(``ray_tpu.serve``): handles, composition, batching, HTTP and ASGI
ingress, user_config, redeploys, autoscaling, multiplexing, declarative
deploys and gRPC ingress.

The ``API`` table of small Serve programs (tests/torch_serve_programs.py)
runs once on ``ray_tpu`` and once on ``ray_tpu_torch``, each runtime
started once for the table with ``num_cpus=4`` (the JAX package's first,
shut down before the port's starts; Serve shut down after each program).
Results must be equal, and equal to what each program must give
(``EXPECTED``), so that both packages wrong in the same way fail too.
The fault-tolerance programs are in tests/test_torch_serve_faults.py,
GPT-2 behind a deployment in tests/test_torch_serve_gpt2.py.
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
    return {name: programs.run_table(name, programs.API)
            for name in PACKAGES}


@pytest.mark.parametrize("program", list(programs.API))
def test_program_gives_the_same_result_on_both_packages(table, program):
    jax_out, port_out = (table[name][program] for name in PACKAGES)
    assert jax_out[0] == "ok", jax_out
    assert port_out == jax_out


@pytest.mark.parametrize("program", list(programs.API))
def test_program_outcome_is_the_expected_one(table, program):
    assert table["ray_tpu_torch"][program] == \
        ("ok", programs.EXPECTED[program])
