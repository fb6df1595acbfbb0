"""The port's durable workflows against the JAX package's.

The ``TABLE`` of tests/torch_workflow_programs.py runs once on
``ray_tpu`` and once on ``ray_tpu_torch``, one runtime of ``num_cpus=4``
per package, each package's workflow storage under a temporary root of
its own. Outcomes must be equal to each other and to ``EXPECTED``,
exactly. The programs: a run, status and metadata, a failure and the
resume that skips the done step (execution counts from files), parallel
branches, actor steps refused, ``wait_for_event`` and its checkpoint,
``sleep``, ``continuation``, ``resume_all`` and ``get_output_async``,
cancel, delete, a named step's checkpoint surviving a refactor of the
stored DAG, and a durable error.

Below the table, the port alone: its default storage root is apart from
the JAX package's.
"""

from __future__ import annotations

import pytest
import torch

import torch_runtime_programs
import torch_workflow_programs as programs

PACKAGES = ("ray_tpu", "ray_tpu_torch")
PROGRAMS = list(programs.TABLE)


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
    process behind."""
    yield
    assert torch_runtime_programs.workers_left() == []


@pytest.fixture(scope="module")
def table() -> dict:
    """{package: {program: outcome}}, the JAX package's run first."""
    return {name: programs.run_table(name, programs.TABLE)
            for name in PACKAGES}


@pytest.mark.parametrize("program", PROGRAMS)
def test_program_gives_the_same_result_on_both_packages(table, program):
    jax_out, port_out = (table[name][program] for name in PACKAGES)
    both = "; ".join(
        f"{name} {programs.said(name, program, table[name][program])}"
        for name in PACKAGES)
    assert jax_out[0] == "ok", both
    assert port_out == jax_out, both


@pytest.mark.parametrize("program", PROGRAMS)
def test_program_outcome_is_the_expected_one(table, program):
    assert table["ray_tpu_torch"][program] == \
        ("ok", programs.EXPECTED[program])


def test_default_storage_root_is_the_ports_own():
    import tempfile

    import ray_tpu.workflow.storage as jax_storage
    import ray_tpu_torch.workflow.storage as port_storage
    assert port_storage._DEFAULT_ROOT == \
        f"{tempfile.gettempdir()}/ray_tpu_torch_workflows"
    assert port_storage._DEFAULT_ROOT != jax_storage._DEFAULT_ROOT
