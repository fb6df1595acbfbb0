"""The port's classic Tune surface against the JAX package's: class
trainables with checkpoints (path and dict forms) and their resume,
callbacks and ``CLIReporter``, ``ExperimentAnalysis``,
``PlacementGroupFactory`` with ``with_resources``, ``Experiment`` and
``run_experiments``, ``register_env`` resolved in tasks and actors,
``ResumeConfig``, ``FailureConfig`` retries, ``tune.run(resume=True)``,
``with_parameters``, dict stops, stoppers and ``register_trainable``.

The ``CLASSIC`` table of tests/torch_tune_programs.py runs once on each
package, as tests/test_torch_tune_parity.py runs its ``API`` table:
results equal on both, and equal to ``EXPECTED``.
"""

from __future__ import annotations

import pytest
import torch

import torch_runtime_programs
import torch_tune_programs as programs

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
    return {name: programs.run_table(name, programs.CLASSIC)
            for name in PACKAGES}


@pytest.mark.parametrize("program", list(programs.CLASSIC))
def test_program_gives_the_same_result_on_both_packages(table, program):
    jax_out, port_out = (table[name][program] for name in PACKAGES)
    assert jax_out[0] == "ok", jax_out
    assert port_out == jax_out


@pytest.mark.parametrize("program", list(programs.CLASSIC))
def test_program_outcome_is_the_expected_one(table, program):
    assert table["ray_tpu_torch"][program] == \
        ("ok", programs.EXPECTED[program])
