"""The port's one-node utility modules against the JAX package's:
``util.queue``, ``util.multiprocessing``, ``util.joblib``,
``util.scheduling_strategies``, ``experimental.pubsub``, ``util.usage``,
``util.logdir``, ``util.chaos`` and ``util.ha``.

The ``TABLE`` of tests/torch_util_programs.py runs once on ``ray_tpu``
and once on ``ray_tpu_torch``, one runtime of ``num_cpus=4`` per
package; its ``ALONE`` programs (the head snapshot round trips) start and
stop runtimes of their own. Results must be equal, and equal to
``EXPECTED``. The multi-node chaos kinds (``node``, ``preempt``,
``partition``) act on node daemons: they build on both packages alike
here and run in tests/test_torch_cluster*.py.
"""

from __future__ import annotations

import pytest
import torch

import torch_runtime_programs
import torch_util_programs as programs

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
def _no_worker_left():
    """Torn down after the module's runtimes: none leaves a worker
    process behind for the tests that follow."""
    yield
    assert torch_runtime_programs.workers_left() == []


@pytest.fixture(scope="module")
def table() -> dict:
    """{package: {program: outcome}}, the JAX package's run first."""
    return {name: {**programs.run_table(name, programs.TABLE),
                   **programs.run_alone(name, programs.ALONE)}
            for name in PACKAGES}


def _needs(program: str) -> None:
    if program == "joblib_backend":
        pytest.importorskip("joblib")


@pytest.mark.parametrize("program", PROGRAMS)
def test_program_gives_the_same_result_on_both_packages(table, program):
    _needs(program)
    jax_out, port_out = (table[name][program] for name in PACKAGES)
    assert jax_out[0] == "ok", jax_out
    assert port_out == jax_out


@pytest.mark.parametrize("program", PROGRAMS)
def test_program_outcome_is_the_expected_one(table, program):
    _needs(program)
    assert table["ray_tpu_torch"][program] == \
        ("ok", programs.EXPECTED[program])


@pytest.mark.parametrize("kind", ["node", "preempt", "partition"])
def test_multi_node_chaos_kinds_raise_on_the_port(kind):
    """They no longer raise: each kind builds on the port as on the JAX
    package, with the same settings."""
    import ray_tpu.util.chaos as jax_chaos
    import ray_tpu_torch.util.chaos as port_chaos
    made = [mod.ResourceKiller(kind=kind, runtime=object(), seed=3,
                               plan_file="plan.json")
            for mod in (jax_chaos, port_chaos)]
    assert [(k.kind, k.plan_file, k.kills, k.decisions) for k in made] \
        == [(kind, "plan.json", 0, [])] * 2


def test_every_util_module_of_the_jax_package_resolves():
    import ray_tpu_torch.experimental as experimental
    import ray_tpu_torch.util as util
    for name in ("queue", "multiprocessing", "joblib",
                 "scheduling_strategies", "chaos", "ha", "usage", "logdir"):
        assert getattr(util, name).__name__ == f"ray_tpu_torch.util.{name}"
    assert experimental.pubsub.__name__ == "ray_tpu_torch.experimental.pubsub"
    assert experimental.channel.__name__ == \
        "ray_tpu_torch.experimental.channel"
