"""The port's RLlib (``ray_tpu_torch.rllib``) against the JAX package's
(``ray_tpu.rllib``): the ``RLLIB`` table of small programs
(tests/torch_rllib_programs.py) runs once on ``ray_tpu`` and once on
``ray_tpu_torch``, each in one runtime of ``num_cpus=4`` (the JAX
package's first, shut down before the port's starts), the port's learners
with ``device="cpu"``. Results must be equal, and equal to what each
program must give (``EXPECTED``), so that both packages wrong in the same
way fail too. A program's result holds only what a run decides; floats
that the frameworks round apart are held to their tolerance inside the
program (``env_runner_episodes``: log-probs and values within 1e-6 of a
numpy forward of the carried weights).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("gymnasium")

import torch_rllib_programs as programs  # noqa: E402
import torch_runtime_programs  # noqa: E402

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
    from ray_tpu.rllib.catalog import build_actor_critic
    weights = jax.tree_util.tree_map(
        np.asarray, build_actor_critic(programs.CARTPOLE).init_params(
            jax.random.key(0)))
    return {name: programs.run_table(name, programs.RLLIB, weights)
            for name in PACKAGES}


@pytest.mark.parametrize("program", list(programs.RLLIB))
def test_program_gives_the_same_result_on_both_packages(table, program):
    jax_out, port_out = (table[name][program] for name in PACKAGES)
    assert jax_out[0] == "ok", jax_out
    assert port_out == jax_out


@pytest.mark.parametrize("program", list(programs.RLLIB))
def test_program_outcome_is_the_expected_one(table, program):
    assert table["ray_tpu_torch"][program] == \
        ("ok", programs.EXPECTED[program])


def test_unported_algorithms_raise_naming_the_roadmap():
    """The JAX package's other algorithms keep their names and raise."""
    import ray_tpu_torch.rllib as rllib
    from ray_tpu_torch.rllib.env_runner import EnvRunner
    for name in rllib._NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            getattr(rllib, name)
    assert set(rllib._NOT_PORTED) <= set(rllib.__all__)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        EnvRunner._cls(None, {}, policy="dreamer")
