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
numpy forward of the carried weights). Two programs take the JAX
package's initial weights on both packages: ``env_runner_episodes`` and
``world_model_learns``, whose thresholds are ratios to the losses at
those weights.
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
    from ray_tpu.rllib.dreamer import (
        DreamerHyperparams, DreamerLearner, DreamerModelConfig,
    )
    inputs = {
        "env_runner_episodes": build_actor_critic(
            programs.CARTPOLE).init_params(jax.random.key(0)),
        "world_model_learns": DreamerLearner(
            DreamerModelConfig(**programs.WORLD_MODEL),
            DreamerHyperparams(), seed=0).params,
    }
    inputs = {k: jax.tree_util.tree_map(np.asarray, v)
              for k, v in inputs.items()}
    return {name: programs.run_table(name, programs.RLLIB, inputs)
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
    """Every name of the JAX package's ``rllib.__all__`` resolves in the
    port, none is left unported, and ``policy="dreamer"`` builds a runner
    (on the CPU) whose policy is Dreamer's rollout step."""
    import ray_tpu.rllib as jax_rllib
    import ray_tpu_torch.rllib as rllib
    from ray_tpu_torch.rllib.dreamer import DreamerModule
    from ray_tpu_torch.rllib.env_runner import EnvRunner
    assert rllib._NOT_PORTED == ()
    assert set(jax_rllib.__all__) <= set(rllib.__all__)
    for name in jax_rllib.__all__:
        assert getattr(rllib, name) is not None, name
    runner = EnvRunner._cls(programs.ShortChainEnv,
                            {"obs_dim": 6, "num_actions": 2, "deter": 8,
                             "n_cat": 2, "n_classes": 4, "embed": 8,
                             "hidden": 8}, policy="dreamer")
    assert isinstance(runner.model, DreamerModule)
    eps = runner.sample(30)
    assert sum(e.length for e in eps) == 30
    assert all(e.state_in.shape == (1, 8) for e in eps)
