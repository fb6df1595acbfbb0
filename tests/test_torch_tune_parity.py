"""The port's Tune (``ray_tpu_torch.tune``) against the JAX package's
(``ray_tpu.tune``): the Tuner with its searchers and schedulers (grid and
seeded random search, ASHA, HyperBand, BOHB, PBT, PB2), error isolation,
restore from the journal, a trainer as the trainable, an external
searcher through OptunaSearch, and the time budget.

The ``API`` table of small Tune programs (tests/torch_tune_programs.py)
runs once on ``ray_tpu`` and once on ``ray_tpu_torch``, each runtime
started once for the table with ``num_cpus=4`` (the JAX package's first,
shut down before the port's starts). Results must be equal, and equal to
what each program must give (``EXPECTED``), so that both packages wrong
in the same way fail too. The classic surface is in
tests/test_torch_tune_classic.py, GPT-2 under Tune in
tests/test_torch_tune_gpt2.py.
"""

from __future__ import annotations

import os
import tempfile
import time

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


def _held(gate: str, config):
    """A trial that records when it ran (two files in ``gate``)."""
    from ray_tpu_torch import train
    name = os.path.join(gate, f"{config['i']}")
    with open(name + ".start", "w") as f:
        f.write(repr(time.time()))
    time.sleep(0.5)
    with open(name + ".end", "w") as f:
        f.write(repr(time.time()))
    train.report({"i": config["i"]})


def test_default_concurrency_is_bounded_by_every_resource():
    """The port's difference (README): four trials that each hold one of
    two ``slot`` resources run two at a time by default, where a bound by
    CPUs alone (the JAX package's) would admit all four and leave two
    waiting for a slot without answering their polls."""
    import functools

    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig
    rt.init(num_cpus=4, resources={"slot": 2})
    try:
        with tempfile.TemporaryDirectory() as d:
            gate = os.path.join(d, "gate")
            os.makedirs(gate)
            tc = tune.TuneConfig(resources_per_trial={"CPU": 1, "slot": 1})
            tuner = tune.Tuner(
                functools.partial(_held, gate),
                param_space={"i": tune.grid_search([0, 1, 2, 3])},
                tune_config=tc,
                run_config=RunConfig(storage_path=os.path.join(d, "s")))
            assert tuner._resource_bound(tc) == 2
            grid = tuner.fit()
            spans = []
            for i in range(4):
                with open(os.path.join(gate, f"{i}.start")) as f:
                    start = float(f.read())
                with open(os.path.join(gate, f"{i}.end")) as f:
                    spans.append((start, float(f.read())))
        assert sorted(r.state for r in grid) == ["COMPLETED"] * 4
        most = max(sum(1 for s, e in spans if s <= t < e)
                   for t, _ in spans)
        assert most == 2, spans
    finally:
        rt.shutdown()
