"""The port's command line (``python -m ray_tpu_torch.scripts.cli``)
against the JAX package's.

The ``TABLE`` of tests/torch_cli_programs.py runs once on ``ray_tpu``
and once on ``ray_tpu_torch``: ``start --head`` / ``start --address`` /
``stop`` with a 0600 head-info file (tests/test_cli_start.py), ``status``
and ``list tasks``, ``doctor``, the ``job`` subcommands, ``job submit``
attaching to a live session (tests/test_ops_shell.py:129, :155, :326,
:355) and ``logs`` (tests/test_dashboard_logs.py:131); then the
subcommands the JAX package's tests leave out: ``alerts``, ``memory``,
``stack``, ``profile``, ``summary``, ``traces``, ``trace``, ``timeline``,
``metrics``, ``usage``, ``serve deploy|status`` and ``up --validate``.
Outcomes are compared exactly. Beyond the JAX package: with one head of each package
running, the port's ``stop`` signals its own only (it reads its own
session root, never ``/tmp/ray_tpu_sessions``).

The slice as a whole: a job submitted with ``cli job submit`` that trains
GPT-2 tiny (float32, AdamW) for two steps from the JAX package's own
initialisation, on each package, its losses held within ``LOSS_ATOL =
2e-5`` of each other (tests/test_torch_jobs.py's bound).
"""

from __future__ import annotations

import tempfile

import numpy as np
import pytest
import torch

import torch_cli_programs as programs
import torch_ops_programs
from torch_parity import table_run

PACKAGES = ("ray_tpu", "ray_tpu_torch")
LOSS_ATOL = 2e-5                    # tests/test_torch_jobs.py's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module, as every test_torch_* file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _no_process_left():
    yield
    assert torch_ops_programs.processes_left() == []


@pytest.fixture(scope="module")
def table() -> dict:
    """{package: {program: outcome}}, the JAX package's run first."""
    out = {}
    for name in PACKAGES:
        rt = __import__(name)
        with table_run(name):
            out[name] = {prog: programs.run(fn, rt)
                         for prog, fn in programs.TABLE.items()}
    return out


@pytest.mark.parametrize("program", list(programs.TABLE))
def test_program_gives_the_same_result_on_both_packages(table, program):
    jax_out, port_out = (table[name][program] for name in PACKAGES)
    assert jax_out[0] == "ok", jax_out
    assert port_out == jax_out


@pytest.mark.parametrize("program", sorted(programs.EXPECTED))
def test_program_outcome_is_the_expected_one(table, program):
    assert table["ray_tpu_torch"][program] == \
        ("ok", programs.EXPECTED[program])


def test_the_ports_stop_signals_its_own_head_only():
    with tempfile.TemporaryDirectory(
            prefix="rtt", dir=programs.short_tmp_parent()) as tmp:
        out = programs.both_packages_stop(tmp)
    assert "1 session(s) signaled" in out["stop"], out
    assert out["port_rc"] == 0 and out["jax_alive"], out
    assert "1 session(s) signaled" in out["jax_stop"], out
    assert out["jax_rc"] == 0


def test_discovery_reads_the_ports_session_root(tmp_path, monkeypatch):
    """``stop`` and session discovery read the port's session root (what
    ``init(address="auto")`` reads), and pass over a dead head's leftover
    socket."""
    from ray_tpu_torch.core.runtime import session_root
    from ray_tpu_torch.scripts import cli
    assert cli._session_root() == session_root()
    assert session_root().endswith("ray_tpu_torch_sessions")
    root = tmp_path / "ray_tpu_torch_sessions"
    (root / "999999999").mkdir(parents=True)
    (root / "999999999" / "runtime.sock").touch()
    monkeypatch.setattr(cli, "_session_root", lambda: str(root))
    with pytest.raises(SystemExit, match="no live ray_tpu_torch session"):
        cli._discover_address(None)
    assert cli._discover_address("/x/runtime.sock") == "/x/runtime.sock"


@pytest.fixture(scope="module")
def gpt2_jobs(tmp_path_factory) -> dict:
    """{package: the CLI-submitted GPT-2 job's outcome}, both from one
    saved initialisation of the JAX GPT-2 tiny and one batch."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("optax")
    import jax.numpy as jnp

    from ray_tpu.models import GPT2, GPT2Config
    params = GPT2(GPT2Config.tiny(dtype=jnp.float32)).init_params(
        jax.random.key(0))
    flat = {"params/" + "/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    rng = np.random.default_rng(0)
    toks = rng.integers(0, GPT2Config.tiny().vocab_size, (4, 64)
                        ).astype(np.int32)
    init = str(tmp_path_factory.mktemp("gpt2_cli_job") / "init.npz")
    np.savez(init, tokens=toks, targets=np.roll(toks, -1, 1), **flat)
    out = {}
    for name in PACKAGES:
        outcome = programs.run(programs.gpt2_cli_job, __import__(name), init)
        assert outcome[0] == "ok", outcome
        out[name] = outcome[1]
    return out


def test_gpt2_cli_job_succeeds_on_both_packages(gpt2_jobs):
    for name, job in gpt2_jobs.items():
        assert [job["rc"], job["finished"]] == [0, True], (name, job["logs"])
        assert len(job["out"]["losses"]) == torch_ops_programs.GPT2_STEPS


def test_gpt2_cli_job_losses_match_the_jax_package(gpt2_jobs):
    want = gpt2_jobs["ray_tpu"]["out"]["losses"]
    got = gpt2_jobs["ray_tpu_torch"]["out"]["losses"]
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    assert got[1] < got[0]
