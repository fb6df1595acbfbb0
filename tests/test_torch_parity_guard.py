"""The guard around every parity table (``tests/torch_parity.py``).

``table_run`` turns the automatic garbage collector off for a run of the
JAX package's table, and back on with a collection after it; it leaves the
collector alone for the port's; on either it arms a faulthandler dump of
every thread's stack. Every ``run_table`` and ``run_alone`` of
``tests/torch_*programs.py``, and the table fixtures of the test files that
run both packages themselves, go through it: none keeps a guard of its own.
"""

from __future__ import annotations

import ast
import gc
import os
import subprocess
import sys

import pytest

import torch_parity
from torch_parity import table_run

HERE = os.path.dirname(os.path.abspath(__file__))
PROGRAM_MODULES = sorted(f for f in os.listdir(HERE)
                         if f.startswith("torch_") and f.endswith(
                             "programs.py"))
# Test files that run a table on both packages in their own fixture, and
# the fixture (or the function it calls).
FIXTURES = {
    "test_torch_runtime.py": "_run_table",
    "test_torch_data.py": "_run_table",
    "test_torch_cli.py": "table",
    "test_torch_cpp.py": "table",
    "test_torch_container_env.py": "table",
    "test_torch_toplevel.py": "table",
    "test_torch_collective_host.py": "outcomes",
    "test_torch_train_frameworks.py": "outcomes",
}


@pytest.fixture
def collections(monkeypatch) -> list:
    """Each ``gc.collect()`` call, noted, not run."""
    calls: list = []
    monkeypatch.setattr(gc, "collect", lambda *a: calls.append(a) or 0)
    return calls


def test_the_collector_is_off_for_the_jax_package_and_back_after(
        collections):
    assert gc.isenabled()
    with table_run("ray_tpu"):
        assert not gc.isenabled()
        assert collections == []
    assert gc.isenabled()
    assert len(collections) == 1


def test_the_collector_is_back_after_a_jax_package_run_that_raised(
        collections):
    with pytest.raises(ValueError):
        with table_run("ray_tpu"):
            raise ValueError("a table that fails")
    assert gc.isenabled() and len(collections) == 1


def test_the_collector_is_left_alone_for_the_port(collections):
    with table_run("ray_tpu_torch"):
        assert gc.isenabled()
    assert gc.isenabled() and collections == []
    gc.disable()
    try:
        with table_run("ray_tpu"):
            assert not gc.isenabled()
        assert not gc.isenabled(), "a collector that was off stays off"
    finally:
        gc.enable()
    assert collections == []


_HANG = r"""
import sys, threading, time
sys.path.insert(0, {here!r})
from torch_parity import table_run

def waiter():
    time.sleep(5)

threading.Thread(target=waiter, name="held", daemon=True).start()
with table_run("ray_tpu", seconds={seconds}):
    time.sleep({sleep})
print("table done")
"""


@pytest.mark.parametrize("seconds,sleep,dumped", [(0.3, 1.5, True),
                                                  (5.0, 0.2, False)])
def test_a_run_past_its_time_dumps_every_threads_stack(seconds, sleep,
                                                       dumped):
    """Outside pytest the dump goes to stderr; the run goes on after it,
    and a run that ends in time dumps nothing."""
    proc = subprocess.run(
        [sys.executable, "-c", _HANG.format(here=HERE, seconds=seconds,
                                            sleep=sleep)],
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "table done"
    assert ("Timeout" in proc.stderr) == dumped, proc.stderr
    if dumped:
        assert "in waiter" in proc.stderr and "<string>" in proc.stderr


def test_the_dump_goes_to_pytests_copy_of_stderr(request):
    """Inside a test the dump's file is pytest's duplicate of the real
    stderr, which output capture does not take."""
    from _pytest.faulthandler import fault_handler_stderr_fd_key
    assert torch_parity.log_fd() == \
        request.config.stash[fault_handler_stderr_fd_key]


def _functions(path: str) -> dict:
    with open(path) as f:
        tree = ast.parse(f.read())
    return {node.name: node for node in ast.walk(tree)
            if isinstance(node, ast.FunctionDef)}


def _guarded(fn: ast.FunctionDef) -> bool:
    """A ``with table_run(...)`` in ``fn``'s body."""
    return any(isinstance(node, ast.With) and any(
        isinstance(item.context_expr, ast.Call)
        and getattr(item.context_expr.func, "id", "") == "table_run"
        for item in node.items) for node in ast.walk(fn))


@pytest.mark.parametrize("module", PROGRAM_MODULES)
def test_every_table_of_a_programs_module_goes_through_the_guard(module):
    path = os.path.join(HERE, module)
    runners = {name: fn for name, fn in _functions(path).items()
               if name in ("run_table", "run_alone")}
    unguarded = [name for name, fn in runners.items() if not _guarded(fn)]
    assert not unguarded, f"{module}: {unguarded} run a table unguarded"
    with open(path) as f:
        text = f.read()
    assert "gc.disable()" not in text, f"{module} keeps its own guard"


@pytest.mark.parametrize("test_file", sorted(FIXTURES))
def test_every_table_fixture_goes_through_the_guard(test_file):
    fn = _functions(os.path.join(HERE, test_file))[FIXTURES[test_file]]
    assert _guarded(fn), f"{test_file}: {fn.name} runs its table unguarded"


def test_the_modules_with_tables_are_the_known_ones():
    """A new programs module with a table is checked above; one that has
    none would be a sign the check looks at the wrong names."""
    with_tables = [m for m in PROGRAM_MODULES if {"run_table", "run_alone"}
                   & set(_functions(os.path.join(HERE, m)))]
    assert set(with_tables) >= {
        "torch_cluster_programs.py", "torch_dag_programs.py",
        "torch_ops_programs.py", "torch_rllib_programs.py",
        "torch_serve_programs.py", "torch_tune_programs.py",
        "torch_util_programs.py", "torch_workflow_programs.py"}
