"""Durable-workflow user programs, each run once on ``ray_tpu`` and once
on ``ray_tpu_torch`` (tests/test_torch_workflow.py).

Every program takes the package module (``rt``) and a scratch directory
of its own, and uses the package's public ``workflow`` API (plus its
``storage`` and serializer where a program rewrites a stored DAG, as a
refactor would), so the same code runs on both. The table runs in one
runtime a package, with the package's workflow storage under a temporary
root of that run. Nothing here imports either package at module level.
Step executions are counted from files the steps write; waits are on
conditions with deadlines. When a program's outcome is not the expected
one, ``run_table`` prints it on stderr with the seconds the program and
each of its ``run``, ``resume`` and ``get_output`` calls took.
"""

from __future__ import annotations

import importlib
import os
import shutil
import sys
import tempfile
import time

from torch_parity import table_run

WAIT_S = 120

# (call, seconds) of the running program's workflow calls, and
# {(package, program): (seconds, calls)} of every program run.
CALLS: list = []
TIMES: dict = {}


def _mod(rt, name: str):
    return importlib.import_module(f"{rt.__name__}.{name}")


class _TimedWorkflow:
    """The package's ``workflow`` module, with the seconds of each
    ``run``, ``resume`` and ``get_output`` call noted in ``CALLS``."""

    TIMED = ("run", "resume", "get_output")

    def __init__(self, mod):
        self._mod = mod

    def __reduce__(self):
        """A step that closes over it gets the plain module."""
        return (importlib.import_module, (self._mod.__name__,))

    def __getattr__(self, name):
        val = getattr(self._mod, name)
        if name not in self.TIMED:
            return val

        def timed(*args, **kwargs):
            t0 = time.monotonic()
            try:
                return val(*args, **kwargs)
            finally:
                CALLS.append((name, round(time.monotonic() - t0, 3)))
        return timed


def _wf(rt):
    return _TimedWorkflow(_mod(rt, "workflow"))


def _until(cond, timeout: float, what: str, period: float = 0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = cond()
        if out:
            return out
        time.sleep(period)
    raise TimeoutError(f"{what} within {timeout}s")


def _raised(fn) -> tuple:
    """(class name, message) of what ``fn()`` raises, or ("", value)."""
    try:
        return ("", fn())
    except Exception as e:  # noqa: BLE001 — compared across packages
        return (type(e).__name__, str(e))


def _count(path: str) -> int:
    try:
        with open(path) as f:
            return len(f.read())
    except FileNotFoundError:
        return 0


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _polling_pid(path: str) -> int | None:
    """The process id a ``FileEvent`` polling for ``path`` wrote, or
    None before it polls."""
    try:
        with open(path + ".pid") as f:
            return int(f.read())
    except FileNotFoundError:
        return None


def _file_event(rt):
    """An ``EventListener`` of the package that fires when a file
    exists; its content is the event. While it polls, ``<path>.pid``
    holds its process id."""
    class FileEvent(_wf(rt).EventListener):
        def poll_for_event(self, path):
            with open(path + ".pid.tmp", "w") as f:
                f.write(str(os.getpid()))
            os.replace(path + ".pid.tmp", path + ".pid")
            while not os.path.exists(path):
                time.sleep(0.05)
            with open(path) as f:
                return f.read()
    return FileEvent


def _shout(rt):
    @rt.remote(num_cpus=0.25)
    def shout(x):
        return str(x).upper()
    return shout


def run_simple(rt, d):
    """``add(double(x), 1)`` with ``args=5``."""
    @rt.remote(num_cpus=0.25)
    def add(a, b):
        return a + b

    @rt.remote(num_cpus=0.25)
    def double(x):
        return 2 * x

    with _mod(rt, "dag").InputNode() as inp:
        dag = add.bind(double.bind(inp), 1)
    return _wf(rt).run(dag, args=5, timeout=WAIT_S)


def status_and_metadata(rt, d):
    """A finished workflow's status, metadata (without the DAG), run
    and step metadata, and its row in ``list_all``."""
    wf = _wf(rt)

    @rt.remote(num_cpus=0.25)
    def one():
        return 1

    node = one.options(**wf.options(name="stable_step",
                                    metadata={"owner": "team-x"})).bind()
    wid = "wf_status"
    out = wf.run(node, workflow_id=wid, metadata={"team": "x"},
                 timeout=WAIT_S)
    meta = wf.get_metadata(wid)
    return [out, wf.get_status(wid), meta["workflow_id"],
            "dag_blob" in meta, meta["step_metadata"],
            meta["user_metadata"], (wid, "SUCCESSFUL") in wf.list_all()]


def failure_then_resume(rt, d):
    """Step b fails until a gate file exists: the run ends FAILED with
    the step's error; ``resume`` runs only b (a's result loads from
    storage). Each step counts its runs in a file."""
    wf = _wf(rt)
    runs_a, runs_b = os.path.join(d, "a_runs"), os.path.join(d, "b_runs")
    gate = os.path.join(d, "gate")

    @rt.remote(num_cpus=0.25)
    def step_a():
        with open(runs_a, "a") as f:
            f.write("x")
        return 10

    @rt.remote(num_cpus=0.25)
    def step_b(x):
        with open(runs_b, "a") as f:
            f.write("x")
        if not os.path.exists(gate):
            raise RuntimeError("transient failure")
        return x + 5

    wid = "wf_resume"
    name, msg = _raised(lambda: wf.run(step_b.bind(step_a.bind()),
                                       workflow_id=wid, timeout=WAIT_S))
    failed = [name, "transient failure" in msg, wf.get_status(wid),
              _count(runs_a), _count(runs_b)]
    open(gate, "w").close()
    resumed = [wf.resume(wid, timeout=WAIT_S), wf.get_status(wid),
               _count(runs_a), _count(runs_b)]
    return [failed, resumed]


def parallel_branches(rt, d):
    """Three two-step chains run side by side: each step logs its start
    and end, and two chains' first steps overlap in time. A fan-in of
    four leaves."""
    wf = _wf(rt)
    log = os.path.join(d, "log")
    os.makedirs(log)

    @rt.remote(num_cpus=0.25)
    def slow(x, tag):
        with open(os.path.join(log, f"{tag}-start"), "w"):
            pass
        # Longer than a worker's start under load, so that the steps
        # that start on fresh workers still overlap.
        time.sleep(1.0)
        with open(os.path.join(log, f"{tag}-end"), "w"):
            pass
        return x

    @rt.remote(num_cpus=0.25)
    def add3(a, b, c):
        return a + b + c

    chains = [slow.bind(slow.bind(i, f"{i}a"), f"{i}b") for i in range(3)]
    out = wf.run(add3.bind(*chains), timeout=WAIT_S)
    start = {n[:-6]: os.stat(os.path.join(log, n)).st_mtime_ns
             for n in os.listdir(log) if n.endswith("-start")}
    end = {n[:-4]: os.stat(os.path.join(log, n)).st_mtime_ns
           for n in os.listdir(log) if n.endswith("-end")}
    overlap = any(start[f"{i}a"] < end[f"{j}a"]
                  and start[f"{j}a"] < end[f"{i}a"]
                  for i in range(3) for j in range(i + 1, 3))

    @rt.remote(num_cpus=0.25)
    def leaf(x):
        return x * x

    @rt.remote(num_cpus=0.25)
    def gather(*xs):
        return sum(xs)

    fan = wf.run(gather.bind(*[leaf.bind(i) for i in range(4)]),
                 timeout=WAIT_S)
    return [out, overlap, len(start), fan]


def actor_steps_rejected(rt, d):
    """A workflow of an actor method is refused: actor steps are not
    durable."""
    @rt.remote(num_cpus=0.25)
    class A:
        def m(self):
            return 1

    a = A.remote()
    try:
        name, msg = _raised(lambda: _wf(rt).run(a.m.bind(), timeout=60))
    finally:
        rt.kill(a)
    return [name, "function DAGs only" in msg]


def wait_for_event(rt, d):
    """An event step waits for its file; the workflow stays RUNNING until
    the file is written. A listener class that is not an
    ``EventListener`` is refused."""
    wf = _wf(rt)
    marker = os.path.join(d, "event")
    wid = wf.run_async(_shout(rt).bind(wf.wait_for_event(_file_event(rt),
                                                         marker)))
    time.sleep(0.3)
    waiting = wf.get_status(wid)
    with open(marker, "w") as f:
        f.write("fired")
    out = wf.get_output(wid, timeout=WAIT_S)
    name, msg = _raised(lambda: wf.wait_for_event(object))
    return [waiting, out, name, "EventListener" in msg]


def event_checkpointed(rt, d):
    """An async listener's event is checkpointed: resuming the finished
    workflow after the file is gone does not poll again."""
    wf = _wf(rt)
    marker = os.path.join(d, "event")
    with open(marker, "w") as f:
        f.write("async-ev")

    class AsyncFileEvent(wf.EventListener):
        async def poll_for_event(self, path):
            import asyncio
            while not os.path.exists(path):
                await asyncio.sleep(0.05)
            with open(path) as f:
                return f.read()

    wid = "wf_event_ckpt"
    out = wf.run(_shout(rt).bind(wf.wait_for_event(AsyncFileEvent, marker)),
                 workflow_id=wid, timeout=WAIT_S)
    os.unlink(marker)
    return [out, wf.resume(wid, timeout=WAIT_S)]


def durable_sleep(rt, d):
    """``workflow.sleep`` is a step: the step after it starts no sooner."""
    wf = _wf(rt)

    @rt.remote(num_cpus=0.25)
    def after(_):
        return "woke"

    t0 = time.monotonic()
    out = wf.run(after.bind(wf.sleep(0.4)), timeout=WAIT_S)
    return [out, time.monotonic() - t0 >= 0.4]


def continuation(rt, d):
    """Fibonacci by continuations; a finished one resumes from its
    stored result. ``continuation`` takes bound nodes only."""
    wf = _wf(rt)

    @rt.remote(num_cpus=0.25)
    def fib(n):
        if n <= 1:
            return n
        return wf.continuation(fib_sum.bind(n))

    @rt.remote(num_cpus=0.25)
    def add(a, b):
        return a + b

    @rt.remote(num_cpus=0.25)
    def fib_sum(n):
        return wf.continuation(add.bind(fib.bind(n - 1), fib.bind(n - 2)))

    out = wf.run(fib.bind(7), workflow_id="wf_fib", timeout=WAIT_S)
    name, msg = _raised(lambda: wf.continuation(42))
    return [out, wf.resume("wf_fib", timeout=WAIT_S), name,
            "bound DAG node" in msg]


def resume_all_and_async_output(rt, d):
    """Two workflows fail on their first attempt; ``resume_all`` resumes
    both, each output an ObjectRef. ``get_output_async`` of a running
    workflow, and its durable output read as from another process."""
    wf = _wf(rt)

    @rt.remote(num_cpus=0.25)
    def flaky(path):
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write("x")
            raise RuntimeError("first attempt fails")
        return "recovered"

    failed = []
    for i in range(2):
        name, _ = _raised(lambda: wf.run(
            flaky.bind(os.path.join(d, f"flaky{i}")),
            workflow_id=f"wf_resume_all_{i}", timeout=WAIT_S))
        failed.append(name)
    resumed = dict(wf.resume_all())
    outs = [rt.get(resumed[f"wf_resume_all_{i}"], timeout=WAIT_S)
            for i in range(2)]

    @rt.remote(num_cpus=0.25)
    def slowly(x):
        time.sleep(0.3)
        return x * 2

    wid = wf.run_async(slowly.bind(21))
    via_ref = rt.get(wf.get_output_async(wid), timeout=WAIT_S)
    _mod(rt, "workflow.api")._running.pop(wid, None)   # another process
    return [failed,
            sorted(k for k in resumed if k.startswith("wf_resume_all")),
            outs, via_ref, wf.get_output(wid)]


def cancel(rt, d):
    """A workflow cancelled while its event step polls: its output
    raises ``WorkflowCancellationError``, its status is CANCELED.

    The cancel waits until the step polls, and the program until the
    step's process is gone. Cancelled while its worker was still
    starting, the step was dispatched again and polled on after the
    program, in both packages: their dispatch retries a task whose
    worker died before it connected, a force-cancelled one too
    (``ray_tpu/core/runtime.py:2032-2044``)."""
    wf = _wf(rt)
    never = os.path.join(d, "never")
    wid = wf.run_async(_shout(rt).bind(wf.wait_for_event(
        _file_event(rt), never)))
    pid = _until(lambda: _polling_pid(never), WAIT_S, "the event step polls")
    wf.cancel(wid)
    name, _ = _raised(lambda: wf.get_output(wid, timeout=WAIT_S))
    _until(lambda: not _alive(pid), WAIT_S,
           "the cancelled event step's process is gone")
    return [name, wf.get_status(wid)]


def delete(rt, d):
    """A deleted workflow is gone from storage; deleting it again
    raises."""
    wf = _wf(rt)

    @rt.remote(num_cpus=0.25)
    def one():
        return 1

    wid = "wf_delete_me"
    out = wf.run(one.bind(), workflow_id=wid, timeout=WAIT_S)
    wf.delete(wid)
    status = _raised(lambda: wf.get_status(wid))
    again = _raised(lambda: wf.delete(wid))
    return [out, status[0], "no stored workflow" in status[1], again[0]]


def named_step_survives_refactor(rt, d):
    """A named step's checkpoint loads after the stored DAG is replaced
    by one with a step inserted ahead of it: the named step does not run
    again."""
    wf = _wf(rt)
    hits = os.path.join(d, "hits")

    @rt.remote(num_cpus=0.25)
    def expensive():
        with open(hits, "a") as f:
            f.write("x")
        return 10

    @rt.remote(num_cpus=0.25)
    def plus(a, b):
        return a + b

    @rt.remote(num_cpus=0.25)
    def boom(_):
        raise RuntimeError("v1 fails downstream")

    named = expensive.options(**wf.options(name="exp"))
    wid = "wf_refactor"
    first, _ = _raised(lambda: wf.run(boom.bind(named.bind()),
                                      workflow_id=wid, timeout=WAIT_S))
    store = _mod(rt, "workflow.storage").WorkflowStorage(wid)
    meta = store.load_meta()
    new_dag = plus.bind(named.bind(), plus.bind(1, 2))
    meta["dag_blob"] = _mod(rt, "core.serialization").dumps(
        (new_dag, None)).hex()
    store.save_meta(meta)
    return [first, _count(hits), wf.resume(wid, timeout=WAIT_S),
            _count(hits)]


def durable_error(rt, d):
    """A failed workflow's error is durable: read as from another
    process it raises ``WorkflowExecutionError``."""
    wf = _wf(rt)

    @rt.remote(num_cpus=0.25)
    def die():
        raise RuntimeError("permanent")

    wid = "wf_dead"
    first, _ = _raised(lambda: wf.run(die.bind(), workflow_id=wid,
                                      timeout=WAIT_S))
    _mod(rt, "workflow.api")._running.pop(wid, None)
    name, msg = _raised(lambda: wf.get_output(wid))
    return [first, name, "failed" in msg, "permanent" in msg]


TABLE = {f.__name__: f for f in (
    run_simple, status_and_metadata, failure_then_resume, parallel_branches,
    actor_steps_rejected, wait_for_event, event_checkpointed, durable_sleep,
    continuation, resume_all_and_async_output, cancel, delete,
    named_step_survives_refactor, durable_error)}


def run(program, rt, d: str) -> tuple:
    """("ok", result) or ("raised", class name, message)."""
    try:
        return ("ok", program(rt, d))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__, str(e))


def run_table(name: str, table: dict) -> dict:
    """{program: outcome} of every program of ``table`` on package
    ``name``, in one runtime of ``num_cpus=4`` whose workflow storage is
    a temporary directory; each program gets a scratch directory. The
    run goes through ``torch_parity.table_run`` (the JAX package's
    with the automatic garbage collector off)."""
    rt = importlib.import_module(name)
    root = tempfile.mkdtemp(prefix=f"wf_{name}_")
    with table_run(name):
        rt.init(num_cpus=4)
        try:
            _wf(rt).init(os.path.join(root, "store"))
            out = {}
            for prog, fn in table.items():
                d = os.path.join(root, prog)
                os.makedirs(d)
                CALLS.clear()
                t0 = time.monotonic()
                out[prog] = run(fn, rt, d)
                TIMES[(name, prog)] = (round(time.monotonic() - t0, 3),
                                       list(CALLS))
                if out[prog] != ("ok", EXPECTED.get(prog)):
                    print(f"{name} {prog}: {said(name, prog, out[prog])}",
                          file=sys.stderr, flush=True)
            return out
        finally:
            rt.shutdown()
            shutil.rmtree(root, ignore_errors=True)


def said(name: str, prog: str, outcome) -> str:
    """``outcome`` of ``prog`` on package ``name``, what was expected,
    and the seconds the program and each of its workflow calls took."""
    took, calls = TIMES.get((name, prog), (None, []))
    return (f"outcome {outcome}, expected {('ok', EXPECTED.get(prog))}; "
            f"took {took} s; calls {calls}")


# What each program must give (the same on both packages, and right).
EXPECTED = {
    "run_simple": 11,
    "status_and_metadata": [1, "SUCCESSFUL", "wf_status", False,
                            {"named_stable_step": {"owner": "team-x"}},
                            {"team": "x"}, True],
    "failure_then_resume": [["TaskError", True, "FAILED", 1, 1],
                            [15, "SUCCESSFUL", 1, 2]],
    "parallel_branches": [3, True, 6, 14],
    "actor_steps_rejected": ["TypeError", True],
    "wait_for_event": ["RUNNING", "FIRED", "TypeError", True],
    "event_checkpointed": ["ASYNC-EV", "ASYNC-EV"],
    "durable_sleep": ["woke", True],
    "continuation": [13, 13, "TypeError", True],
    "resume_all_and_async_output": [["TaskError", "TaskError"],
                                    ["wf_resume_all_0", "wf_resume_all_1"],
                                    ["recovered", "recovered"], 42, 42],
    "cancel": ["WorkflowCancellationError", "CANCELED"],
    "delete": [1, "ValueError", True, "ValueError"],
    "named_step_survives_refactor": ["TaskError", 1, 13, 1],
    "durable_error": ["TaskError", "WorkflowExecutionError", True, True],
}
