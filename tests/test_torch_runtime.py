"""The port's core runtime (``ray_tpu_torch.init``, tasks, actors, the
object store, placement groups) against the JAX package's.

One table of small user programs (tests/torch_runtime_programs.py) runs
once on ``ray_tpu`` and once on ``ray_tpu_torch``, each runtime started
once for the table (the JAX package's first and shut down before the
port's starts), and once more each under ``local_mode``. Results must be
equal; a program that raises must raise the same class on both, with the
remote traceback in its text. Then the port's own cases: a bf16 tensor
through ``put``/``get`` bit for bit, the GPU as a resource
(``init(num_gpus=1)``, which needs no card: the worker that holds it
learns the node's count from its environment), no module of ``ray_tpu``
in a worker, and what stays refused (``bind``, the dashboard; a second
``init``, ``address`` or not, in a process that runs a runtime). A
``cancel(force=True)`` that lands while a task's worker starts (held before
its handshake by a container runner, on the head or on a node daemon),
once the dispatcher has taken the task from the queue, or among racing
dispatches, ends the task CANCELLED: never run, never queued again, its
resources back once; a worker that dies before its handshake uncancelled
is still retried.
"""

from __future__ import annotations

import importlib
import os
import time

import numpy as np
import pytest
import torch

import torch_runtime_programs as programs
from torch_parity import table_run

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
    assert programs.workers_left() == []


def _run_table(name: str) -> dict:
    rt = importlib.import_module(name)
    with table_run(name):
        rt.init(num_cpus=4)
        try:
            out = {prog: programs.run(fn, rt)
                   for prog, fn in programs.TABLE.items()}
        finally:
            rt.shutdown()
        rt.init(local_mode=True)
        try:
            out["local_mode"] = programs.run(programs.local_mode, rt)
        finally:
            rt.shutdown()
    return out


@pytest.fixture(scope="module")
def table() -> dict:
    """{package: {program: outcome}}, the JAX package's run first."""
    t0 = time.perf_counter()
    out = {name: _run_table(name) for name in PACKAGES}
    print(f"runtime table on both packages: "
          f"{time.perf_counter() - t0:.1f} s")
    return out


@pytest.mark.parametrize("program", [*programs.TABLE, "local_mode"])
def test_program_gives_the_same_result_on_both_packages(table, program):
    jax_out, port_out = (table[name][program] for name in PACKAGES)
    if jax_out[0] == "raised" or port_out[0] == "raised":
        assert (jax_out[:2], port_out[:2]) == (jax_out[:2], jax_out[:2]), \
            (jax_out, port_out)
        if program == "remote_exception":
            for text in (jax_out[2], port_out[2]):
                assert "Traceback (most recent call last)" in text, text
                assert "fails_deep_inside" in text, text
                assert "ValueError: bad input 7" in text, text
        return
    assert port_out == jax_out


def test_table_outcomes_are_the_expected_ones(table):
    """The parity above would also pass if both packages were wrong in
    the same way."""
    out = table["ray_tpu_torch"]
    assert out["one_task"] == ("ok", 42)
    assert out["fifty_tasks"] == ("ok", [i * i for i in range(50)])
    assert out["shm_return"] == ("ok", (1 << 20, True, "shm"))
    assert out["ref_arguments"] == ("ok", list(range(8, 18)))
    assert out["wait_timeout"] == ("ok", (["quick"], 1, True))
    assert out["remote_exception"][:2] == ("raised", "TaskError")
    assert out["actor_state"] == ("ok", [10, 11, 13, 16, 20])
    assert out["killed_actor"][:2] == ("raised", "ActorDiedError")
    assert out["named_actor"] == ("ok", ["a", "b", "c"])
    assert out["strict_pack_group"] == ("ok", ([0, 1], 1))
    assert out["local_mode"] == ("ok", [2, [0, 1, 3, 6], "TaskError"])


@pytest.fixture(scope="module")
def port(table):
    """The port's runtime with one (logical) GPU, after the table."""
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=3, num_gpus=1)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_bf16_tensor_through_put_and_get_bit_equal(port):
    x = torch.randn(33, 65, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    x[0, :4] = torch.tensor([float("nan"), float("inf"), -0.0, 1e-40])
    ref = port.put(x)
    back = port.get(ref)
    via_task = port.get(port.remote(programs.echo).remote(ref))
    as_argument = port.get(port.remote(programs.echo).remote(x))
    for y in (back, via_task, as_argument):
        assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
        assert y.dtype == torch.bfloat16 and y.shape == x.shape
        assert torch.equal(y.view(torch.int16), x.view(torch.int16))
    p = torch.nn.Parameter(torch.arange(6.0).reshape(2, 3))
    q = port.get(port.put(p))
    assert isinstance(q, torch.nn.Parameter) and q.requires_grad
    assert torch.equal(q.detach(), p.detach())


def test_gpu_is_a_resource_and_cpu_workers_see_no_gpu(port):
    assert port.cluster_resources()["GPU"] == 1.0
    view = port.remote(programs.worker_view)
    cpu = port.get(view.remote())
    gpu = port.get(view.options(num_gpus=1).remote())
    assert cpu["cuda_visible"] == "" and cpu["gpu_ids"] == []
    assert gpu["gpu_ids"] == [0]
    # A fresh worker (its own env) that runs a task moving no tensor
    # never loads torch.
    fresh = port.get(view.options(
        runtime_env={"env_vars": {"FRESH_WORKER": "1"}}).remote())
    assert not fresh["torch"]


def test_a_second_gpu_task_waits_while_an_actor_holds_the_card(port):
    @port.remote(num_gpus=1)
    class Holder:
        def ids(self):
            return port.get_gpu_ids()
    holder = Holder.remote()
    assert port.get(holder.ids.remote()) == [0]
    assert port.available_resources().get("GPU", 0) == 0
    ref = port.remote(programs.worker_view).options(num_gpus=1).remote()
    ready, _ = port.wait([ref], timeout=1.0)
    assert not ready
    port.kill(holder)
    assert port.get(ref, timeout=60)["gpu_ids"] == [0]


def test_no_module_of_the_jax_package_in_a_worker(port):
    view = port.remote(programs.worker_view)
    for out in port.get([view.remote(), view.options(num_gpus=1).remote()]):
        assert out["ray_tpu"] == [], out["ray_tpu"]


def test_features_outside_this_slice_raise(port):
    # A client of a running head is multi-node, which the port runs
    # (tests/test_torch_cluster*.py); a process that runs a runtime
    # does not start a second one. ``bind`` builds a DAG node, which the
    # port runs (tests/test_torch_dag.py); the dashboard is ported
    # (tests/test_torch_dashboard.py), and a second init that asks for it
    # is refused as any second init is.
    from ray_tpu_torch.dag import FunctionNode
    with pytest.raises(RuntimeError, match="called twice"):
        port.init(address="auto")
    node = port.remote(programs.echo).bind(1)
    assert isinstance(node, FunctionNode)
    assert port.get(node.execute()) == 1
    with pytest.raises(RuntimeError, match="called twice"):
        port.init(include_dashboard=True)
    assert port.is_initialized()


# A container runner (``runtime_env={"container": ...}``, the runner named
# by RAY_TPU_CONTAINER_RUNNER) that holds a worker before its handshake:
# it notes its start in DIR, then, as its mode says, waits for DIR/open
# ("gate"), or exits the first time it runs ("die_once"), before it execs
# the worker command that follows the image.
RUNNER = """#!{python}
import os, sys, time
d, mode = {dir!r}, {mode!r}
args = sys.argv[1:]
i = 1
while i < len(args) and (args[i].startswith("-") or args[i - 1] == "-v"):
    i += 1
open(os.path.join(d, "started-%d" % os.getpid()), "w").close()
if mode == "gate":
    while not os.path.exists(os.path.join(d, "open")):
        time.sleep(0.01)
elif not os.path.exists(os.path.join(d, "died")):
    open(os.path.join(d, "died"), "w").close()
    sys.exit(3)
os.execvp(args[i + 1], args[i + 1:])
"""


def _runner(tmp_path, monkeypatch, mode: str) -> str:
    import stat
    import sys
    script = tmp_path / f"runner_{mode}"
    script.write_text(RUNNER.format(python=sys.executable, dir=str(tmp_path),
                                    mode=mode))
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("RAY_TPU_CONTAINER_RUNNER", str(script))
    return str(script)


def _started(tmp_path) -> int:
    return len(list(tmp_path.glob("started-*")))


def _until(cond, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while not (out := cond()):
        assert time.monotonic() < deadline, what
        time.sleep(0.02)
    return out


def _cancel_while_starting(port, tmp_path, options: dict) -> None:
    """Force-cancel a task whose worker the gated runner holds before its
    handshake; ``get`` raises TaskCancelledError, the task is dropped
    with its resources given back once (no second start meanwhile), and
    once the gate opens its body still never runs."""
    from ray_tpu_torch.core.api import get_runtime
    from ray_tpu_torch.core.exceptions import TaskCancelledError
    runtime = get_runtime()
    before = port.available_resources()
    marker = str(tmp_path / "marker")
    ref = port.remote(programs.write_marker).options(
        max_retries=3, runtime_env={"container": {"image": "held"}},
        **options).remote(marker)
    _until(lambda: _started(tmp_path) == 1, 60, "the runner starts")
    port.cancel(ref, force=True)
    with pytest.raises(TaskCancelledError):
        port.get(ref, timeout=30)
    task_id = ref.id.task_id()
    # Dropped, or started again: whichever comes first.
    _until(lambda: _started(tmp_path) > 1 or (
        task_id not in runtime._tasks
        and port.available_resources() == before), 30,
        "the cancelled task is dropped and its resources given back")
    assert _started(tmp_path) == 1, "the cancelled task started again"
    (tmp_path / "open").touch()
    # The resources serve the next task of the same shape.
    view = port.remote(programs.worker_view).options(**options)
    assert port.get(view.remote(), timeout=60)["gpu_ids"] == \
        ([0] if options.get("num_gpus") else [])
    assert _started(tmp_path) == 1 and not os.path.exists(marker)
    assert port.available_resources() == before


def test_a_task_cancelled_while_its_worker_starts_never_runs(
        port, tmp_path, monkeypatch):
    """``cancel(force=True)`` while the task's worker has not connected
    (the runner holds it): the dispatch that then fails must not queue
    the task again, as it queues a task whose worker died on its own.
    On a ``num_gpus=1`` task, so that the card's hold is given back too."""
    _runner(tmp_path, monkeypatch, "gate")
    _cancel_while_starting(port, tmp_path, {"num_gpus": 1})


def test_a_task_cancelled_while_its_daemon_worker_starts_never_runs(
        port, tmp_path, monkeypatch):
    """The same window on a node daemon's worker: the head's kill reaches
    the daemon, which reports the worker's exit; that task is CANCELLED,
    so it is dropped, never retried."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.api import get_runtime
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )
    _runner(tmp_path, monkeypatch, "gate")
    cluster = Cluster(initialize_head=False)
    cluster._rt = get_runtime()        # the daemon joins this runtime
    node = cluster.add_node(num_cpus=1)
    try:
        _cancel_while_starting(port, tmp_path, {
            "scheduling_strategy": NodeAffinitySchedulingStrategy(
                node.node_id, soft=False)})
    finally:
        cluster.remove_node(node)


def test_a_task_cancelled_once_taken_from_the_queue_never_starts(port):
    """``cancel(force=True)`` after the dispatcher took the task from the
    queue and before it picked a worker: nothing was running, yet the
    task must end CANCELLED, start on no worker, and give back what its
    placement acquired."""
    import threading

    from ray_tpu_torch.core.api import get_runtime
    from ray_tpu_torch.core.exceptions import TaskCancelledError
    runtime = get_runtime()
    before = port.available_resources()
    test_thread = threading.current_thread()
    taken, go = threading.Event(), threading.Event()
    take = runtime._take_worker

    def held(*args, **kwargs):
        if threading.current_thread() is not test_thread:
            taken.set()
            go.wait(30)
        return take(*args, **kwargs)
    view = port.remote(programs.worker_view)
    runtime._take_worker = held
    try:
        # An env no idle worker has: the dispatcher thread takes it.
        ref = view.options(num_gpus=1, runtime_env={
            "env_vars": {"TAKEN_FROM_QUEUE": "1"}}).remote()
        assert taken.wait(30), "the dispatcher takes the task"
        runtime._take_worker = take
        port.cancel(ref, force=True)
    finally:
        runtime._take_worker = take
        go.set()
    with pytest.raises(TaskCancelledError):
        port.get(ref, timeout=30)
    _until(lambda: ref.id.task_id() not in runtime._tasks
           and port.available_resources() == before, 30,
           "the cancelled task is dropped and its resources given back")
    assert port.get(view.options(num_gpus=1).remote(),
                    timeout=60)["gpu_ids"] == [0]


def test_a_worker_that_dies_before_its_handshake_is_retried(
        port, tmp_path, monkeypatch):
    """With no cancel, a worker that exits before it connects is a failed
    attempt, retried as before."""
    _runner(tmp_path, monkeypatch, "die_once")
    marker = str(tmp_path / "marker")
    before = port.available_resources()
    ref = port.remote(programs.write_marker).options(
        max_retries=1, runtime_env={"container": {"image": "dies"}}
    ).remote(marker)
    assert port.get(ref, timeout=60) == marker
    assert _started(tmp_path) == 2 and os.path.exists(marker)
    _until(lambda: port.available_resources() == before, 30,
           "the resources come back")


def test_force_cancels_racing_dispatch_lose_no_task_and_no_resource(
        port, tmp_path):
    """Stress: 24 tasks on 3 CPUs (queued, taken, their workers starting,
    running behind a gate, or riding a lease) and 12 of them force-
    cancelled from 4 threads at staggered moments, with a short switch
    interval. Every cancelled task raises TaskCancelledError and its body
    never runs to its end, also after the gate opens; every other task
    returns its value; the resources come back to their totals, as a
    release missed or made twice would not."""
    import sys
    import threading

    from ray_tpu_torch.core.exceptions import TaskCancelledError
    before = port.available_resources()
    task = port.remote(programs.gated_marks).options(max_retries=5)
    refs = [task.remote(str(tmp_path), i) for i in range(24)]
    doomed = list(range(0, 24, 2))
    errors: list = []

    def canceller(k: int) -> None:
        try:
            for j, i in enumerate(doomed[k::4]):
                time.sleep((0.0, 0.005, 0.05, 0.4)[(j + k) % 4])
                port.cancel(refs[i], force=True)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=canceller, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads) and not errors, errors
    finally:
        sys.setswitchinterval(interval)
    for i in doomed:
        with pytest.raises(TaskCancelledError):
            port.get(refs[i], timeout=60)
    (tmp_path / "open").touch()
    kept = [i for i in range(24) if i not in doomed]
    assert port.get([refs[i] for i in kept], timeout=120) == kept
    _until(lambda: port.available_resources() == before, 60,
           "the resources come back to their totals")
    done = {int(p.name.split("-")[1]) for p in tmp_path.glob("done-*")}
    assert done == set(kept), sorted(done & set(doomed))


def test_init_counts_gpus_without_torch(monkeypatch):
    """The scheduler's count reads the override, CUDA_VISIBLE_DEVICES,
    then NVML (a stand-in library here); it imports nothing."""
    import ctypes
    import types

    from ray_tpu_torch.core import accelerator as acc
    monkeypatch.delenv(acc.GPU_COUNT_ENV, raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)

    def no_driver(name):
        raise OSError(f"{name}: cannot open shared object file")

    def count_three(ptr):
        ptr._obj.value = 3
        return 0
    fake = types.SimpleNamespace(
        nvmlInit_v2=lambda: 0, nvmlShutdown=lambda: 0,
        nvmlDeviceGetCount_v2=count_three)
    monkeypatch.setattr(ctypes, "CDLL", no_driver)
    assert acc.detect_gpu_count() == 0
    monkeypatch.setattr(ctypes, "CDLL", lambda name: fake)
    assert acc.detect_gpu_count() == 3
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,3")
    assert acc.detect_gpu_count() == 3
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1,-1,2")
    assert acc.detect_gpu_count() == 1
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert acc.detect_gpu_count() == 0 and acc.get_gpu_ids() == []
    monkeypatch.setenv(acc.GPU_COUNT_ENV, "2")
    assert acc.get_gpu_ids() == [0, 1]


def test_tensor_reducer_keeps_dtype_shape_and_bits():
    """Every dtype torch pickles densely, through the port's serializer
    (no runtime needed)."""
    from ray_tpu_torch.core import serialization as ser
    gen = torch.Generator().manual_seed(1)
    base = torch.randn(3, 5, 7, generator=gen)
    for dtype in (torch.float32, torch.float16, torch.bfloat16,
                  torch.float64, torch.int8, torch.int64, torch.uint8,
                  torch.bool, torch.complex64):
        x = base.to(dtype) if dtype != torch.complex64 else \
            torch.complex(base, -base)
        x = x.transpose(0, 2)                 # not contiguous
        y = ser.deserialize(ser.serialize({"t": x}))["t"]
        assert y.dtype == dtype and y.shape == x.shape
        assert torch.equal(y, x), dtype
    scalar = ser.deserialize(ser.serialize(torch.tensor(3.5)))
    assert scalar.shape == () and float(scalar) == 3.5
    empty = ser.deserialize(ser.serialize(torch.zeros(0, 4)))
    assert empty.shape == (0, 4)
    obj = ser.serialize(np.zeros(1 << 16, np.uint8))
    assert obj.buffers, "numpy still travels out of band"
    # Task arguments (ser.dumps) travel as host bits too, never through
    # torch's own pickling, which rebuilds a CUDA tensor on its card.
    args = ser.dumps(((base.to(torch.bfloat16),), {}))
    assert b"_tensor_from_parts" in args
    (y,), _ = ser.loads(args)
    assert torch.equal(y.view(torch.int16),
                       base.to(torch.bfloat16).view(torch.int16))


_GC_IN_REF_LOCK_CHILD = r"""
import gc, threading
import ray_tpu_torch as rt
from ray_tpu_torch.core.api import get_runtime
rt.init(num_cpus=1)
runtime = get_runtime()
ref = rt.put(41)
oid = ref.id
box = [ref]
box.append(box)        # the only way left to the ref is a cycle
del ref, box
done = threading.Event()

def holder():
    # A collection while this thread holds the lock: the ref's
    # finalizer runs here, as one inside register_ref would.
    with runtime._ref_lock:
        gc.collect()
    done.set()

t = threading.Thread(target=holder, daemon=True)
t.start()
t.join(20)
assert done.is_set(), "the thread holding _ref_lock waited on itself"
assert oid not in runtime._refcounts, "the deferred decrement was lost"
assert rt.get(rt.put(1) , timeout=30) == 1
rt.shutdown()
print("OK")
"""


def test_a_collection_inside_the_ref_lock_does_not_deadlock():
    """``ObjectRef.__del__`` takes the reference-count lock; a garbage
    collection inside a region that holds it ran the finalizer on the
    holder, which then waited on itself and every later submit on it.
    The decrement is deferred to the lock's release and applied then. In a process of its own: a deadlock would hold the
    lock for the rest of the process."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _GC_IN_REF_LOCK_CHILD], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
