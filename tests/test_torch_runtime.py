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
``init``, ``address`` or not, in a process that runs a runtime).
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import pytest
import torch

import torch_runtime_programs as programs

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
