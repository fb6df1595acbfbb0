"""C++ tasks and actors (``ray_tpu_torch.cpp``, ``cpp_function``) against
the JAX package's (``ray_tpu.cpp``).

The 11 tests of tests/test_cpp_api.py run as programs once on
``ray_tpu`` and once on ``ray_tpu_torch``, each package compiling the
same source against its own ``ray_tpu.h`` and running it in its own
runtime of 2 CPUs; outcomes are compared exactly. Beyond them: the two
headers carry the same macros and C ABI (only their comments differ),
so a library compiled against the JAX package's header runs unchanged
under the port, and the port's ``compile_library`` writes under the
port's temporary directory.
"""

from __future__ import annotations

import importlib
import os

import pytest
import torch

import torch_ops_programs
from torch_parity import table_run

PACKAGES = ("ray_tpu", "ray_tpu_torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CPP_SOURCE = r"""
#include "ray_tpu.h"
#include <numeric>

using raytpu::Args;
using raytpu::Bytes;

static Bytes add(const Args& a) {
  return raytpu::bytes_of(raytpu::as<double>(a[0]) +
                          raytpu::as<double>(a[1]));
}
RAY_TPU_TASK(add);

// Operates on a raw byte buffer (the numpy-array path).
static Bytes sum_u8(const Args& a) {
  int64_t s = 0;
  for (unsigned char c : a[0]) s += c;
  return raytpu::bytes_of(s);
}
RAY_TPU_TASK(sum_u8);

static Bytes shout(const Args& a) {
  std::string s(a[0]);
  for (auto& c : s) c = toupper(c);
  return s;
}
RAY_TPU_TASK(shout);

static Bytes fail(const Args&) {
  throw std::runtime_error("deliberate C++ failure");
}
RAY_TPU_TASK(fail);

class Counter {
  int64_t n_ = 0;
 public:
  explicit Counter(const Args& a) {
    if (!a.empty()) n_ = raytpu::as<int64_t>(a[0]);
  }
  Bytes add(const Args& a) {
    n_ += raytpu::as<int64_t>(a[0]);
    return raytpu::bytes_of(n_);
  }
  Bytes get(const Args&) { return raytpu::bytes_of(n_); }
};
RAY_TPU_ACTOR(Counter);
RAY_TPU_METHOD(Counter, add);
RAY_TPU_METHOD(Counter, get);

RAY_TPU_MODULE();
"""

SRC2 = r"""
#include "ray_tpu.h"
static raytpu::Bytes only2(const raytpu::Args&) { return "2"; }
RAY_TPU_TASK(only2);
RAY_TPU_MODULE();
"""

GHOST = r"""
#include "ray_tpu.h"
using raytpu::Args; using raytpu::Bytes;
class Ghost {
 public:
  explicit Ghost(const Args&) {}
  Bytes go(const Args&) { return "x"; }
};
RAY_TPU_METHOD(Ghost, go);
RAY_TPU_MODULE();
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _no_process_left():
    yield
    assert torch_ops_programs.processes_left() == []


def enumeration(rt, cpp, lib):
    return [lib.task_names, lib.actor_names, lib.methods("Counter")]


def local_invocation(rt, cpp, lib):
    return cpp.to_f64(lib.add(1.5, 2.0))


def remote_task(rt, cpp, lib):
    ref = lib.add.remote(cpp.f64(1.5), cpp.f64(2.25))
    return [cpp.to_f64(rt.get(ref)),
            cpp.to_f64(rt.get(lib.add.remote(1.0, 2.0)))]


def remote_task_numpy_buffer(rt, cpp, lib):
    import numpy as np
    arr = np.arange(100, dtype=np.uint8)
    return [cpp.to_i64(rt.get(lib.sum_u8.remote(arr))), int(arr.sum())]


def remote_task_str(rt, cpp, lib):
    return rt.get(lib.shout.remote("tpu"))


def cpp_exception_propagates(rt, cpp, lib):
    try:
        rt.get(lib.fail.remote())
    except Exception as e:  # noqa: BLE001
        return "deliberate C++ failure" in str(e)
    return "no error"


def unknown_task(rt, cpp, lib):
    try:
        lib.task("nope")
    except AttributeError as e:
        return "no C++ task" in str(e)
    return "no error"


def cpp_actor(rt, cpp, lib):
    Counter = lib.actor_class("Counter")
    c = Counter.remote(cpp.i64(10))
    return [cpp.to_i64(rt.get(c.add.remote(cpp.i64(5)))),
            cpp.to_i64(rt.get(c.add.remote(7))),
            cpp.to_i64(rt.get(c.get.remote()))]


def two_libraries_isolated_registries(rt, cpp, lib):
    path = cpp.compile_library(SRC2)
    try:
        lib2 = cpp.load_library(path)
        return [lib2.task_names, lib2.actor_names, lib.task_names,
                lib2.only2()]
    finally:
        os.unlink(path)


def method_without_actor_is_catchable(rt, cpp, lib):
    path = cpp.compile_library(GHOST)
    try:
        ghost = cpp.load_library(path)
        try:
            cpp._actor_new(ghost.path, "Ghost", ())
        except cpp.CppError as e:
            return [ghost.actor_names, "RAY_TPU_ACTOR" in str(e)]
        return "no error"
    finally:
        os.unlink(path)


def cpp_actor_independent_instances(rt, cpp, lib):
    Counter = lib.actor_class("Counter")
    a, b = Counter.remote(), Counter.remote(cpp.i64(100))
    rt.get(a.add.remote(1))
    return [cpp.to_i64(rt.get(a.get.remote())),
            cpp.to_i64(rt.get(b.get.remote()))]


PROGRAMS = {f.__name__: f for f in (
    enumeration, local_invocation, remote_task, remote_task_numpy_buffer,
    remote_task_str, cpp_exception_propagates, unknown_task, cpp_actor,
    two_libraries_isolated_registries, method_without_actor_is_catchable,
    cpp_actor_independent_instances)}
EXPECTED = {
    "enumeration": [["add", "sum_u8", "shout", "fail"], ["Counter"],
                    ["add", "get"]],
    "local_invocation": 3.5,
    "remote_task": [3.75, 3.0],
    "remote_task_numpy_buffer": [4950, 4950],
    "remote_task_str": b"TPU",
    "cpp_exception_propagates": True,
    "unknown_task": True,
    "cpp_actor": [15, 22, 22],
    "two_libraries_isolated_registries": [
        ["only2"], [], ["add", "sum_u8", "shout", "fail"], b"2"],
    "method_without_actor_is_catchable": [[], True],
    "cpp_actor_independent_instances": [1, 100],
}


@pytest.fixture(scope="module")
def table() -> dict:
    """{package: {program: outcome}}: each package compiles the source
    against its own header and runs every program in one runtime."""
    out = {}
    for name in PACKAGES:
        rt = importlib.import_module(name)
        cpp = importlib.import_module(f"{name}.cpp")
        path = cpp.compile_library(CPP_SOURCE)
        with table_run(name):
            rt.init(num_cpus=2)
            try:
                lib = cpp.load_library(path)
                res = {}
                for prog, fn in PROGRAMS.items():
                    try:
                        res[prog] = ("ok", fn(rt, cpp, lib))
                    except Exception as e:  # noqa: BLE001
                        res[prog] = ("raised", type(e).__name__, str(e))
                out[name] = res
            finally:
                rt.shutdown()
                os.unlink(path)
    return out


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_program_gives_the_same_result_on_both_packages(table, program):
    jax_out, port_out = (table[name][program] for name in PACKAGES)
    assert jax_out == ("ok", EXPECTED[program]), jax_out
    assert port_out == jax_out


def _code(path: str) -> list[str]:
    """A header's lines that are not comments."""
    with open(path) as f:
        return [ln for ln in f.read().splitlines()
                if not ln.lstrip().startswith("//")]


def test_the_headers_carry_the_same_macros_and_abi():
    assert _code(os.path.join(REPO, "ray_tpu", "cpp", "ray_tpu.h")) == \
        _code(os.path.join(REPO, "ray_tpu_torch", "cpp", "ray_tpu.h"))


def test_a_library_built_against_the_jax_header_runs_under_the_port():
    import ray_tpu_torch as rt
    from ray_tpu import cpp as jax_cpp
    from ray_tpu_torch import cpp
    path = jax_cpp.compile_library(CPP_SOURCE)
    rt.init(num_cpus=2)
    try:
        lib = cpp.load_library(path)
        assert lib.task_names == ["add", "sum_u8", "shout", "fail"]
        assert cpp.to_f64(rt.get(lib.add.remote(1.5, 2.25))) == 3.75
        Counter = lib.actor_class("Counter")
        c = Counter.remote(cpp.i64(10))
        assert cpp.to_i64(rt.get(c.add.remote(5))) == 15
        fn = rt.cpp_function(path, "shout")
        assert rt.get(fn.remote("gpu")) == b"GPU"
    finally:
        rt.shutdown()
        os.unlink(path)


def test_compile_library_writes_under_the_ports_temporary_directory():
    from ray_tpu_torch import cpp
    from ray_tpu_torch.core.config import temp_path
    path = cpp.compile_library(SRC2)
    try:
        assert os.path.dirname(path) == temp_path("ray_tpu_torch_cpp")
        assert cpp.load_library(path).only2() == b"2"
    finally:
        os.unlink(path)


def test_java_entry_points_raise():
    import ray_tpu_torch as rt
    assert [m.name for m in rt.Language] == ["PYTHON", "JAVA", "CPP"]
    with pytest.raises(NotImplementedError, match="no Java worker"):
        rt.java_function("C", "f")
    with pytest.raises(NotImplementedError, match="no Java worker"):
        rt.java_actor_class("C")
