"""The port's top-level names (``ray_tpu_torch.__all__``) against the JAX
package's, and the behaviours of tests/test_toplevel_compat.py.

``ray_tpu_torch.__all__`` holds every name of ``ray_tpu.__all__`` but
one: ``get_tpu_ids``, whose counterpart is ``get_gpu_ids``. Every
subpackage the JAX package resolves lazily resolves on the port. The
programs below (id families, worker-mode constants, the generator
alias, ``Language`` and the Java stubs, ``cpp_function``,
``LoggingConfig`` in JSON and through the environment,
``show_in_dashboard``, ``init``'s reference keywords, ``client()``) run
once on each package and are compared exactly.
"""

from __future__ import annotations

import importlib
import json
import logging
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import torch_ops_programs
from torch_parity import table_run

PACKAGES = ("ray_tpu", "ray_tpu_torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def test_all_holds_the_jax_packages_names_but_get_tpu_ids():
    import ray_tpu
    import ray_tpu_torch
    missing = set(ray_tpu.__all__) - set(ray_tpu_torch.__all__)
    assert missing == {"get_tpu_ids"}
    assert "get_gpu_ids" in ray_tpu_torch.__all__
    for name in ray_tpu_torch.__all__:
        assert hasattr(ray_tpu_torch, name), name


def test_every_subpackage_of_the_jax_package_resolves():
    import ray_tpu
    import ray_tpu_torch
    assert set(ray_tpu._SUBPACKAGES) <= set(ray_tpu_torch._SUBPACKAGES)
    for name in ray_tpu._SUBPACKAGES:
        mod = getattr(ray_tpu_torch, name)
        assert mod.__name__ == f"ray_tpu_torch.{name}"


def test_ops_exports_the_sequence_parallel_routes():
    from ray_tpu_torch import ops
    from ray_tpu_torch.ops import attention
    for name in ("ring_attention", "ulysses_attention",
                 "make_sharded_causal_attention"):
        assert name in ops.__all__
        assert getattr(ops, name) is getattr(attention, name)


def id_families(rt):
    uid = rt.UniqueID(os.urandom(rt.UniqueID.SIZE))
    return [issubclass(rt.WorkerID, rt.UniqueID), isinstance(uid, bytes),
            len({uid, uid}),
            [hasattr(rt, n) for n in (
                "ActorClassID", "ActorID", "FunctionID", "JobID", "NodeID",
                "ObjectID", "PlacementGroupID", "TaskID")],
            {n: getattr(rt, n).SIZE for n in (
                "ActorID", "JobID", "NodeID", "ObjectID", "TaskID",
                "UniqueID")}]


def mode_constants_and_generator_alias(rt):
    return [(rt.SCRIPT_MODE, rt.WORKER_MODE, rt.LOCAL_MODE),
            rt.DynamicObjectRefGenerator is rt.ObjectRefGenerator]


def language_and_java_stubs(rt):
    out = [rt.Language.CPP.value]
    for call in (lambda: rt.java_function("a.B", "f"),
                 lambda: rt.java_actor_class("a.B")):
        try:
            call()
        except NotImplementedError as e:
            out.append("N30" in str(e))
    return out


def cpp_function(rt):
    cpp = importlib.import_module(f"{rt.__name__}.cpp")
    path = cpp.compile_library(r"""
    #include "ray_tpu.h"
    static raytpu::Bytes twice(const raytpu::Args& a) {
      return raytpu::bytes_of(2 * raytpu::as<int64_t>(a[0]));
    }
    RAY_TPU_TASK(twice);
    RAY_TPU_MODULE();
    """)
    rt.init(num_cpus=2)
    try:
        fn = rt.cpp_function(path, "twice")
        return cpp.to_i64(rt.get(fn.remote(21)))
    finally:
        os.unlink(path)


def logging_config_json(rt):
    import io
    buf = io.StringIO()
    rt.LoggingConfig(encoding="JSON", log_level="DEBUG")._apply()
    lg = logging.getLogger("ray_tpu")
    try:
        for h in lg.handlers:
            h.setStream(buf)
        logging.getLogger("ray_tpu.test").debug("structured hello")
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        return [rec["message"], rec["levelname"]]
    finally:
        lg.handlers = []
        lg.propagate = True


def logging_config_validation_and_env_roundtrip(rt):
    out = []
    try:
        rt.LoggingConfig(encoding="YAML")
    except ValueError as e:
        out.append("encoding" in str(e))
    cfg = rt.LoggingConfig(encoding="JSON", log_level="WARNING",
                           additional_log_standard_attrs=["lineno"])
    cfg._export_env()
    try:
        importlib.import_module(
            f"{rt.__name__}.core.logging_config").apply_from_env()
        lg = logging.getLogger("ray_tpu")
        out += [lg.level == logging.WARNING,
                any(getattr(h, "_ray_tpu_cfg", False) for h in lg.handlers)]
    finally:
        for k in ("RAY_TPU_LOG_ENCODING", "RAY_TPU_LOG_LEVEL",
                  "RAY_TPU_LOG_EXTRA_ATTRS"):
            os.environ.pop(k, None)
        logging.getLogger("ray_tpu").handlers = []
        logging.getLogger("ray_tpu").propagate = True
    return out


def show_in_dashboard(rt):
    rt.init(num_cpus=1)
    rt.show_in_dashboard("training step 7", key="phase")
    kv = importlib.import_module(f"{rt.__name__}.experimental.internal_kv")
    return kv._kv_get(f"worker_msg:{os.getpid()}|phase",
                      namespace="dashboard")


_CLIENT = textwrap.dedent("""
    import importlib, os, sys
    rt = importlib.import_module(sys.argv[2])
    try:
        rt.client(sys.argv[1]).namespace("n1")
        raise SystemExit("namespace should raise")
    except NotImplementedError:
        pass
    ctx = rt.client(sys.argv[1]).env(
        {"env_vars": {"BUILDER_ENV_PROBE": "e42"}}).connect()
    @rt.remote
    def f():
        return 7
    assert rt.get(f.remote()) == 7
    @rt.remote
    def probe_env():
        return os.environ.get("BUILDER_ENV_PROBE")
    assert rt.get(probe_env.remote()) == "e42"
    ctx.disconnect()
    assert not rt.is_initialized()
    print("BUILDER_OK")
""")


def client_builder(rt):
    rt.init(num_cpus=2)
    out = subprocess.run(
        [sys.executable, "-c", _CLIENT, rt.client_address(), rt.__name__],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return [out.returncode, "BUILDER_OK" in out.stdout]


_INIT = textwrap.dedent("""
    import importlib, sys, urllib.request, warnings
    rt = importlib.import_module(sys.argv[1])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        rt.init(num_cpus=2, num_gpus=2, object_store_memory=32 << 20,
                namespace="nsX", include_dashboard=True, dashboard_port=0)
        assert any("namespace" in str(x.message) for x in w)
    try:
        assert rt.cluster_resources().get("GPU") == 2.0
        cfg = importlib.import_module(sys.argv[1] + ".core.config")
        assert cfg.get_config().object_store_memory == 32 << 20
        dash = importlib.import_module(
            sys.argv[1] + ".core.api").get_runtime()._dashboard
        assert dash is not None and dash.port > 0
        body = urllib.request.urlopen(
            "http://127.0.0.1:%d/api/nodes" % dash.port, timeout=10).read()
        assert body.startswith(b"[") or body.startswith(b"{")
    finally:
        rt.shutdown()
    print("INIT_KWARGS_OK")
""")


def init_reference_kwargs(rt):
    out = subprocess.run(
        [sys.executable, "-c", _INIT, rt.__name__], capture_output=True,
        text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return [out.returncode, "INIT_KWARGS_OK" in out.stdout,
            out.stderr[-1500:] if out.returncode else ""]


PROGRAMS = {f.__name__: f for f in (
    id_families, mode_constants_and_generator_alias,
    language_and_java_stubs, cpp_function, logging_config_json,
    logging_config_validation_and_env_roundtrip, show_in_dashboard,
    client_builder, init_reference_kwargs)}
EXPECTED = {
    "mode_constants_and_generator_alias": [(0, 1, 2), True],
    "language_and_java_stubs": [2, True, True],
    "cpp_function": 42,
    "logging_config_json": ["structured hello", "DEBUG"],
    "logging_config_validation_and_env_roundtrip": [True, True, True],
    "show_in_dashboard": b"training step 7",
    "client_builder": [0, True],
    "init_reference_kwargs": [0, True, ""],
}


@pytest.fixture(scope="module")
def table() -> dict:
    out = {}
    for name in PACKAGES:
        rt = importlib.import_module(name)
        with table_run(name):
            out[name] = {prog: torch_ops_programs.run(fn, rt)
                         for prog, fn in PROGRAMS.items()}
    return out


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_program_gives_the_same_result_on_both_packages(table, program):
    jax_out, port_out = (table[name][program] for name in PACKAGES)
    assert jax_out[0] == "ok", jax_out
    if program in EXPECTED:
        assert jax_out == ("ok", EXPECTED[program])
    assert port_out == jax_out
