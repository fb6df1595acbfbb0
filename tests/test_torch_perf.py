"""The port's core microbenchmarks (``ray_tpu_torch.perf``) against the
JAX package's (``ray_tpu/perf.py``).

``perf.run_all(quick=True)`` runs on the port in a process of its own,
in a runtime of 4 CPUs as the JAX package's ``test_microbench_floors``
runs it (not the harness's own 8, which loads a shared host more), and
that process loads no torch (the harness is host code; the prefetch row runs the
port's ``DevicePrefetcher`` with ``place=None``, host only). Every row
carries a metric of ``METRICS``, the JAX package's names and units
(taken from its source below), once each, with a finite value. Values
are positive, but for the two rows that the JAX harness clamps at 0 (an
overhead that the run's noise can hide): ``heartbeat_overhead`` and
``profiler_sampling_overhead``, which are at least 0.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX package's rows (ray_tpu/perf.py run_all), name: unit.
METRICS = {
    "host_memcpy_gigabytes": "GiB/s",
    "host_memcpy_aggregate_gigabytes": "GiB/s",
    "prefetch_handoff_overhead": "us/batch",
    "single_client_tasks_sync": "calls/s",
    "single_client_tasks_async": "calls/s",
    "1_1_actor_calls_sync": "calls/s",
    "1_1_actor_calls_async": "calls/s",
    "1_1_async_actor_calls_async": "calls/s",
    "n_n_actor_calls_async": "calls/s",
    "n_n_async_actor_calls_async": "calls/s",
    "actor_calls_direct_1_1": "calls/s",
    "actor_calls_head_routed_1_1": "calls/s",
    "actor_calls_direct_n_n": "calls/s",
    "actor_call_inline_small_args": "calls/s",
    "heartbeat_overhead": "us/roundtrip",
    "multi_client_tasks_async": "calls/s",
    "single_client_wait_1k_refs": "calls/s",
    "single_client_get_object_containing_10k_refs": "calls/s",
    "single_client_put_calls_1KiB": "calls/s",
    "single_client_get_calls_256KiB": "calls/s",
    "single_client_put_100MiB_calls": "calls/s",
    "single_client_put_gigabytes": "GiB/s",
    "multi_client_put_gigabytes": "GiB/s",
    "multi_client_put_calls_1KiB": "calls/s",
    "fanin_get_64x1MiB_serial": "GiB/s",
    "fanin_get_64x1MiB_batched": "GiB/s",
    "fanin_get_wire_64x1MiB_serial": "GiB/s",
    "fanin_get_wire_64x1MiB_batched": "GiB/s",
    "repeated_get_64MiB_cached": "calls/s",
    "repeated_get_64MiB_cache_hits": "hits",
    "drain_node_64_tasks": "s",
    "metrics_flush_overhead": "flushes/s",
    "task_submit_instrumented": "calls/s",
    "task_submit_uninstrumented": "calls/s",
    "memory_summary_1k_objects": "calls/s",
    "profiler_sampling_overhead": "%",
    "trace_assembly_1k_spans": "assemblies/s",
    "signals_ingest_overhead": "samples/s",
    "slo_eval_1k_rules": "evals/s",
    "actors_create_call_100": "actors/s",
    "task_drain_5k": "tasks/s",
    "pg_create_50": "pgs/s",
}
CLAMPED_AT_ZERO = {"heartbeat_overhead", "profiler_sampling_overhead"}

_RUN = """
import json, sys
import ray_tpu_torch
from ray_tpu_torch import perf
ray_tpu_torch.init(num_cpus=4)
try:
    rows = perf.run_all(quick=True)
finally:
    ray_tpu_torch.shutdown()
print("ROWS" + json.dumps(rows))
print("TORCH" + json.dumps("torch" in sys.modules))
"""


def test_metrics_are_the_jax_harness_rows():
    """Each name of METRICS is one of the JAX harness's rows, with its
    unit, and the harness has no other (its f-string rows expanded)."""
    with open(os.path.join(REPO, "ray_tpu", "perf.py")) as f:
        src = f.read().split("def run_serve_bench")[0]
    literal = set(re.findall(r'"metric": "(\w+)"', src))
    literal |= set(re.findall(r'timeit\(\s*"(\w+)"', src))
    literal |= set(re.findall(r'_direct_bench\(\s*"(\w+)"', src))
    fanin = {f"fanin_get_{tag}64x1MiB_{kind}" for tag in ("", "wire_")
             for kind in ("serial", "batched")}
    assert "fanin_get_{tag}{fanin_n}x{fanin_mib}MiB_serial" in src
    assert literal | fanin == set(METRICS)
    for name, unit in METRICS.items():
        if unit not in ("calls/s",):
            assert f'"{unit}"' in src, (name, unit)


@pytest.fixture(scope="module")
def rows() -> tuple[list, bool]:
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _RUN], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    got = json.loads(next(x for x in lines if x.startswith("ROWS"))[4:])
    torch_loaded = json.loads(next(
        x for x in lines if x.startswith("TORCH"))[5:])
    return got, torch_loaded


def test_the_port_gives_every_row_with_the_jax_name_and_unit(rows):
    got, _ = rows
    assert [r["metric"] for r in got] == list(METRICS)
    assert {r["metric"]: r["unit"] for r in got} == METRICS


def test_every_value_is_finite_and_positive(rows):
    got, _ = rows
    for r in got:
        assert math.isfinite(r["value"]), r
        if r["metric"] in CLAMPED_AT_ZERO:
            assert r["value"] >= 0, r
        else:
            assert r["value"] > 0, r


def test_the_harness_loads_no_torch(rows):
    assert rows[1] is False


def test_the_serve_rows_are_the_jax_harness_rows():
    """``run_serve_bench``'s rows (not run here: it starts two HTTP
    proxies and a chaos soak) under the JAX names."""
    srcs = []
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        with open(os.path.join(REPO, pkg, "perf.py")) as f:
            srcs.append(f.read().split("def run_serve_bench")[1])
    names = [set(re.findall(r'(?:"metric": |timeit\(\s*)"(\w+)"', s))
             for s in srcs]
    assert names[0] == names[1] == {
        "serve_requests_per_s", "serve_proxy_echo",
        "serve_proxy_echo_noretry", "serve_soak_p99"}
