"""The port's dashboard (``ray_tpu_torch.dashboard``: the HTTP head and
its page, the system metrics, the Prometheus and Grafana files) against
the JAX package's.

The ``DASHBOARD`` table of tests/torch_ops_programs.py runs once on
``ray_tpu`` and once on ``ray_tpu_torch``, each program with a runtime
of its own:

- every ``GET`` route after one finished task and one named actor: its
  status and the keys of its JSON, one level into its rows, equal on
  both packages once the node table's ``tpu_chips`` is read as ``gpus``
  (the port's ``NodeAgent`` reports cards);
- the ``ray_tpu_*`` gauge names on ``/metrics`` (the port keeps the JAX
  package's names, so one Grafana board reads either);
- the Prometheus and Grafana files, equal but for the package's name;
- the logs API (list, tail, a traversal clamped);
- a node daemon's agent samples on ``/api/agents`` and ``/simple``;
- Serve's REST deploy, ``PUT /api/serve/applications`` (the JAX
  package's ``test_rest_deploy_api``).

On the port alone: the node table's ``gpus`` column carries a node's
cards, on ``/api/agents``, ``/simple`` and the page's table.
"""

from __future__ import annotations

import json
import time
import urllib.request

import pytest
import torch

import torch_ops_programs as programs

PACKAGES = ("ray_tpu", "ray_tpu_torch")
PROGRAMS = list(programs.DASHBOARD)


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
    assert programs.processes_left() == []


@pytest.fixture(scope="module")
def table() -> dict:
    """{package: {program: outcome}}, the JAX package's run first."""
    return {name: programs.run_table(name, programs.DASHBOARD)
            for name in PACKAGES}


def _as_port(program: str, outcome: tuple) -> tuple:
    """The JAX package's outcome with its node table's ``tpu_chips``
    read as the port's ``gpus``."""
    if program != "route_shapes" or outcome[0] != "ok":
        return outcome
    out = json.loads(json.dumps(outcome[1]))
    head = out["/api/agents"][1]["head"]
    out["/api/agents"][1]["head"] = sorted(
        "gpus" if k == "tpu_chips" else k for k in head)
    return ("ok", out)


@pytest.mark.parametrize("program", PROGRAMS)
def test_program_gives_the_same_result_on_both_packages(table, program):
    jax_out, port_out = (table[name][program] for name in PACKAGES)
    assert jax_out[0] == "ok", jax_out
    assert port_out == _as_port(program, jax_out)


def test_every_get_route_answers(table):
    shapes = table["ray_tpu_torch"]["route_shapes"][1]
    for route in programs.GET_ROUTES:
        assert shapes[route][0] == 200, (route, shapes[route])
    assert shapes["/api/v1/traces/<unknown>"][0] == 404
    assert shapes["/api/<unknown>"] == [404, {"error": "not found"}]
    assert shapes["/"] == shapes["/simple"] == [200, True]
    assert "gpus" in shapes["/api/agents"][1]["head"]


def test_system_gauges_are_on_metrics(table):
    code, names = table["ray_tpu_torch"]["system_gauges"][1]
    assert code == 200
    for name in ("ray_tpu_nodes_alive", "ray_tpu_workers_total",
                 "ray_tpu_object_store_bytes", "ray_tpu_tasks_pending",
                 "ray_tpu_tasks_running", "ray_tpu_actors_alive",
                 "ray_tpu_head_queue_depth"):
        assert name in names


def test_metrics_config_names_the_port(tmp_path):
    from ray_tpu_torch.dashboard.metrics_config import (
        generate_metrics_configs,
    )
    paths = generate_metrics_configs(str(tmp_path), ["127.0.0.1:8265"])
    assert paths["datasource"].endswith(
        "grafana/provisioning/datasources/ray_tpu_torch.yml")
    with open(paths["dashboard"]) as f:
        board = json.load(f)
    assert board["title"] == "ray_tpu_torch cluster"
    assert "ray_tpu_tasks_running" in {
        t["expr"] for p in board["panels"] for t in p["targets"]}
    with open(paths["targets"]) as f:
        assert json.load(f) == [{"targets": ["127.0.0.1:8265"],
                                 "labels": {"job": "ray_tpu_torch"}}]


def test_logs_api(table):
    assert table["ray_tpu_torch"]["logs_api"] == ("ok", [
        True, True, True, ["content", "file", "offset", "size",
                           "truncated"], True])


def test_node_table_carries_each_nodes_cards():
    """A node daemon holding card 0 reports ``gpus`` 1 beside the head's
    own row (0 cards); ``/simple`` and the page show the column."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.api import get_runtime
    from ray_tpu_torch.dashboard import start_dashboard
    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 1, "num_gpus": 0})
    try:
        nb = c.add_node(num_cpus=1, num_gpus=1, gpu_ids=[0])
        dash = start_dashboard(port=0, runtime=get_runtime())
        try:
            deadline = time.time() + 30
            stats = {}
            while nb.node_id not in stats and time.time() < deadline:
                with urllib.request.urlopen(dash.url + "/api/agents",
                                            timeout=10) as r:
                    stats = json.loads(r.read())
                time.sleep(0.2)
            assert stats[nb.node_id]["gpus"] == 1
            assert stats["head"]["gpus"] == 0
            with urllib.request.urlopen(dash.url + "/simple",
                                        timeout=10) as r:
                html = r.read().decode()
            assert "<th>gpus</th>" in html
            assert f"<tr><td>{nb.node_id}</td>" in html
            row = html.split(f"<tr><td>{nb.node_id}</td>")[1].split(
                "</tr>")[0]
            assert row.endswith("<td>1</td>")
            with urllib.request.urlopen(dash.url + "/", timeout=10) as r:
                page = r.read().decode()
            assert '"gpus"]' in page and "s.gpus" in page
            assert "tpu chips" not in page.lower()
        finally:
            dash.stop()
    finally:
        c.shutdown()
    assert not rt.is_initialized()


def test_head_row_counts_the_heads_cards():
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.api import get_runtime
    rt.init(num_cpus=1, num_gpus=1, include_dashboard=True,
            dashboard_port=0)
    try:
        url = get_runtime()._dashboard.url
        with urllib.request.urlopen(url + "/api/agents", timeout=10) as r:
            assert json.loads(r.read())["head"]["gpus"] == 1
        with urllib.request.urlopen(url + "/api/cluster", timeout=10) as r:
            assert json.loads(r.read())["resources"]["GPU"] == 1
    finally:
        rt.shutdown()


def test_rest_deploy_over_the_dashboard(table):
    assert table["ray_tpu_torch"]["rest_deploy"] == \
        ("ok", programs.EXPECTED["rest_deploy"])
