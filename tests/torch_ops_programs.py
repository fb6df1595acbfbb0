"""Autoscaler, dashboard and job-submission programs, each run once on
``ray_tpu`` and once on ``ray_tpu_torch`` (tests/test_torch_autoscaler.py,
test_torch_dashboard.py, test_torch_jobs.py).

Every program takes the package module (``rt``) and uses the package's
public API, so the same code runs on both. The one difference a program
names is the accelerator: the JAX package's ``TPU`` resource is the
port's ``GPU`` (``_acc``); a node type or a bundle that asks for one is
the same request on both. Nothing here imports either package at module
level: a worker that unpickles one of these functions loads numpy and
the package it runs in, and nothing of the other. Waits are on
conditions with deadlines, never on fixed pauses alone.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")


def _mod(rt, name: str):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _runtime(rt):
    return _mod(rt, "core.api").get_runtime()


def _acc(rt) -> str:
    """The accelerator resource: ``TPU`` on the JAX package, ``GPU`` on
    the port."""
    return "TPU" if rt.__name__ == "ray_tpu" else "GPU"


def _until(cond, timeout: float, what: str, period: float = 0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = cond()
        if out:
            return out
        time.sleep(period)
    raise TimeoutError(f"{what} within {timeout}s")


def _small(rt):
    """The JAX package's ``rt_small`` fixture (tests/test_autoscaler.py):
    one CPU on the head, workers reaped after 0.5 s idle."""
    rt.init(num_cpus=1, _system_config={"idle_worker_ttl_s": 0.5})
    return _runtime(rt)


def _autoscaler(rt, runtime, types: list, **cfg):
    a = _mod(rt, "autoscaler")
    provider = a.LocalNodeProvider(runtime)
    asc = a.Autoscaler(a.AutoscalerConfig(
        node_types=[a.NodeTypeConfig(*t) for t in types], **cfg),
        provider, runtime)
    return asc, provider


def _scale_down(asc, provider, timeout: float = 30.0) -> bool:
    def gone():
        asc.update()
        return not provider.non_terminated_nodes()
    return _until(gone, timeout, "idle nodes terminated", period=0.3)


# ----------------------------------------------------------------------
# Autoscaler (tests/test_autoscaler.py, program by program)
# ----------------------------------------------------------------------

def min_workers_launched(rt):
    runtime = _small(rt)
    asc, provider = _autoscaler(rt, runtime, [("cpu2", {"CPU": 2}, 2, 4)])
    first = asc.update()["launched"]
    nodes = len(provider.non_terminated_nodes())
    return [first, nodes, asc.update()["launched"]]


def scale_up_for_demand_and_down_when_idle(rt):
    runtime = _small(rt)
    asc, provider = _autoscaler(rt, runtime, [("cpu2", {"CPU": 2}, 0, 4)],
                                idle_timeout_s=0.5)

    @rt.remote
    def work(i):
        time.sleep(1.0)
        return i

    refs = [work.remote(i) for i in range(5)]
    # One CPU on the head: four of the five wait, two CPU a node.
    _until(lambda: len(runtime.resource_demand()) >= 4, 30,
           "the demand registered")
    launched = asc.update()["launched"]
    done = sorted(rt.get(refs, timeout=120))
    return [launched, done, _scale_down(asc, provider),
            asc.terminated_total]


def max_workers_cap(rt):
    runtime = _small(rt)
    asc, provider = _autoscaler(rt, runtime, [("cpu1", {"CPU": 1}, 0, 2)])

    @rt.remote
    def work():
        time.sleep(0.3)
        return 1

    refs = [work.remote() for _ in range(10)]
    _until(lambda: len(runtime.resource_demand()) >= 8, 30,
           "the demand registered")
    launched = asc.update()["launched"]
    capped = len(provider.non_terminated_nodes())
    return [launched, capped, sum(rt.get(refs, timeout=120))]


def multi_card_node_launched_whole(rt):
    """A gang of four one-card bundles (``STRICT_PACK``) launches one
    four-card node, never small nodes: the JAX package's
    ``test_tpu_slice_is_atomic`` with the accelerator named by ``_acc``.
    Each bundle's task reports the cards it holds (``get_gpu_ids`` on
    the port; the JAX package has no counterpart, so None there)."""
    runtime = _small(rt)
    acc = _acc(rt)
    asc, provider = _autoscaler(rt, runtime, [
        ("cpu2", {"CPU": 2}, 0, 8),
        ("x4", {"CPU": 4, acc: 4.0}, 0, 2)])
    pg = rt.placement_group([{"CPU": 1, acc: 1.0}] * 4,
                            strategy="STRICT_PACK")
    _until(lambda: len(runtime.resource_demand()) >= 4, 30,
           "the bundles registered as demand")
    launched = asc.update()["launched"]
    types = sorted(n.node_type for n in provider.non_terminated_nodes())
    ready = bool(pg.ready(timeout=60))
    strategy = _mod(rt, "util.scheduling_strategies")
    ids = getattr(rt, "get_gpu_ids", None)
    gate = tempfile.mkdtemp()

    @rt.remote(num_cpus=1, **({"num_gpus": 1} if acc == "GPU"
                              else {"resources": {acc: 1.0}}))
    def holder(i):
        # All four hold their bundles at once: a card freed by a task
        # that ended could go to the next one.
        open(os.path.join(gate, str(i)), "w").close()
        _until(lambda: len(os.listdir(gate)) == 4, 60, "four holders")
        return [None if ids is None else ids(),
                os.environ.get("CUDA_VISIBLE_DEVICES"),
                rt.get_runtime_context().get_node_id()]

    held = rt.get([holder.options(
        scheduling_strategy=strategy.PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=i)).remote(i)
        for i in range(4)], timeout=120)
    rt.remove_placement_group(pg)
    node = provider.non_terminated_nodes()[0].node_id
    cards = sorted(h[0] for h in held) if acc == "GPU" else None
    return [launched, types, ready, all(h[2] == node for h in held),
            cards]


def request_resources_floor(rt):
    runtime = _small(rt)
    sdk = _mod(rt, "autoscaler.sdk")
    asc, provider = _autoscaler(rt, runtime, [("cpu2", {"CPU": 2}, 0, 4)],
                                idle_timeout_s=0.3)
    refused = []
    for kw in ({}, {"bundles": [{}]}):
        try:
            sdk.request_resources(**kw)
            refused.append(False)
        except ValueError:
            refused.append(True)
    sdk.request_resources(bundles=[{"CPU": 2}, {"CPU": 2}])
    launched = asc.update()["launched"]
    # Idle well past idle_timeout_s: the floor holds the nodes up.
    time.sleep(0.8)
    asc.update()
    time.sleep(0.4)
    asc.update()
    held = len(provider.non_terminated_nodes())
    sdk.request_resources(num_cpus=1)       # replaces the request
    after = asc.update()["launched"]
    sdk.request_resources(bundles=[])       # clears it
    return [refused, launched, held, after, _scale_down(asc, provider)]


def request_resources_floor_is_total_capacity(rt):
    runtime = _small(rt)
    sdk = _mod(rt, "autoscaler.sdk")
    asc, provider = _autoscaler(rt, runtime, [("cpu2", {"CPU": 2}, 0, 4)],
                                idle_timeout_s=0.3)
    sdk.request_resources(bundles=[{"CPU": 2}])
    first = asc.update()["launched"]

    @rt.remote(num_cpus=2)
    def hold():
        time.sleep(2.0)
        return 1

    ref = hold.remote()
    _until(lambda: any(n["Available"] != n["Resources"]
                       for n in runtime.nodes() if not n["IsHead"]), 30,
           "the floor node busy")
    again = []
    for _ in range(4):
        again.append(asc.update()["launched"])
        time.sleep(0.15)
    nodes = len(provider.non_terminated_nodes())
    out = rt.get(ref, timeout=60)
    sdk.request_resources(bundles=[])
    return [first, again, nodes, out]


def _fake_cluster(rt):
    """A head of no CPU and no card in this process: only a launched
    node runs work."""
    return _mod(rt, "cluster_utils").Cluster(
        initialize_head=True, head_node_args={"num_cpus": 0})


def fake_provider_scale_cycle(rt):
    """``FakeMultiNodeProvider``: demand on a head with no CPU launches a
    real node daemon, the task runs there, the idle node is terminated
    and its daemon exits (the JAX package's slow launcher test, driven
    by ``update()``)."""
    config = _mod(rt, "core.config")
    with config.env_overrides(idle_worker_ttl_s=1.0):
        c = _fake_cluster(rt)
        try:
            a = _mod(rt, "autoscaler")
            fake = _mod(rt, "autoscaler.fake_provider")
            provider = fake.FakeMultiNodeProvider(c)
            asc = a.Autoscaler(a.AutoscalerConfig(
                node_types=[a.NodeTypeConfig("cpu", {"CPU": 2}, 0, 1)],
                idle_timeout_s=1.0), provider, _runtime(rt))

            @rt.remote(num_cpus=1)
            def work(x):
                return x * 2, rt.get_runtime_context().get_node_id()

            ref = work.remote(21)
            _until(lambda: asc.update()["launched"] or
                   provider.non_terminated_nodes(), 30, "a node launched")
            node = provider.non_terminated_nodes()[0].node_id
            value, where = rt.get(ref, timeout=120)
            proc = provider._nodes[node][0].proc
            gone = _scale_down(asc, provider, timeout=60)
            return [value, where == node, asc.launched_total, gone,
                    proc.wait(15) is not None]
        finally:
            c.shutdown()


AUTOSCALER = {f.__name__: f for f in (
    min_workers_launched, scale_up_for_demand_and_down_when_idle,
    max_workers_cap, multi_card_node_launched_whole,
    request_resources_floor, request_resources_floor_is_total_capacity,
    fake_provider_scale_cycle)}


def daemon_env(pid: int, name: str) -> str | None:
    """``name`` in the environment a process was started with (a node
    daemon's ``CUDA_VISIBLE_DEVICES``: the cards it was given)."""
    with open(f"/proc/{pid}/environ", "rb") as f:
        for item in f.read().split(b"\0"):
            key, _, value = item.partition(b"=")
            if key.decode() == name:
                return value.decode()
    return None


def fake_provider_card_nodes(rt, provider_cls=None):
    """The port only: two pending ``num_gpus=1`` actors launch two nodes
    of type ``{"CPU": 1, "GPU": 1}`` through the fake provider (or
    ``provider_cls``). Returns what the actors saw
    (``CUDA_VISIBLE_DEVICES``, ``get_gpu_ids()``), whether they ran on
    two launched nodes, the card ids the head holds for each node, the
    cards each daemon was started with, and whether the nodes were
    terminated once the actors were gone. Each node must hold a card of
    its own."""
    config = _mod(rt, "core.config")
    with config.env_overrides(idle_worker_ttl_s=1.0):
        c = _fake_cluster(rt)
        try:
            a = _mod(rt, "autoscaler")
            cls = provider_cls or _mod(
                rt, "autoscaler.fake_provider").FakeMultiNodeProvider
            provider = cls(c)
            runtime = _runtime(rt)
            asc = a.Autoscaler(a.AutoscalerConfig(
                node_types=[a.NodeTypeConfig("h100", {"CPU": 1, "GPU": 1},
                                             0, 2)],
                idle_timeout_s=1.0), provider, runtime)
            @rt.remote(num_gpus=1)
            class Probe:
                def seen(self):
                    return [os.environ.get("CUDA_VISIBLE_DEVICES"),
                            rt.get_gpu_ids(),
                            rt.get_runtime_context().get_node_id()]

            # Two actors hold a card each for their lifetime: two nodes.
            probes = [Probe.remote() for _ in range(2)]
            _until(lambda: asc.update()["launched"] == 0 and
                   len(provider.non_terminated_nodes()) == 2, 60,
                   "two nodes launched")
            seen = sorted(rt.get([p.seen.remote() for p in probes],
                                 timeout=120))
            for p in probes:
                rt.kill(p)
            nodes = sorted(n.node_id for n in
                           provider.non_terminated_nodes())
            cards = [sorted(runtime._nodes[n].cards) for n in nodes]
            given = sorted(daemon_env(provider._nodes[n][0].proc.pid,
                                      "CUDA_VISIBLE_DEVICES")
                           or "" for n in nodes)
            return [[x[0] for x in seen], [x[1] for x in seen],
                    sorted(x[2] for x in seen) == nodes, sorted(cards),
                    given, _scale_down(asc, provider, timeout=60)]
        finally:
            c.shutdown()


def gpu_as_resource_provider(rt):
    """The trap the port's fake provider avoids: the JAX package's
    pass-through of every resource but CPU into ``Cluster.add_node(
    resources=...)``, so ``GPU`` becomes a bare row of a node that holds
    no card of its own (a daemon then takes whatever its inherited
    ``CUDA_VISIBLE_DEVICES`` names, the same card for every node). The
    planted fault of the card check."""
    base = _mod(rt, "autoscaler.fake_provider").FakeMultiNodeProvider

    class PassThrough(base):
        def create_node(self, node_type, resources):
            res = dict(resources)
            cpus = res.pop("CPU", 1.0)
            node = self._cluster.add_node(num_cpus=cpus, resources=res)
            with self._lock:
                self._nodes[node.node_id] = (node, node_type)
            return node.node_id
    return PassThrough


# ----------------------------------------------------------------------
# Dashboard (tests/test_dashboard_logs.py, tests/test_ops_shell.py)
# ----------------------------------------------------------------------

GET_ROUTES = (
    "/api/cluster", "/api/nodes", "/api/tasks", "/api/actors",
    "/api/objects", "/api/placement_groups", "/api/summary", "/api/agents",
    "/api/v1/status", "/api/v1/memory", "/api/v1/stack", "/api/timeline",
    "/api/spans", "/api/v1/traces", "/api/v1/timeseries", "/api/v1/alerts",
    "/api/logs", "/api/jobs", "/api/v1/profile?duration_s=0.2&hz=50",
    "/api/serve/applications")


def _get(url: str, timeout: float = 60.0) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(url: str, body: bytes, timeout: float = 60.0) -> tuple[int, bytes]:
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _shape(payload):
    """The keys of a JSON payload, one level into its rows: a dict's
    sorted keys with each value's own keys where it is a dict, a list's
    first row's keys; for the timeline, the keys of the finished task
    ``f``'s slice. A list inside a dict is opened only for its node rows:
    whether the signal store has sampled (alerts, series names) yet is a
    matter of timing."""
    def keys(v, key=None):
        if isinstance(v, dict):
            return sorted(v)
        if key == "nodes" and v and isinstance(v[0], dict):
            return sorted(v[0])
        return type(v).__name__
    if isinstance(payload, list):
        row = next((e for e in payload if isinstance(e, dict)
                    and e.get("name") == "f" and e.get("ph") == "X"),
                   payload[0] if payload else None)
        return ["list", keys(row) if row is not None else None]
    if isinstance(payload, dict):
        return {k: keys(v, k) for k, v in sorted(payload.items())}
    return type(payload).__name__


def _agents_shape(payload: dict) -> dict:
    """``/api/agents`` keyed by node id: the head's row's keys."""
    return {"rows": sorted(payload), "head": sorted(payload["head"])}


def route_shapes(rt):
    """Every ``GET`` route of the dashboard after one finished task and
    one named actor: its status code and the shape of its JSON."""
    rt.init(num_cpus=2)

    @rt.remote
    def f(x):
        return x + 1

    @rt.remote(num_cpus=0)
    class A:
        def ping(self):
            return 1

    assert rt.get(f.remote(1), timeout=60) == 2
    a = A.options(name="probe").remote()
    rt.get(a.ping.remote(), timeout=60)
    dash = _mod(rt, "dashboard").start_dashboard(port=0)
    try:
        out = {}
        for route in GET_ROUTES:
            code, body = _get(dash.url + route, timeout=120)
            payload = json.loads(body)
            if route == "/api/agents":
                out[route] = [code, _agents_shape(payload)]
            elif route.startswith("/api/v1/profile"):
                out[route] = [code, sorted(payload)]
            else:
                out[route] = [code, _shape(payload)]
        code, body = _get(dash.url + "/api/v1/traces/nope")
        out["/api/v1/traces/<unknown>"] = [code, sorted(json.loads(body))]
        code, body = _get(dash.url + "/api/nope")
        out["/api/<unknown>"] = [code, json.loads(body)]
        for page in ("/", "/simple"):
            code, body = _get(dash.url + page)
            out[page] = [code, b"<table" in body or b"table(" in body]
        return out
    finally:
        dash.stop()


_GAUGE = re.compile(r"^# TYPE (ray_tpu_\w+) gauge$", re.M)


def system_gauges(rt):
    """The ``ray_tpu_*`` gauge names on ``/metrics`` once the dashboard
    started (the system-metrics collector samples at once)."""
    rt.init(num_cpus=1)
    dash = _mod(rt, "dashboard").start_dashboard(port=0)
    try:
        code, body = _get(dash.url + "/metrics")
        return [code, sorted(set(_GAUGE.findall(body.decode())))]
    finally:
        dash.stop()


def metrics_config_files(rt):
    """The Prometheus and Grafana files for one target, by path under the
    output directory, with the package's own name (``rt.__name__``, and
    its dashed form in the dashboard's uid) written as ``<pkg>``."""
    cfg = _mod(rt, "dashboard.metrics_config")
    name = rt.__name__
    with tempfile.TemporaryDirectory() as d:
        paths = cfg.generate_metrics_configs(d, ["127.0.0.1:8265"])
        out = {}
        for key, path in sorted(paths.items()):
            with open(path) as f:
                text = f.read().replace(d, "<dir>")
            # The gauge names are the JAX package's on both: kept.
            for _title, metric, _kind in cfg._PANELS:
                text = text.replace(f'"{metric}"', f'"<gauge>{metric[7:]}"')
            rel = os.path.relpath(path, d)
            dashed = name.replace("_", "-")
            out[key] = [rel.replace(name, "<pkg>"),
                        text.replace(name, "<pkg>")
                        .replace(dashed, "<pkg>")]
        return out


def logs_api(rt):
    """``/api/logs``: list the worker logs, tail one, clamp a traversal
    (tests/test_ops_shell.py ``test_dashboard_logs_api``)."""
    rt.init(num_cpus=2)

    @rt.remote
    def noisy():
        print("log-viewer-probe-line", flush=True)
        return 1

    assert rt.get(noisy.remote(), timeout=60) == 1
    dash = _mod(rt, "dashboard").start_dashboard(port=0)
    try:
        files = json.loads(_get(dash.url + "/api/logs")[1])["files"]
        target = next((f for f in files if f.startswith("worker-")),
                      files[0] if files else "")
        out = json.loads(_get(dash.url + f"/api/logs?file={target}")[1])
        bad = json.loads(_get(
            dash.url + "/api/logs?file=..%2F..%2Fetc%2Fpasswd")[1])
        return [bool(files), target.startswith("worker-"),
                out["file"] == target, sorted(out),
                bool(bad.get("error")) or "root:" not in bad.get(
                    "content", "")]
    finally:
        dash.stop()


def node_table(rt):
    """A node daemon's agent samples reach ``/api/agents`` and the
    ``/simple`` node table, beside the head's own sample."""
    c = _mod(rt, "cluster_utils").Cluster(
        initialize_head=True, head_node_args={"num_cpus": 1})
    try:
        nb = c.add_node(num_cpus=1)
        dash = _mod(rt, "dashboard").start_dashboard(port=0,
                                                     runtime=_runtime(rt))
        try:
            def seen():
                stats = json.loads(_get(dash.url + "/api/agents")[1])
                return stats if nb.node_id in stats else None
            stats = _until(seen, 30, "the node's agent sample", period=0.3)
            html = _get(dash.url + "/simple")[1].decode()
            return [stats[nb.node_id]["pid"] == nb.proc.pid,
                    stats[nb.node_id]["mem_total"] > 0, "head" in stats,
                    "Nodes" in html and nb.node_id in html]
        finally:
            dash.stop()
    finally:
        c.shutdown()


def rest_deploy(rt):
    """Serve's REST deploy through the dashboard (tests/test_serve_config.py
    ``test_rest_deploy_api``): ``PUT /api/serve/applications`` with a
    JSON config deploys it, ``GET`` serves its status, an empty config is
    a 400 naming the field."""
    import torch_serve_programs as sp
    rt.init(num_cpus=4)
    serve = _mod(rt, "serve")
    dash = _mod(rt, "dashboard").start_dashboard(port=0)
    try:
        body = json.dumps({"applications": [
            {"name": "echo", "route_prefix": "/echo",
             "import_path": f"{sp.__name__}:{rt.__name__}_echo_app"}]})

        def put(data: bytes):
            req = urllib.request.Request(
                dash.url + "/api/serve/applications", data=data,
                method="PUT", headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, e.read().decode()
        code, out = put(body.encode())
        answer = rt.get(serve.get_deployment_handle("Echo").remote(5),
                        timeout=60)
        status = json.loads(_get(dash.url + "/api/serve/applications")[1])
        bad_code, bad = put(b'{"applications": []}')
        return [code, out, answer, "Echo" in status["deployments"],
                bad_code, "applications" in bad]
    finally:
        dash.stop()
        serve.shutdown()


DASHBOARD = {f.__name__: f for f in (
    route_shapes, system_gauges, metrics_config_files, logs_api,
    node_table, rest_deploy)}


# ----------------------------------------------------------------------
# Job submission (tests/test_ops_shell.py)
# ----------------------------------------------------------------------

def _client(rt):
    return _mod(rt, "job_submission").JobSubmissionClient()


def job_success(rt):
    c = _client(rt)
    sid = c.submit_job(
        entrypoint=f"{sys.executable} -c \"print('job ran ok')\"")
    status = c.wait_until_finished(sid, timeout=120)
    info = c.get_job_info(sid)
    return [status, "job ran ok" in c.get_job_logs(sid), info.return_code,
            sorted(vars(info))]


def job_failure_status(rt):
    c = _client(rt)
    sid = c.submit_job(
        entrypoint=f"{sys.executable} -c 'import sys; sys.exit(3)'")
    return [c.wait_until_finished(sid, timeout=120),
            c.get_job_info(sid).return_code]


def _running(c, sid: str) -> bool:
    return _until(lambda: c.get_job_status(sid) == "RUNNING", 60,
                  "the job running", period=0.2)


def job_stop(rt):
    c = _client(rt)
    sid = c.submit_job(
        entrypoint=f"{sys.executable} -c 'import time; time.sleep(60)'")
    _running(c, sid)
    stopped = c.stop_job(sid)
    status = c.wait_until_finished(sid, timeout=60)
    return [stopped, status, c.stop_job(sid)]


def jobs_rest_api(rt):
    """POST submits, GET lists, inspects and tails, POST .../stop stops,
    a body without an entrypoint is a 400, an unknown id a 404."""
    dash = _mod(rt, "dashboard").start_dashboard(port=0)
    try:
        code, body = _post(dash.url + "/api/jobs", json.dumps(
            {"entrypoint": "python -c \"print('rest-job-output')\"",
             "metadata": {"k": "v"}}).encode())
        sid = json.loads(body)["submission_id"]
        _client(rt).wait_until_finished(sid, timeout=120)
        jobs = json.loads(_get(dash.url + "/api/jobs")[1])
        info = json.loads(_get(dash.url + f"/api/jobs/{sid}")[1])

        def logs():
            text = json.loads(_get(dash.url + f"/api/jobs/{sid}/logs")[1]
                              )["logs"]
            return text if "rest-job-output" in text else None
        text = _until(logs, 30, "the job's print in its logs", period=0.3)
        sleeper = json.loads(_post(dash.url + "/api/jobs", json.dumps(
            {"entrypoint": f"{sys.executable} -c 'import time; "
                           f"time.sleep(60)'"}).encode())[1])["submission_id"]
        _running(_client(rt), sleeper)
        stop_code, stop = _post(dash.url + f"/api/jobs/{sleeper}/stop", b"")
        stopped = _client(rt).wait_until_finished(sleeper, timeout=60)
        bad = _post(dash.url + "/api/jobs", b"{}")
        unknown = _get(dash.url + "/api/jobs/raysubmit_nope")
        unknown_stop = _post(dash.url + "/api/jobs/raysubmit_nope/stop", b"")
        return [code, any(j["submission_id"] == sid for j in jobs),
                info["status"], info["metadata"], sorted(info),
                "rest-job-output" in text, [stop_code, json.loads(stop)],
                stopped, bad[0], "entrypoint" in json.loads(bad[1])["error"],
                unknown[0], "unknown job" in json.loads(unknown[1])["error"],
                unknown_stop[0]]
    finally:
        dash.stop()


def job_details_schema(rt):
    js = _mod(rt, "job_submission")
    c = js.JobSubmissionClient()
    sid = c.submit_job(entrypoint="python -c 'print(7*6)'")
    status = c.wait_until_finished(sid, timeout=120)
    d = c.get_job_details(sid)
    return [status, type(d).__name__, d.type == js.JobType.SUBMISSION,
            d.job_id == d.submission_id == sid, bool(d.end_time),
            sorted(vars(d))]


def job_finds_its_session(rt):
    """The entrypoint joins its session with ``init(address="auto")``
    (its ancestor's, ahead of any other live one) and runs a task there;
    the supervisor's process, and so the entrypoint, holds no accelerator
    (on the port ``CUDA_VISIBLE_DEVICES=""``)."""
    script = (
        "import importlib, json, os, sys\n"
        f"rt = importlib.import_module({rt.__name__!r})\n"
        "rt.init(address='auto')\n"
        "f = rt.remote(num_cpus=1)(lambda x: 2 * x)\n"
        "print('JOB' + json.dumps([rt.get(f.remote(21), timeout=60), "
        "os.environ.get('CUDA_VISIBLE_DEVICES')]), flush=True)\n")
    c = _client(rt)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "entry.py")
        with open(path, "w") as f:
            f.write(script)
        sid = c.submit_job(entrypoint=f"{sys.executable} {path}",
                           runtime_env={"env_vars": {"PYTHONPATH": REPO}})
        status = c.wait_until_finished(sid, timeout=180)
        logs = c.get_job_logs(sid)
    line = [x for x in logs.splitlines() if x.startswith("JOB")]
    if not line:
        return [status, logs[-2000:]]
    value, visible = json.loads(line[-1][3:])
    # The JAX package hides a TPU another way (JAX_PLATFORMS=cpu), so
    # what the entrypoint's CUDA_VISIBLE_DEVICES says is the port's alone.
    return [status, value, visible if rt.__name__ != "ray_tpu" else None]


JOBS = {f.__name__: f for f in (
    job_success, job_failure_status, job_stop, jobs_rest_api,
    job_details_schema, job_finds_its_session)}


# ----------------------------------------------------------------------
# The slice as a whole: a job whose task trains GPT-2 tiny
# ----------------------------------------------------------------------

GPT2_STEPS = 2

_GPT2_ENTRY = """\
import importlib, json, sys
import torch_ops_programs as p
rt = importlib.import_module(sys.argv[1])
rt.init(address="auto")
task = rt.remote(num_cpus=1)(p.gpt2_job_task)
print("JOB" + json.dumps(rt.get(task.remote(sys.argv[1], sys.argv[2]),
                                timeout=600)), flush=True)
"""


def gpt2_job_task(pkg: str, init: str) -> dict:
    """A task of the job: GPT-2 tiny (float32, AdamW at the runtime
    programs' LR and WD) from the JAX package's initialisation saved in
    ``init`` (``params``, flattened by ``/``, and the batch), trained
    ``GPT2_STEPS`` steps on one batch. The JAX package's loop on
    ``ray_tpu``; the port's, through ``load_jax_params``, on the CPU."""
    import torch_runtime_programs as rp
    data = np.load(init)
    batch = {"tokens": data["tokens"], "targets": data["targets"]}
    params: dict = {}
    for key in data.files:
        if key.startswith("params/"):
            node = params
            *path, leaf = key.split("/")[1:]
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    losses = []
    if pkg == "ray_tpu":
        import jax
        import jax.numpy as jnp
        import optax

        from ray_tpu import train
        from ray_tpu.models import GPT2, GPT2Config
        from ray_tpu.models.gpt2 import gpt2_loss_fn
        model = GPT2(GPT2Config.tiny(dtype=jnp.float32))
        opt = optax.adamw(rp.LR, weight_decay=rp.WD, mu_dtype=jnp.bfloat16)
        state = train.init_train_state(
            jax.tree_util.tree_map(jnp.asarray, params), opt)
        step = train.make_train_step(gpt2_loss_fn(model, ce_chunk=64), opt)
        for _ in range(GPT2_STEPS):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    else:
        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.models import GPT2, GPT2Config
        from ray_tpu_torch.models.gpt2 import gpt2_loss_fn
        torch.set_num_threads(1)
        model = GPT2(GPT2Config.tiny(dtype=torch.float32), device="cpu")
        model.load_jax_params(params)
        opt = train.adamw(rp.LR, weight_decay=rp.WD,
                          mu_dtype=torch.bfloat16)
        state = train.init_train_state(model, opt)
        step = train.make_train_step(gpt2_loss_fn(ce_chunk=64), opt)
        tb = {k: torch.from_numpy(v.astype(np.int64))
              for k, v in batch.items()}
        for _ in range(GPT2_STEPS):
            state, m = step(state, tb)
            losses.append(float(m["loss"]))
    return {"losses": losses, "pid": os.getpid()}


def gpt2_job(rt, init: str):
    """Submit the GPT-2 job over the REST API (``POST /api/jobs``), wait
    for it over ``GET /api/jobs/<id>`` and read its line from
    ``GET /api/jobs/<id>/logs``."""
    rt.init(num_cpus=2)
    dash = _mod(rt, "dashboard").start_dashboard(port=0)
    try:
        with tempfile.TemporaryDirectory() as d:
            entry = os.path.join(d, "entry.py")
            with open(entry, "w") as f:
                f.write(_GPT2_ENTRY)
            body = {"entrypoint": f"{sys.executable} {entry} "
                                  f"{rt.__name__} {init}",
                    "runtime_env": {"env_vars": {
                        "PYTHONPATH": os.pathsep.join([REPO, TESTS])}}}
            sid = json.loads(_post(dash.url + "/api/jobs",
                                   json.dumps(body).encode())[1]
                             )["submission_id"]
            info = _until(
                lambda: (lambda i: i if i["status"] in
                         ("SUCCEEDED", "FAILED", "STOPPED") else None)(
                    json.loads(_get(dash.url + f"/api/jobs/{sid}")[1])),
                600, "the job finished", period=0.3)
            logs = json.loads(_get(dash.url + f"/api/jobs/{sid}/logs")[1]
                              )["logs"]
        line = [x for x in logs.splitlines() if x.startswith("JOB")]
        return {"status": info["status"], "return_code": info["return_code"],
                "out": json.loads(line[-1][3:]) if line else None,
                "logs": logs[-3000:]}
    finally:
        dash.stop()


# ----------------------------------------------------------------------

def run(program, rt, *args) -> tuple:
    """("ok", result) or ("raised", class name, message)."""
    try:
        return ("ok", program(rt, *args))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__, str(e))
    finally:
        if rt.is_initialized():
            rt.shutdown()


def run_table(name: str, table: dict, shared: dict | None = None) -> dict:
    """{program: outcome} of every program of ``table`` on package
    ``name``. Each program starts and stops its own runtime, or, given
    ``shared`` (``init``'s keywords), all run in one runtime."""
    rt = importlib.import_module(name)
    if shared is None:
        return {prog: run(fn, rt) for prog, fn in table.items()}
    rt.init(**shared)
    try:
        out = {}
        for prog, fn in table.items():
            try:
                out[prog] = ("ok", fn(rt))
            except Exception as e:  # noqa: BLE001
                out[prog] = ("raised", type(e).__name__, str(e))
        return out
    finally:
        rt.shutdown()


def processes_left(timeout: float = 15.0) -> list[str]:
    """Command lines of this process's children that are still node
    daemons, heads or runtime workers once ``timeout`` has passed."""
    import torch_runtime_programs
    return torch_runtime_programs.workers_left(
        timeout, ("core.worker_entry", "core.node_daemon", "core.head"))


# What each program must give (the same on both packages, and right).
EXPECTED = {
    "min_workers_launched": [2, 2, 0],
    "scale_up_for_demand_and_down_when_idle": [2, [0, 1, 2, 3, 4], True, 2],
    "max_workers_cap": [2, 2, 10],
    "request_resources_floor": [[True, True], 2, 2, 0, True],
    "request_resources_floor_is_total_capacity": [1, [0, 0, 0, 0], 1, 1],
    "fake_provider_scale_cycle": [42, True, 1, True, True],
    "job_failure_status": ["FAILED", 3],
    "job_stop": [True, "STOPPED", False],
    "rest_deploy": [200, {"deployed": ["echo"]}, {"echo": 5}, True, 400,
                    True],
}
