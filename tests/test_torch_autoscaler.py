"""The port's autoscaler (``ray_tpu_torch.autoscaler``: the reconciler,
``LocalNodeProvider``, ``FakeMultiNodeProvider``, the SDK, the k8s
provider and the launcher) against the JAX package's.

The ``AUTOSCALER`` table of tests/torch_ops_programs.py runs once on
``ray_tpu`` and once on ``ray_tpu_torch``, each program with a runtime
of its own: min workers, scale-up for demand and scale-down when idle,
the max-workers cap, a multi-card node type launched whole for a
``STRICT_PACK`` gang of one-card bundles (the JAX package's
``test_tpu_slice_is_atomic`` with ``TPU`` for ``GPU``), the
``request_resources`` floor and its measure on total capacity, and the
fake provider's scale cycle with a real node daemon. Outcomes are
compared exactly.

On the port alone: each bundle of the multi-card node holds a card of
its own; the fake provider turns a node type's ``GPU`` into the
daemon's cards, so two one-card nodes hold cards 0 and 1, and the JAX
package's pass-through of ``GPU`` as a bare resource (planted) fails
that check. The k8s provider's pod, held against the JAX package's fake
API server (tests/test_autoscaler_k8s.py), asks for ``nvidia.com/gpu``
where the JAX pod asks for ``google.com/tpu``; the launcher builds the
``local``, ``fake`` and ``k8s`` providers and refuses ``gce_tpu``.
"""

from __future__ import annotations

import json
import os
import socket
import time

import pytest
import torch

import torch_ops_programs as programs
from test_autoscaler_k8s import FakeApiServer

PACKAGES = ("ray_tpu", "ray_tpu_torch")
PROGRAMS = list(programs.AUTOSCALER)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for the module, as every test_torch_* file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _no_process_left():
    """Torn down after the module's runtimes and clusters: none leaves a
    node daemon or a worker behind."""
    yield
    assert programs.processes_left() == []


@pytest.fixture(scope="module")
def table() -> dict:
    """{package: {program: outcome}}, the JAX package's run first."""
    return {name: programs.run_table(name, programs.AUTOSCALER)
            for name in PACKAGES}


def _same(program: str, outcome: tuple) -> tuple:
    """The outcome with what only the port reports (the cards each
    bundle held) left out."""
    if program == "multi_card_node_launched_whole" and outcome[0] == "ok":
        return ("ok", outcome[1][:-1])
    return outcome


@pytest.mark.parametrize("program", PROGRAMS)
def test_program_gives_the_same_result_on_both_packages(table, program):
    jax_out, port_out = (table[name][program] for name in PACKAGES)
    assert jax_out[0] == "ok", jax_out
    assert _same(program, port_out) == _same(program, jax_out)


@pytest.mark.parametrize("program", sorted(
    set(PROGRAMS) & set(programs.EXPECTED)))
def test_program_outcome_is_the_expected_one(table, program):
    assert table["ray_tpu_torch"][program] == \
        ("ok", programs.EXPECTED[program])


def test_multi_card_node_is_launched_whole(table):
    launched, types, ready, one_node, _ = \
        table["ray_tpu_torch"]["multi_card_node_launched_whole"][1]
    assert [launched, types, ready, one_node] == [1, ["x4"], True, True]


def test_each_bundle_of_the_multi_card_node_holds_its_own_card(table):
    cards = table["ray_tpu_torch"]["multi_card_node_launched_whole"][1][-1]
    assert cards == [[0], [1], [2], [3]]


# ----------------------------------------------------------------------
# The fake provider's cards
# ----------------------------------------------------------------------

CARD_NODES = [["0", "1"], [[0], [1]], True, [["0"], ["1"]], ["0", "1"],
              True]


def test_fake_provider_gives_each_gpu_node_a_card_of_its_own():
    import ray_tpu_torch as rt
    out = programs.run(programs.fake_provider_card_nodes, rt)
    assert out == ("ok", CARD_NODES)
    assert programs.processes_left() == []


def test_gpu_passed_as_a_bare_resource_fails_the_card_check():
    """The planted fault: the JAX package's pass-through of every
    resource but CPU. Its second node holds no card of its own (its
    daemon takes card 0, which the first node holds), so the check
    above does not hold."""
    import ray_tpu_torch as rt
    out = programs.run(programs.fake_provider_card_nodes, rt,
                       programs.gpu_as_resource_provider(rt))
    assert out != ("ok", CARD_NODES)
    assert programs.processes_left() == []


def test_local_provider_gives_a_gpu_node_card_ids():
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import LocalNodeProvider
    from ray_tpu_torch.core.api import get_runtime
    rt.init(num_cpus=1, num_gpus=0)
    try:
        runtime = get_runtime()
        p = LocalNodeProvider(runtime)
        a = p.create_node("h100x4", {"CPU": 4, "GPU": 4})
        b = p.create_node("h100", {"CPU": 1, "GPU": 1})
        assert sorted(runtime._nodes[a].cards) == ["0", "1", "2", "3"]
        assert sorted(runtime._nodes[b].cards) == ["4"]
        assert [n.node_type for n in p.non_terminated_nodes()] == \
            ["h100x4", "h100"]
        p.terminate_node(a)
        assert [n.node_id for n in p.non_terminated_nodes()] == [b]
    finally:
        rt.shutdown()


# ----------------------------------------------------------------------
# The k8s provider, against the JAX package's fake API server
# ----------------------------------------------------------------------

def _providers(**cfg):
    """The JAX package's provider for a TPU node type and the port's for
    the same node type with cards, each with its own fake API server."""
    from ray_tpu.autoscaler.k8s import K8sConfig as JaxConfig
    from ray_tpu.autoscaler.k8s import K8sNodeProvider as JaxProvider
    from ray_tpu_torch.autoscaler.k8s import K8sConfig, K8sNodeProvider
    base = dict(namespace="ns", name_prefix="raytpu",
                head_address="10.0.0.2:6380", cluster_token="deadbeef")
    base.update(cfg)
    japi, papi = FakeApiServer(), FakeApiServer()
    jax_p = JaxProvider(JaxConfig(
        accelerator_types={"x8": "v5e-8"}, tpu_chips={"x8": 8}, **base),
        transport=japi)
    port_p = K8sNodeProvider(K8sConfig(
        accelerator_types={"x8": "nvidia-h100-80gb"}, gpus={"x8": 8},
        **base), transport=papi)
    return (jax_p, japi), (port_p, papi)


def _as_gpu_pod(pod: dict) -> dict:
    """The JAX package's pod with its TPU names mapped to the port's
    card names, and its command left out (compared on its own)."""
    pod = json.loads(json.dumps(pod))
    c = pod["spec"]["containers"][0]
    limits = c.get("resources", {}).get("limits", {})
    if "google.com/tpu" in limits:
        limits["nvidia.com/gpu"] = limits.pop("google.com/tpu")
    sel = pod["spec"].get("nodeSelector", {})
    if "cloud.google.com/gke-tpu-accelerator" in sel:
        sel.pop("cloud.google.com/gke-tpu-accelerator")
        sel["cloud.google.com/gke-accelerator"] = "nvidia-h100-80gb"
    c.pop("command")
    pod["metadata"]["name"] = "<name>"
    return pod


def _pods(api) -> list[dict]:
    return list(api.pods.values())


def test_k8s_pod_matches_the_jax_pod_with_cards_for_chips():
    (jp, japi), (pp, papi) = _providers()
    jp.create_node("x8", {"CPU": 8, "TPU": 8})
    pp.create_node("x8", {"CPU": 8, "GPU": 8})
    jpod, ppod = _pods(japi)[0], _pods(papi)[0]
    cmd = ppod["spec"]["containers"][0]["command"]
    assert cmd[:2] == jpod["spec"]["containers"][0]["command"][:2]
    ppod = json.loads(json.dumps(ppod))
    ppod["spec"]["containers"][0].pop("command")
    ppod["metadata"]["name"] = "<name>"
    assert ppod == _as_gpu_pod(jpod)
    assert ppod["spec"]["containers"][0]["resources"]["limits"] == \
        {"nvidia.com/gpu": 8}
    assert ppod["spec"]["nodeSelector"] == \
        {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}


def test_k8s_daemon_command_holds_the_pods_cards():
    (_, _), (pp, papi) = _providers()
    pp.create_node("x8", {"CPU": 8, "GPU": 8, "disk": 1})
    cmd = _pods(papi)[0]["spec"]["containers"][0]["command"][-1]
    assert cmd.startswith("python -m ray_tpu_torch.core.node_daemon ")
    assert "--address 10.0.0.2:6380" in cmd
    assert "--num-cpus 8 " in cmd and "--num-gpus 8 " in cmd
    assert json.loads(cmd.split("--resources ")[1].strip("'")) == {"disk": 1}
    assert "TPU" not in cmd


@pytest.mark.parametrize("package", PACKAGES)
def test_k8s_cpu_node_type_has_no_accelerator_bits(package):
    (jp, japi), (pp, papi) = _providers()
    p, api = (jp, japi) if package == "ray_tpu" else (pp, papi)
    nid = p.create_node("cpu", {"CPU": 4})
    pod = api.pods[nid]
    assert "nodeSelector" not in pod["spec"]
    assert "resources" not in pod["spec"]["containers"][0]


@pytest.mark.parametrize("package", PACKAGES)
def test_k8s_terminate_refresh_and_overrides(package):
    (jp, japi), (pp, papi) = _providers(pod_spec_overrides={
        "serviceAccountName": "ray-sa", "nodeSelector": {"pool": "p"}})
    p, api = (jp, japi) if package == "ray_tpu" else (pp, papi)
    nid = p.create_node("x8", {"CPU": 8})
    spec = api.pods[nid]["spec"]
    out = [spec["serviceAccountName"], spec["nodeSelector"]["pool"],
           len(spec["nodeSelector"])]
    p.terminate_node(nid)
    out += [api.pods, p.non_terminated_nodes()]
    p.terminate_node(nid)                   # a 404 is not an error
    api.pods["raytpu-x8-zzz"] = {"metadata": {
        "name": "raytpu-x8-zzz", "namespace": "ns",
        "labels": {"ray-tpu.io/cluster": "raytpu",
                   "ray-tpu.io/node-type": "x8"}}, "spec": {}}
    p.refresh()
    out.append([(n.node_id, n.node_type) for n in p.non_terminated_nodes()])
    api.pods.clear()
    p.refresh()
    out.append(p.non_terminated_nodes())
    assert out == ["ray-sa", "p", 2, {}, [], [("raytpu-x8-zzz", "x8")], []]


@pytest.mark.parametrize("package", PACKAGES)
def test_k8s_create_failure_surfaces(package):
    mod = __import__(f"{package}.autoscaler.k8s", fromlist=["k8s"])

    class Dup:
        def request(self, method, path, body=None):
            return 409, {"reason": "AlreadyExists"}

    p = mod.K8sNodeProvider(mod.K8sConfig(namespace="ns"), transport=Dup())
    with pytest.raises(RuntimeError, match="pod create failed"):
        p.create_node("cpu", {})


# ----------------------------------------------------------------------
# The launcher
# ----------------------------------------------------------------------

def test_launcher_builds_the_k8s_provider_with_gpus():
    from ray_tpu_torch.autoscaler.launcher import _build_provider
    api = FakeApiServer()
    p = _build_provider({
        "provider": {"type": "k8s", "namespace": "prod",
                     "head_address": "1.2.3.4:6380", "_transport": api},
        "node_types": {"h100x8": {"resources": {"CPU": 8, "GPU": 8},
                                  "accelerator_type": "nvidia-h100-80gb",
                                  "gpus": 8}}}, runtime=None)
    nid = p.create_node("h100x8", {"CPU": 8, "GPU": 8})
    pod = api.pods[nid]
    assert pod["metadata"]["namespace"] == "prod"
    assert pod["spec"]["containers"][0]["resources"]["limits"] == \
        {"nvidia.com/gpu": 8}
    p.terminate_node(nid)
    assert api.pods == {}


def test_launcher_refuses_gce_tpu_naming_the_roadmap():
    from ray_tpu_torch.autoscaler.launcher import _build_provider
    with pytest.raises(ValueError, match="ROADMAP.md"):
        _build_provider({"provider": {"type": "gce_tpu", "project": "p",
                                      "zone": "z"}}, runtime=None)
    with pytest.raises(ValueError, match="unknown provider"):
        _build_provider({"provider": {"type": "nope"}}, runtime=None)


def test_launcher_builds_the_local_and_fake_providers():
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler.fake_provider import FakeMultiNodeProvider
    from ray_tpu_torch.autoscaler.launcher import _build_provider
    from ray_tpu_torch.autoscaler.node_provider import LocalNodeProvider
    from ray_tpu_torch.core.api import get_runtime
    rt.init(num_cpus=1)
    try:
        assert isinstance(_build_provider({}, get_runtime()),
                          LocalNodeProvider)
        fake = _build_provider({"provider": {"type": "fake"}}, get_runtime())
        assert isinstance(fake, FakeMultiNodeProvider)
        assert fake._cluster._rt is get_runtime()
    finally:
        rt.shutdown()


def test_launcher_up_scales_a_real_daemon_on_demand(tmp_path):
    """``up`` with the fake provider: a head of no CPU, demand launches a
    node daemon, the task runs on it, the idle node is terminated;
    ``down`` stops the head (the JAX package's slow launcher test, on
    the port)."""
    import ray_tpu_torch as rt
    import ray_tpu_torch.core.api as api
    from ray_tpu_torch.autoscaler import launcher as L
    from ray_tpu_torch.core.config import env_overrides
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps({
        "cluster_name": "t", "provider": {"type": "fake"},
        "head": {"port": port, "num_cpus": 0, "num_gpus": 0},
        "node_types": {"cpu": {"resources": {"CPU": 2}, "min_workers": 0,
                               "max_workers": 1}},
        "idle_timeout_s": 1.0, "update_interval_s": 0.2}))
    token = os.environ.get("RAY_TPU_CLUSTER_TOKEN")
    with env_overrides(idle_worker_ttl_s=1.0):
        launcher = L.up(str(path))
        try:
            @rt.remote(num_cpus=1)
            def work(x):
                return x * 2

            assert rt.get(work.remote(21), timeout=120) == 42
            assert launcher.autoscaler.launched_total == 1
            deadline = time.time() + 60
            # (The provider forgets a node before its daemon has exited.)
            while ((launcher.autoscaler.provider.non_terminated_nodes()
                    or not launcher.autoscaler.terminated_total)
                   and time.time() < deadline):
                time.sleep(0.3)
            assert not launcher.autoscaler.provider.non_terminated_nodes()
            assert launcher.autoscaler.terminated_total == 1
        finally:
            launcher.down()
            api._runtime = None     # the launcher tore its head down
            if token is None:
                os.environ.pop("RAY_TPU_CLUSTER_TOKEN", None)
            else:
                os.environ["RAY_TPU_CLUSTER_TOKEN"] = token
    assert programs.processes_left() == []
