"""Cluster launcher: the ``ray up / ray down`` analog.

Reference: python/ray/scripts/scripts.py:1293 (``ray up``) driving
the autoscaler's NodeProvider from a cluster YAML. Here the YAML
declares the head (port/journal), the provider (local | fake | k8s),
and the worker node types; ``up`` starts the head daemon,
builds the provider, and runs the reconciling Autoscaler against
live demand; ``down`` terminates workers then the head.

YAML shape::

    cluster_name: demo
    provider:
      type: fake            # fake | local | k8s
      namespace: default    # k8s only
    head:
      port: 6380
      num_cpus: 0
      num_gpus: 0           # a card-less head; nodes hold the cards
      journal: /tmp/raytpu-journal
    node_types:
      cpu_worker:
        resources: {CPU: 4}
        min_workers: 0
        max_workers: 8
      h100x4:
        resources: {CPU: 8, GPU: 4}
        accelerator_type: nvidia-h100-80gb   # k8s only
        gpus: 4                              # k8s only
        min_workers: 0
        max_workers: 4
    idle_timeout_s: 120
"""

from __future__ import annotations

import json
import os
import threading

from ray_tpu_torch.autoscaler.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
    NodeTypeConfig,
)


def load_cluster_config(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    try:
        import yaml
        return yaml.safe_load(text)
    except ImportError:
        # YAML parser not in the image: accept JSON cluster files
        # with the same schema.
        return json.loads(text)


def _node_type_configs(cfg: dict) -> list[NodeTypeConfig]:
    out = []
    for name, nt in (cfg.get("node_types") or {}).items():
        out.append(NodeTypeConfig(
            name=name,
            resources={k: float(v)
                       for k, v in (nt.get("resources")
                                    or {"CPU": 1}).items()},
            min_workers=int(nt.get("min_workers", 0)),
            max_workers=int(nt.get("max_workers", 10))))
    return out


def _build_provider(cfg: dict, runtime):
    ptype = (cfg.get("provider") or {}).get("type", "local")
    if ptype == "local":
        from ray_tpu_torch.autoscaler.node_provider import (
            LocalNodeProvider,
        )
        return LocalNodeProvider(runtime)
    if ptype == "fake":
        from ray_tpu_torch.autoscaler.fake_provider import (
            FakeMultiNodeProvider,
        )
        return FakeMultiNodeProvider()    # adopts the live head
    if ptype == "gce_tpu":
        raise ValueError(
            "provider type 'gce_tpu' provisions TPU VMs and is not part "
            "of ray_tpu_torch (ROADMAP.md §1, left out on purpose); use "
            "'local', 'fake' or 'k8s'")
    if ptype == "k8s":
        from ray_tpu_torch.autoscaler.k8s import K8sConfig, K8sNodeProvider
        p = cfg["provider"]
        head = cfg.get("head") or {}
        acc = {name: nt["accelerator_type"]
               for name, nt in (cfg.get("node_types") or {}).items()
               if "accelerator_type" in nt}
        gpus = {name: int(nt["gpus"])
                for name, nt in (cfg.get("node_types") or {}).items()
                if "gpus" in nt}
        return K8sNodeProvider(K8sConfig(
            namespace=p.get("namespace", "default"),
            image=p.get("image", "python:3.12-slim"),
            name_prefix=p.get("name_prefix", "raytpu"),
            head_address=p.get("head_address")
            or f"{p.get('head_host', '')}:{head.get('port', 6380)}",
            cluster_token=p.get("cluster_token", ""),
            accelerator_types=acc,
            gpus=gpus,
            pod_spec_overrides=dict(p.get("pod_spec_overrides") or {}),
            labels=dict(p.get("labels") or {})),
            transport=p.get("_transport"))
    raise ValueError(f"unknown provider type {ptype!r}")


class ClusterLauncher:
    """One launched cluster: head runtime + autoscaler."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.runtime = None
        self.autoscaler: Autoscaler | None = None
        self._head_stop: threading.Event | None = None

    def up(self) -> dict:
        head = self.cfg.get("head") or {}
        port = int(head.get("port", 6380))
        token_hex = os.environ.get("RAY_TPU_CLUSTER_TOKEN") \
            or os.urandom(16).hex()
        os.environ["RAY_TPU_CLUSTER_TOKEN"] = token_hex
        from ray_tpu_torch.core.head import run_head
        self.runtime, self._head_stop = run_head(
            port, bytes.fromhex(token_hex),
            num_cpus=int(head.get("num_cpus", 0)),
            journal_dir=head.get("journal") or None,
            num_gpus=head.get("num_gpus"))
        provider = _build_provider(self.cfg, self.runtime)
        self.autoscaler = Autoscaler(
            AutoscalerConfig(
                node_types=_node_type_configs(self.cfg),
                idle_timeout_s=float(
                    self.cfg.get("idle_timeout_s", 120.0)),
                update_interval_s=float(
                    self.cfg.get("update_interval_s", 1.0))),
            provider, runtime=self.runtime)
        self.autoscaler.start()
        return {"address": f"127.0.0.1:{port}",
                "cluster_token": token_hex,
                "name": self.cfg.get("cluster_name", "ray_tpu_torch")}

    def down(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.stop()
            for n in self.autoscaler.provider.non_terminated_nodes():
                try:
                    self.autoscaler.provider.terminate_node(n.node_id)
                except Exception:  # noqa: BLE001
                    pass
        if self._head_stop is not None:
            self._head_stop.set()
        if self.runtime is not None:
            self.runtime.shutdown()


def up(config_path: str) -> ClusterLauncher:
    launcher = ClusterLauncher(load_cluster_config(config_path))
    info = launcher.up()
    print(f"ray_tpu_torch cluster {info['name']!r} up at "
          f"{info['address']} (token {info['cluster_token'][:8]}…)",
          flush=True)
    return launcher


def down(launcher: ClusterLauncher) -> None:
    launcher.down()
