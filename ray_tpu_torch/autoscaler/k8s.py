"""Kubernetes node provider.

Reference analog: the KubeRay glue under
python/ray/autoscaler/_private/kuberay/ (node_provider.py there talks
to the K8s API server to scale RayCluster pods). GPU deltas:

- a node is a POD holding a host's cards (the ``nvidia.com/gpu``
  device-plugin resource + GKE's GPU accelerator nodeSelector,
  ``cloud.google.com/gke-accelerator``), or a plain CPU pod for
  non-accelerated node types; its daemon runs with ``--num-gpus N``,
  so the cards the device plugin hands the pod are the node's cards;
- there is no gang resource: a multi-card node type is one pod, so a
  node is launched whole;
- ALL API interaction goes through an injectable ``transport``
  (default: urllib over the in-cluster service account), so the
  provider is fully testable against a fake API server with zero
  egress.
"""

from __future__ import annotations

import json
import os
import threading
import uuid
from dataclasses import dataclass, field

from ray_tpu_torch.autoscaler.node_provider import (
    NodeProvider,
    NodeRecordView,
)

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeApiTransport:
    """Minimal API-server client over urllib (the ``kubernetes``
    package is not vendored). In-cluster defaults: service-account
    bearer token + CA bundle + KUBERNETES_SERVICE_HOST."""

    def __init__(self, base_url: str | None = None,
                 token: str | None = None,
                 ca_file: str | None = None):
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        self.base_url = base_url or (f"https://{host}:{port}"
                                     if host else "")
        if token is None:
            try:
                with open(os.path.join(_SA_DIR, "token")) as f:
                    token = f.read().strip()
            except OSError:
                token = ""
        self.token = token
        self.ca_file = ca_file or os.path.join(_SA_DIR, "ca.crt")

    def request(self, method: str, path: str,
                body: dict | None = None) -> tuple[int, dict]:
        import ssl
        import urllib.request
        if not self.base_url:
            raise RuntimeError(
                "no Kubernetes API endpoint: set "
                "KUBERNETES_SERVICE_HOST or pass base_url")
        ctx = ssl.create_default_context(
            cafile=self.ca_file if os.path.exists(self.ca_file)
            else None)
        req = urllib.request.Request(
            self.base_url + path, method=method,
            data=(json.dumps(body).encode() if body is not None
                  else None),
            headers={"Authorization": f"Bearer {self.token}",
                     "Content-Type": "application/json",
                     "Accept": "application/json"})
        try:
            with urllib.request.urlopen(req, context=ctx,
                                        timeout=60) as resp:
                return resp.status, json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:  # noqa: PERF203
            body = e.read() or b"{}"
            try:
                return e.code, json.loads(body)
            except ValueError:
                # Proxies/ingresses return text bodies; keep the
                # status + raw text instead of a decode traceback.
                return e.code, {"raw": body.decode("utf-8",
                                                   "replace")[:500]}


@dataclass
class K8sConfig:
    namespace: str = "default"
    image: str = "python:3.12-slim"
    name_prefix: str = "raytpu"
    head_address: str = ""
    cluster_token_env: str = "RAY_TPU_CLUSTER_TOKEN"
    cluster_token: str = ""
    # node_type -> GKE accelerator (e.g. "nvidia-h100-80gb"); types
    # absent here launch as plain CPU pods.
    accelerator_types: dict[str, str] = field(default_factory=dict)
    # node_type -> nvidia.com/gpu card count per pod (device plugin).
    gpus: dict[str, int] = field(default_factory=dict)
    # Extra pod-spec fragments merged into every pod (tolerations,
    # nodeSelector, serviceAccountName, ...).
    pod_spec_overrides: dict = field(default_factory=dict)
    labels: dict[str, str] = field(default_factory=dict)


class K8sNodeProvider(NodeProvider):
    """Creates/terminates pods running the ray_tpu_torch node daemon."""

    LABEL = "ray-tpu.io/cluster"

    def __init__(self, config: K8sConfig, transport=None):
        self.config = config
        self.transport = transport or KubeApiTransport()
        self._nodes: dict[str, NodeRecordView] = {}
        self._lock = threading.Lock()

    # -- pod templating ------------------------------------------------

    def _pod_manifest(self, name: str, node_type: str,
                      resources: dict[str, float]) -> dict:
        cfg = self.config
        acc = cfg.accelerator_types.get(node_type)
        gpus = cfg.gpus.get(node_type, 0)
        # CPU and GPU ride their own flags; the rest is the daemon's
        # custom resource row.
        daemon_res = {k: v for k, v in resources.items()
                      if k not in ("CPU", "GPU")}
        cmd = ("python -m ray_tpu_torch.core.node_daemon "
               f"--address {cfg.head_address} "
               f"--num-cpus {resources.get('CPU', 1.0):g} "
               f"--num-gpus {gpus} "
               f"--resources '{json.dumps(daemon_res)}'")
        limits: dict = {}
        if gpus:
            limits["nvidia.com/gpu"] = gpus
        spec: dict = {
            "restartPolicy": "Never",
            "containers": [{
                "name": "ray-tpu-node",
                "image": cfg.image,
                "command": ["/bin/sh", "-c", cmd],
                "env": [{"name": cfg.cluster_token_env,
                         "value": cfg.cluster_token}],
                **({"resources": {"limits": limits}} if limits
                   else {}),
            }],
        }
        if acc:
            # GKE GPU scheduling contract: the accelerator node
            # selector places the pod on a host with those cards.
            spec.setdefault("nodeSelector", {})[
                "cloud.google.com/gke-accelerator"] = acc
        for k, v in cfg.pod_spec_overrides.items():
            if isinstance(v, dict) and isinstance(spec.get(k), dict):
                spec[k].update(v)
            else:
                spec[k] = v
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": name,
                "namespace": cfg.namespace,
                "labels": {self.LABEL: cfg.name_prefix,
                           "ray-tpu.io/node-type": node_type,
                           **cfg.labels},
            },
            "spec": spec,
        }

    # -- provider surface ---------------------------------------------

    def create_node(self, node_type: str,
                    resources: dict[str, float]) -> str:
        name = (f"{self.config.name_prefix}-{node_type}-"
                f"{uuid.uuid4().hex[:8]}")
        status, body = self.transport.request(
            "POST", f"/api/v1/namespaces/{self.config.namespace}/pods",
            self._pod_manifest(name, node_type, resources))
        if status not in (200, 201, 202):
            raise RuntimeError(
                f"pod create failed ({status}): "
                f"{json.dumps(body)[:500]}")
        rec = NodeRecordView(node_id=name, node_type=node_type,
                             resources=dict(resources))
        with self._lock:
            self._nodes[name] = rec
        return name

    def terminate_node(self, node_id: str) -> None:
        status, body = self.transport.request(
            "DELETE",
            f"/api/v1/namespaces/{self.config.namespace}/pods/"
            f"{node_id}")
        if status not in (200, 202, 404):
            raise RuntimeError(
                f"pod delete failed ({status}): "
                f"{json.dumps(body)[:500]}")
        with self._lock:
            self._nodes.pop(node_id, None)

    def non_terminated_nodes(self) -> list[NodeRecordView]:
        with self._lock:
            return list(self._nodes.values())

    def refresh(self) -> None:
        """Re-adopt live pods from the API server (crash recovery for
        the autoscaler process — reference: kuberay node provider
        listing RayCluster pods by label)."""
        status, body = self.transport.request(
            "GET",
            f"/api/v1/namespaces/{self.config.namespace}/pods"
            f"?labelSelector={self.LABEL}%3D{self.config.name_prefix}")
        if status != 200:
            raise RuntimeError(f"pod list failed ({status})")
        with self._lock:
            seen = set()
            for item in body.get("items", []):
                meta = item.get("metadata", {})
                name = meta.get("name", "")
                phase = item.get("status", {}).get("phase", "")
                if phase in ("Succeeded", "Failed"):
                    continue
                seen.add(name)
                if name not in self._nodes:
                    ntype = meta.get("labels", {}).get(
                        "ray-tpu.io/node-type", "")
                    self._nodes[name] = NodeRecordView(
                        node_id=name, node_type=ntype, resources={})
            for gone in set(self._nodes) - seen:
                self._nodes.pop(gone, None)
