"""Fake multi-node provider: REAL node-daemon OS processes on this
host (reference: python/ray/autoscaler/_private/fake_multi_node/ —
the docker-based fake provider that lets the autoscaler be tested
end-to-end without a cloud). Each create_node spawns a
``python -m ray_tpu_torch.core.node_daemon`` subprocess against the
live head; terminate kills it — so the whole scale-up → schedule →
idle → scale-down loop runs with real process boundaries.

A node type's ``GPU`` entry becomes the daemon's cards
(``Cluster.add_node(num_gpus=...)``: card ids of this host no other
node holds, the daemon's ``CUDA_VISIBLE_DEVICES``), never a bare
resource row: a node that advertised ``GPU`` without holding a card
would run its GPU tasks with no card visible."""

from __future__ import annotations

import threading
import time

from ray_tpu_torch.autoscaler.node_provider import (
    NodeProvider,
    NodeRecordView,
)


class FakeMultiNodeProvider(NodeProvider):
    def __init__(self, cluster=None):
        from ray_tpu_torch.cluster_utils import Cluster
        if cluster is None:
            cluster = Cluster(initialize_head=False)
            # Adopt the live head runtime (the launcher's): add_node
            # must spawn daemons against it, not bootstrap a second
            # in-process head.
            from ray_tpu_torch.core.api import get_runtime
            cluster._rt = get_runtime()
        self._cluster = cluster
        self._nodes: dict[str, tuple] = {}   # node_id -> (node, type)
        self._lock = threading.Lock()

    def create_node(self, node_type: str,
                    resources: dict[str, float]) -> str:
        res = dict(resources)
        cpus = res.pop("CPU", 1.0)
        gpus = res.pop("GPU", 0.0)
        node = self._cluster.add_node(num_cpus=cpus, num_gpus=gpus,
                                      resources=res)
        with self._lock:
            self._nodes[node.node_id] = (node, node_type)
        return node.node_id

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            entry = self._nodes.pop(node_id, None)
        if entry is None:
            return
        node, _t = entry
        self._cluster.remove_node(node)
        # Give the head a beat to observe the EOF so reconciler state
        # and runtime node table converge.
        time.sleep(0.1)

    def non_terminated_nodes(self) -> list[NodeRecordView]:
        with self._lock:
            return [NodeRecordView(node_id=nid, node_type=t,
                                   resources={})
                    for nid, (_n, t) in self._nodes.items()]
