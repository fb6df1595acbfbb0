"""Node providers: how the autoscaler actually adds/removes capacity.

Reference analog: python/ray/autoscaler/node_provider.py (the cloud
abstraction behind aws/gcp/azure/... dirs) and the in-process
FakeMultiNodeProvider used to test the autoscaler without a cloud
(python/ray/autoscaler/_private/fake_multi_node/).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class NodeRecordView:
    node_id: str
    node_type: str
    resources: dict[str, float]


class NodeProvider:
    """Launch/terminate nodes of configured types."""

    def create_node(self, node_type: str,
                    resources: dict[str, float]) -> str:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> list[NodeRecordView]:
        raise NotImplementedError


class LocalNodeProvider(NodeProvider):
    """Adds logical nodes to the local driver runtime — the
    multi-raylet-on-one-host pattern (reference:
    FakeMultiNodeProvider), which lets autoscaling be tested
    end-to-end in-process. A node type's ``GPU`` entry takes that many
    card ids of this host that no other node holds
    (``Runtime.add_node``), so the node's GPU holders see its cards."""

    def __init__(self, runtime=None):
        if runtime is None:
            from ray_tpu_torch.core.api import get_runtime
            runtime = get_runtime()
        self._runtime = runtime
        self._launched: dict[str, str] = {}   # node_id -> node_type

    def create_node(self, node_type: str,
                    resources: dict[str, float]) -> str:
        node_id = self._runtime.add_node(dict(resources))
        self._launched[node_id] = node_type
        return node_id

    def terminate_node(self, node_id: str) -> None:
        self._launched.pop(node_id, None)
        self._runtime.remove_node(node_id)

    def non_terminated_nodes(self) -> list[NodeRecordView]:
        out = []
        for n in self._runtime.nodes():
            nid = n["NodeID"]
            if not n["Alive"] or nid not in self._launched:
                continue
            out.append(NodeRecordView(
                node_id=nid, node_type=self._launched[nid],
                resources=dict(n["Resources"])))
        return out
