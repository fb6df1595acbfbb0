"""ray_tpu_torch.autoscaler — demand-driven cluster scaling.

Reference analog (SURVEY.md §2.2): autoscaler v2's reconciler design
(python/ray/autoscaler/v2/: read demand from the control plane,
bin-pack onto node types, drive a NodeProvider) rather than v1's
imperative StandardAutoscaler. GPU angle: a node type is a whole host
of cards (an atomic resource bundle, e.g. ``{"CPU": 4, "GPU": 4}``) —
the provider launches/terminates whole nodes, never fractions of one,
and a ``GPU`` entry of a node type is that many card ids of the node.
"""

from ray_tpu_torch.autoscaler.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
    NodeTypeConfig,
)
from ray_tpu_torch.autoscaler.node_provider import (
    LocalNodeProvider,
    NodeProvider,
)
from ray_tpu_torch.autoscaler import sdk  # noqa: F401  (request_resources)

__all__ = [
    "Autoscaler", "AutoscalerConfig", "NodeTypeConfig",
    "NodeProvider", "LocalNodeProvider", "sdk",
]
