"""Several nodes on one machine (the JAX package's
``ray_tpu.cluster_utils``: a head plus node daemons, for the tests of
spillback, node death and drains).

This package runs one node, so ``Cluster`` raises NotImplementedError
naming ROADMAP item 7 (multi-node), as ``init(address=...)`` does.
"""

from __future__ import annotations

from typing import Any

from ray_tpu_torch.core.runtime import _multi_node


class Cluster:
    """A head and added nodes; multi-node, so it raises here."""

    def __init__(self, initialize_head: bool = True,
                 head_node_args: dict[str, Any] | None = None):
        raise _multi_node("cluster_utils.Cluster (a head and node daemons)")
