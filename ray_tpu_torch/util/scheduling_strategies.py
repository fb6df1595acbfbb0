"""Scheduling strategy objects (counterpart of
``ray_tpu/util/scheduling_strategies.py``).

Reference: python/ray/util/scheduling_strategies.py — passed as
``scheduling_strategy=`` in ``.options()``.
"""

from __future__ import annotations

from typing import Any


class PlacementGroupSchedulingStrategy:
    def __init__(self, placement_group: Any,
                 placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = (
            placement_group_capture_child_tasks)


class NodeAffinitySchedulingStrategy:
    """Pin to a node; ``soft=True`` falls back to the default policy
    when the node is gone or full."""

    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft
