"""Lazy task DAGs + compiled execution (reference: python/ray/dag/).

Counterpart of ``ray_tpu/dag``, with the same ``__all__``."""

from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    ClassNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)
from ray_tpu_torch.dag.compiled_dag import CompiledDAG
from ray_tpu_torch.dag.dag_node import (
    _DAGInputData as DAGInputData,  # (reference: ray.dag.DAGInputData)
)

__all__ = [
    "DAGInputData",
    "DAGNode",
    "InputNode",
    "InputAttributeNode",
    "FunctionNode",
    "ClassNode",
    "ClassMethodNode",
    "MultiOutputNode",
    "CompiledDAG",
]
