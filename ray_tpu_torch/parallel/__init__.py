"""Parallelism layer of the port: device meshes over process groups,
sharding rules, the multi-rank dry run.

Axis conventions, as in ``ray_tpu.parallel``:
    dp    data parallel            (batch split; gradients averaged)
    fsdp  fully-sharded data par.  (batch + parameter shards; FSDP2)
    tp    tensor parallel          (not in the port yet)
    sp    sequence/context par.    (sequence split; ring or Ulysses)
    ep    expert parallel          (MoE experts split; all_to_all)
    pp    pipeline parallel        (not in the port yet)
"""

from ray_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_EP,
    AXIS_FSDP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    CANONICAL_ORDER,
    Mesh,
    MeshSpec,
    initialize,
    local_mesh,
    make_mesh,
    mesh_size,
)
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    LogicalAxisRules,
    constrain,
    logical_to_mesh,
    place_params,
    shard_params,
    spec_for_path,
)

__all__ = [
    "MeshSpec", "Mesh", "make_mesh", "local_mesh", "mesh_size", "initialize",
    "CANONICAL_ORDER", "AXIS_DP", "AXIS_FSDP", "AXIS_TP", "AXIS_SP",
    "AXIS_EP", "AXIS_PP", "LogicalAxisRules", "DEFAULT_RULES",
    "logical_to_mesh", "constrain", "spec_for_path", "shard_params",
    "place_params",
]
